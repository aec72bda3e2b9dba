"""A timed window on the card: CUDA events and a synchronize (a frozen
copy of fac_via_ppg_torch/eval/rtf.py::Window), the host's clock on the
CPU."""

from __future__ import annotations

import time

import torch


class Window:
    """Seconds between `__enter__` and `__exit__` on `device`: CUDA events
    recorded on the current stream and a synchronize on the card, the
    host's clock on the CPU.  `.seconds` after the block."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = None

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record()
            torch.cuda.synchronize(self.device)
            self.seconds = self._start.elapsed_time(self._end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        return False


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
