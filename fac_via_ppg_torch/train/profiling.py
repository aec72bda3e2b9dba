"""Profiling hooks (the port of fac_via_ppg_tpu/train/profiling.py).

`trace(profile_dir)` records the enclosed region with torch.profiler (CPU
and, on a card, CUDA activity) and writes a Chrome trace into
`profile_dir`; `annotate(name)` names a region in it; `StepTimer` is the
reference's per-iteration wall clock (train_ppg2mel.py:233,260)."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(profile_dir: str):
    """Trace the enclosed region into `profile_dir` ('' disables)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def annotate(name: str):
    """A named region of the trace timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per-iteration timing (the reference's 'duration'
    scalar), with an EMA for console output."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self._start
        self.ema = (self.duration if self.ema is None
                    else (1 - self.alpha) * self.ema
                    + self.alpha * self.duration)
        return False
