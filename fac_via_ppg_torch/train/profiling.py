"""Profiling hooks (the port of fac_via_ppg_tpu/train/profiling.py).

`trace(profile_dir)` records the enclosed region with torch.profiler (CPU
and, on a card, CUDA activity) and writes a Chrome trace into
`profile_dir`.

`span(name, device, **attrs)` marks one layer's work inside the program.
With the profiler off it is a shared no-op context.  Under the profiler
it is a `record_function` (on the profiler's clock beside the kernels,
and on the GPU timeline of the Chrome trace), timed on the device by two
CUDA events on the current stream (on the host's clock on the CPU), and
kept in a process-wide list with its parent span (per thread) and
`attrs`, the shapes that count its work.  `spans()` reads the list back;
`reset_spans()` clears it, as `trace()` does on entry."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_records: list = []          # [name, parent index, attrs, start, end]
_local = threading.local()   # .stack: this thread's open spans' indices


class Span(NamedTuple):
    name: str
    parent: Optional[int]    # the parent's index in spans(), or None
    seconds: float
    self_seconds: float      # seconds less the children's
    attrs: dict


def _clock(device: Optional[torch.device]):
    if device is not None and device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter_ns()


class _Span:
    __slots__ = ("name", "device", "attrs", "_fn", "_rec")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._rec = [self.name, stack[-1] if stack else None, self.attrs,
                     _clock(self.device), None]
        with _lock:
            stack.append(len(_records))
            _records.append(self._rec)
        return self

    def __exit__(self, *exc):
        self._rec[4] = _clock(self.device)
        _local.stack.pop()
        self._fn.__exit__(*exc)
        return False


def span(name: str, device=None, **attrs):
    """The context of one layer's work on `device` (None: the host), with
    the shapes that count it as `attrs`; a no-op unless the profiler is
    on."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device, attrs)


def _seconds(start, end) -> float:
    if end is None:                       # still open
        return float("nan")
    if isinstance(start, int):
        return (end - start) / 1e9
    return start.elapsed_time(end) / 1e3


def spans() -> List[Span]:
    """Every span recorded since the last reset, in the order they were
    entered; waits once for the devices they were timed on."""
    with _lock:
        recs = [list(r) for r in _records]
    for d in {r[3].device for r in recs if not isinstance(r[3], int)}:
        torch.cuda.synchronize(d)
    secs = [_seconds(r[3], r[4]) for r in recs]
    child = [0.0] * len(recs)
    for r, s in zip(recs, secs):
        if r[1] is not None:
            child[r[1]] += s
    return [Span(r[0], r[1], s, s - c, dict(r[2]))
            for r, s, c in zip(recs, secs, child)]


def reset_spans() -> None:
    """Forget every recorded span."""
    with _lock:
        _records.clear()


@contextlib.contextmanager
def trace(profile_dir: str):
    """Trace the enclosed region into `profile_dir` ('' disables); the
    spans recorded inside are the region's own."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
