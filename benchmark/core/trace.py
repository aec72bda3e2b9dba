"""The traced run's reading of the card: torch.profiler over whole batches,
requests or steps, reduced in memory to the intervals the metric readers
need, then dropped.

`Traced` profiles a block on one device and leaves `.data`, a `TraceData`:
the window (the block, as its own annotation spans it on the profiler's
clock), every device operation (kernels, copies and sets) and the host
operations of every thread (autograd's backward runs on a thread of its
own).  Nothing is written to disk."""

from __future__ import annotations

import bisect
import collections
import heapq
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from benchmark.core.window import sync

WINDOW = "bench.window"

Event = Tuple[str, int, int]  # (name, start ns, end ns)


class TraceData(NamedTuple):
    window: Tuple[int, int]   # the block's (start ns, end ns)
    device: List[Event]       # every device operation, by start
    host: List[Event]         # the host's operations, by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _kineto(prof) -> Tuple[list, list, tuple]:
    events = prof.profiler.kineto_results.events()
    cpu, dev, window = [], [], None
    for e in events:
        name = e.name()
        span = (name, int(e.start_ns()), int(e.end_ns()))
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW and window is None:
                window = span[1:]
            cpu.append(span)
        elif not e.is_user_annotation() and not name.startswith("bench."):
            dev.append(span)
    return cpu, dev, window


class Traced:
    """`with Traced(device) as t: ...` profiles the block; `t.data` after
    it.  The block starts and ends on a synchronized device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.data: Optional[TraceData] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is not None:
            return False
        cpu, dev, window = _kineto(self._prof)
        self._prof = None
        if window is None:
            raise RuntimeError("the profiler lost the window's annotation")
        w0, w1 = window
        by_start = lambda s: (s[1], -s[2])  # noqa: E731
        host = sorted((s for s in cpu if s[0] != WINDOW), key=by_start)
        dev = sorted((s for s in dev if s[2] > w0 and s[1] < w1),
                     key=by_start)
        self.data = TraceData(window, dev, host)
        return False


def busy_intervals(data: TraceData) -> List[Tuple[int, int]]:
    """The union of the device's operations inside the window, merged."""
    w0, w1 = data.window
    out: List[List[int]] = []
    for _, s, e in data.device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_seconds(data: TraceData) -> float:
    return sum(e - s for s, e in busy_intervals(data)) / 1e9


def device_ops(data: TraceData, top: int = 10) -> list:
    """The device operations that took most time: [[name, seconds]]."""
    acc: Dict[str, int] = collections.defaultdict(int)
    for name, s, e in data.device:
        acc[name] += e - s
    ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(data: TraceData, top: int = 10) -> list:
    """The device's idle time inside the window, summed by what the host
    was doing at each gap's middle (the latest-started operation still
    running then, on any thread, or "host: no operation"): [[name,
    seconds]], longest first."""
    w0, w1 = data.window
    gaps, cursor = [], w0
    for s, e in busy_intervals(data):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = data.host
    starts = [s for _, s, _ in host]
    acc: Dict[str, int] = collections.defaultdict(int)
    heap: list = []   # (-start, end, name): the latest-started first
    j = 0
    for gs, ge in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (gs + ge) // 2
        k = bisect.bisect_right(starts, mid, lo=j)
        for name, s, e in host[j:k]:
            heapq.heappush(heap, (-s, e, name))
        j = k
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        acc[heap[0][2] if heap else "host: no operation"] += ge - gs
    ranked = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]
