"""Helpers the metric readers share: device idle share, a hand kernel's
share of its roofline, a whole program's share of a peak.  A reader that
finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

from typing import Optional

from benchmark.core.trace import busy_seconds
from benchmark.counts.peaks import floor_seconds


def device_idle_pct(run) -> Optional[float]:
    """100 x the share of the traced window with no device operation."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - busy_seconds(run.trace) / run.trace.window_s)


def roofline_pct(run, kernel: str, counts: list) -> Optional[float]:
    """100 x (the launches' summed floors) / (their summed traced time),
    `counts` one (flops, bytes, dtype) per launch of the kernel whose
    name holds `kernel`, in launch order.  None when the trace holds no
    such launch or another number of them than `counts`."""
    if run.trace is None:
        return None
    times = [e - s for name, s, e in run.trace.device if kernel in name]
    if not times or len(times) != len(counts):
        return None
    floor = sum(floor_seconds(f, b, dt) for f, b, dt in counts)
    return 100.0 * floor / (sum(times) / 1e9)


def peak_share_pct(flops: float, seconds: float,
                   peak: float) -> Optional[float]:
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * peak)
