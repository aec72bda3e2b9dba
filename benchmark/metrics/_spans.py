"""The program's own spans of the traced calls
(fac_via_ppg_torch/train/profiling.py::spans), for the readers of
per-layer metrics the program records.  A span's seconds are device time
(two CUDA events on the stream that ran its work), its `attrs` the shapes
that count the work.  A program without spans, a run without a device
trace, or records that do not match the traced calls give None, and the
metric is left out."""

from __future__ import annotations

from typing import Optional

# the span that ties the program's records to the trace: one a flow
ANCHOR = "waveglow.coupling"


def traced_spans(run) -> Optional[list]:
    """The records, if they are the traced window's: as many `ANCHOR`
    records as `ANCHOR` host events inside the window, and at least one.
    None without a device trace (a span's seconds are the host's there)."""
    if run.trace is None or not run.trace.device:
        return None
    try:
        from fac_via_ppg_torch.train.profiling import spans
    except ImportError:
        return None
    records = spans()
    w0, w1 = run.trace.window
    in_window = sum(1 for name, s, e in run.trace.host
                    if name == ANCHOR and w0 <= s and e <= w1)
    n = sum(1 for r in records if r.name == ANCHOR)
    return records if n and n == in_window else None
