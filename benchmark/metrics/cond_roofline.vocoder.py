"""cond_roofline.vocoder: the cond projection's share of its roofline over
the traced calls, read from the program's spans: every `waveglow.cond.*`
span (the grouped spect's int8 codes, each flow's stacked projection),
its floor from the shapes it records (benchmark/counts/cond.py) at the
peak of its arithmetic, summed, over the spans' summed device seconds.
The spans mark the work, not the kernels, so the reading follows the
projection into whatever kernels implement it."""

from benchmark.counts.cond import project_counts, project_dtype
from benchmark.counts.cond import quantize_counts
from benchmark.counts.peaks import floor_seconds
from benchmark.metrics._spans import traced_spans


def _floor(span) -> float:
    a = span.attrs
    if span.name == "waveglow.cond.quantize":
        return floor_seconds(*quantize_counts(a["M"], a["K"], a["esz"]),
                             "int8")
    return floor_seconds(*project_counts(a["M"], a["K"], a["N"], a["impl"],
                                         a["esz"]),
                         project_dtype(a["impl"], a["esz"]))


def read(run):
    records = traced_spans(run)
    if records is None:
        return None
    cond = [s for s in records if s.name.startswith("waveglow.cond.")]
    seconds = sum(s.seconds for s in cond)
    if not seconds:
        return None
    return 100.0 * sum(_floor(s) for s in cond) / seconds
