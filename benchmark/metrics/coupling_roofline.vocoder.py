"""coupling_roofline.vocoder: the coupling nets' share of their roofline
over the traced calls, read from the program's spans.  Each
`waveglow.coupling` span (one flow: the cond projection, the WN net, the
affine update) counts its `waveglow.cond.project` child's operations and
bytes (benchmark/counts/cond.py) and the frozen `flow_counts` of the net
at the shapes it records; the floor is the larger of the summed compute
seconds (each part at the peak of its arithmetic) and the summed bytes
over HBM's rate, over the spans' summed device seconds.  Work moved
between the projection and the net's kernel is counted the same."""

from benchmark.counts.cond import PEAK_DTYPES, project_counts
from benchmark.counts.cond import project_dtype
from benchmark.counts.peaks import FLOPS, HBM_BYTES
from benchmark.counts.wn import flow_counts
from benchmark.metrics._spans import traced_spans


def read(run):
    records = traced_spans(run)
    if records is None:
        return None
    compute = nbytes = seconds = 0.0
    for s in records:
        a = s.attrs
        if s.name == "waveglow.coupling":
            dt = "bfloat16" if a["esz"] == 2 else "float32"
            flops, b = flow_counts(a["B"], a["T"], a["n_half"], dt, a["C"],
                                   a["L"])
            compute += flops / FLOPS[PEAK_DTYPES[a["esz"]]]
            nbytes += b
            seconds += s.seconds
        elif (s.name == "waveglow.cond.project" and s.parent is not None
              and records[s.parent].name == "waveglow.coupling"):
            ops, b = project_counts(a["M"], a["K"], a["N"], a["impl"],
                                    a["esz"])
            compute += ops / FLOPS[project_dtype(a["impl"], a["esz"])]
            nbytes += b
    if not seconds:
        return None
    return 100.0 * max(compute, nbytes / HBM_BYTES) / seconds
