"""wn_flow_roofline.vocoder: the WN flow kernel's share of its roofline
over the traced calls: the floors of its launches at their shapes (the
frozen flow_counts) over the kernel's traced time."""

from benchmark.counts.wn import flow_counts
from benchmark.metrics._readers import roofline_pct


def read(run):
    dt = run.aux.get("dtype")
    wn = run.config["waveglow_config"]["WN_config"]
    counts = [flow_counts(B, T, n_half, dt, wn["n_channels"], wn["n_layers"])
              + (dt,) for B, T, n_half in run.aux.get("flow_launches", [])]
    kernel = "wn_flow_bf16_kernel" if dt == "bfloat16" else "wn_flow_f32"
    return roofline_pct(run, kernel, counts)
