"""mfu.vocoder: WaveGlow's model FLOPs for the unpadded audio completed in
the window, over the window's seconds times the bf16 peak (989 TFLOP/s)."""

from benchmark.counts.peaks import BF16_FLOPS
from benchmark.metrics._readers import peak_share_pct


def read(run):
    return peak_share_pct(run.window.get("model_flops"),
                          run.window.get("seconds"), BF16_FLOPS)
