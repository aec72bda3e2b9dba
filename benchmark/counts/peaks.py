"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the denominators
of every roofline and `mfu` share.  A frozen copy of
fac_via_ppg_torch/eval/roofline.py's PEAK_FLOPS / PEAK_BYTES with the
int8 and TF32 peaks added."""

BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12      # TF32 on the tensor cores
F32_FLOPS = 67e12        # float32 on the CUDA cores
INT8_OPS = 1979e12       # int8 on the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes per second

FLOPS = {"bfloat16": BF16_FLOPS, "tf32": TF32_FLOPS, "float32": F32_FLOPS,
         "int8": INT8_OPS}


def floor_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time `flops` operations in `dtype` that move `nbytes`
    can take: the larger of the two bounds."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES)
