"""Operations and bytes of the vocoder's cond projection, from the shapes
the program's spans record (fac_via_ppg_torch/train/profiling.py::span):
the grouped spect's int8 codes, once a call, and each flow's stacked
projection of the spect (or its codes) onto the L x 2C channels of the
coupling net's layers.  Each input byte is counted read once; no output is
counted, since an implementation that fuses the projection into its
consumer writes none."""

from __future__ import annotations

# the fastest arithmetic a product on elements of each size may run on:
# float32 products may run on TF32 (cuBLAS, cuDNN), so TF32's peak bounds
# them
PEAK_DTYPES = {1: "int8", 2: "bfloat16", 4: "tf32"}


def project_counts(M: int, K: int, N: int, impl: str, esz: int) -> tuple:
    """(operations, bytes) of one stacked projection of M rows of K onto
    N: 2*M*K*N operations; bytes: the rows (int8 codes, or activations of
    `esz` bytes) and the weights once each, then in f32 the int8 path's
    row and column scales with the bias, or the dense path's bias."""
    ops = 2 * M * K * N
    if impl == "int8":
        return ops, M * K + K * N + 4 * (M + 2 * N)
    if impl == "dense":
        return ops, esz * (M * K + K * N) + 4 * N
    raise ValueError(f"unknown impl {impl!r}")


def quantize_counts(M: int, K: int, esz: int) -> tuple:
    """(operations, bytes) of the int8 codes of M rows of K with a scale
    each: no products; the rows read in `esz` bytes, the codes written,
    the scales in f32."""
    return 0, M * K * esz + M * K + 4 * M


def project_dtype(impl: str, esz: int) -> str:
    """The arithmetic whose peak bounds a projection."""
    return PEAK_DTYPES[1 if impl == "int8" else esz]
