"""Operations and bytes of one launch of each hand-written WN kernel: a
frozen copy of fac_via_ppg_torch/eval/roofline.py's `layer_counts` and
`flow_counts`.  Each input byte is counted read once and each output byte
written once; the weights once, in the pack's dtype, biases in f32 where
the kernel takes them so."""

from __future__ import annotations


def _esz(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def layer_counts(B: int, T: int, dtype: str, C: int = 256,
                 last: bool = False) -> tuple:
    """(FLOP, bytes) of one WN layer launch: FLOP 2*B*T*(3C*2C + C*R) with
    R = 2C (C on the last layer); bytes: x, cond, both outputs (the skip
    alone on the last layer) once, and the weights and biases once."""
    esz = _esz(dtype)
    R = C if last else 2 * C
    flops = 2 * B * T * (3 * C * 2 * C + C * R)
    nbytes = (B * T * (C + 2 * C + (0 if last else C) + C)
              + 3 * C * 2 * C + 2 * C + C * R + R) * esz
    return flops, nbytes


def flow_counts(B: int, T: int, n_half: int, dtype: str, C: int = 256,
                L: int = 8) -> tuple:
    """(FLOP, bytes) of one whole-net launch: FLOP per time row
    2*(n_half*C + L*3C*2C + (L-1)*C*2C + C*C + C*2*n_half); bytes: audio,
    cond and output once, the weights once, biases in f32."""
    esz = _esz(dtype)
    flops = 2 * B * T * (n_half * C + L * 6 * C * C + (L - 1) * 2 * C * C
                         + C * C + 2 * C * n_half)
    nbytes = (esz * (B * T * (n_half + L * 2 * C + 2 * n_half)
                     + n_half * C + L * 6 * C * C + L * 2 * C * C
                     + 2 * C * n_half)
              + 4 * (C + 4 * L * C + 2 * n_half))
    return flops, nbytes
