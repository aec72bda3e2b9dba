"""Small shared numeric helpers (copies of fac_via_ppg_tpu/utils/numeric.py)."""

from __future__ import annotations


def round_up(n: int, multiple: int) -> int:
    """Round n up to a multiple (shape-bucketing helper)."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def round_batch_to_grid(b: int, multiple: int = 8) -> int:
    """Round a serving batch above `multiple` up to a multiple of it.

    The JAX package pads off-grid batches (>8, not a multiple of 8) to its
    tile grid; the port keeps that policy as the default.  Whether it pays
    on the H100 has not been measured yet.  Batches <= `multiple` are
    returned unchanged.
    """
    if b <= multiple or b % multiple == 0:
        return b
    return round_up(b, multiple)
