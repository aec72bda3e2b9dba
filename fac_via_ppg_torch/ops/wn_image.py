"""The weight image of the bf16 wgmma tile (`csrc/wn_wgmma.cuh`), shared
by the WN layer kernel (ops/wn_layer.py) and the whole-net flow kernel
(ops/wn_flow.py).

The tile copies each K step's weight slice into shared memory as it lies,
so the host lays W_in and W_rs out once, per layer and K step of depth
KC: K-major (one row per output column), in the tile's column order and
in wgmma's swizzled layout.  Built only for C = KERNEL_C.
"""

from __future__ import annotations

import torch

# The wgmma tile: its channels, and the depth of one ring step.
KERNEL_C = 256
KC = 32


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """K-major rows (..., N, kc) -> wgmma's swizzled order: in row n the
    16-byte chunk c sits at chunk c ^ (((n * 2kc) >> 7) & (2kc/16 - 1)),
    the XOR of address bits 4.. with bits 7.. that the kernel's `swz` and
    the descriptor's swizzle mode apply.  Its own inverse."""
    n_rows, kc = t.shape[-2:]
    n = torch.arange(n_rows, device=t.device)
    f = ((n * 2 * kc) >> 7) & (2 * kc // 16 - 1)
    idx = torch.arange(kc // 8, device=t.device)[None, :] ^ f[:, None]
    chunks = t.unflatten(-1, (kc // 8, 8))
    return chunks.gather(-2, idx[..., None].expand(chunks.shape)).flatten(-2)


def gemm1_columns(C: int, device=None) -> torch.Tensor:
    """W_in's column for each row of the kernel's GEMM 1 image: warpgroup
    w's rows w*C.. hold tanh columns w*C/2.. then the sigmoid columns
    C + w*C/2.. that pair with them."""
    n = torch.arange(2 * C, device=device)
    w, p, i = n // C, (n % C) // (C // 2), n % (C // 2)
    return p * C + w * (C // 2) + i


def weight_image(packed: dict) -> dict:
    """The wgmma tile's weight image of L stacked layers, {"w_in": (L, 3C,
    2C) tap-stacked, "w_rs": (L, C, 2C)} (a last layer's skip-only
    projection in columns [C, 2C), zero residual columns): per layer and
    K step of depth KC, the step's (2C, KC) weight slice K-major (one row
    per output column) and swizzled, so the kernel copies it to shared
    memory as it lies:

        w_in_img (L, 3C/KC, 2C, KC): columns in `gemm1_columns` order;
        w_rs_img (L, C/KC, 2C, KC):  columns in w_rs's own order."""
    w_in, w_rs = packed["w_in"], packed["w_rs"]
    C = w_in.shape[-1] // 2
    if C % KC:
        raise ValueError(f"weight_image: needs C % {KC} == 0, got C={C}")

    def image(w):
        steps = w.unflatten(1, (w.shape[1] // KC, KC)).transpose(-1, -2)
        return _swizzle(steps.to(torch.bfloat16).contiguous()).contiguous()

    return {"w_in_img": image(w_in[:, :, gemm1_columns(C, w_in.device)]),
            "w_rs_img": image(w_rs)}


def public_from_image(img: dict) -> dict:
    """`weight_image`'s inverse: {"w_in": (L, 3C, 2C), "w_rs": (L, C, 2C)}."""

    def rows(t):
        return _swizzle(t).transpose(-1, -2).flatten(1, 2)

    w_in_perm = rows(img["w_in_img"])
    w_in = torch.empty_like(w_in_perm)
    w_in[:, :, gemm1_columns(w_in.shape[-1] // 2, w_in.device)] = w_in_perm
    return {"w_in": w_in, "w_rs": rows(img["w_rs_img"]).contiguous()}
