"""One WaveGlow WN layer as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel `fac_via_ppg_tpu/ops/wn_pallas.py::
wn_layer_pallas`.  One layer, channels-last (B, T, C):

    z     = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond   (f32 acc)
    acts  = tanh(z[..., :C]) * sigmoid(z[..., C:])      (rounded to x.dtype)
    rs    = acts @ W_rs + b_rs                                       (f32 acc)
    audio = x + rs[..., :C],  skip = rs[..., C:]
    last layer (W_rs (C, C)): skip = rs, audio = x

Bound on the H100 at the fused serving shape (B = 4, T = 10000, C = 256,
bf16): 2*(3C*2C + C*2C) FLOP per time row, 41.9 GFLOP, 0.0424 ms at 989
TFLOP/s, against (C + 2C + C + C) * 2 bytes per row moved, 0.031 ms at 3.35
TB/s: the tensor cores bound it.

bf16 at C = 256, the served path (`csrc/wn_layer.cu` on the wgmma tile of
`csrc/wn_wgmma.cuh`, shared with the flow kernel): one persistent block of
two warpgroups per SM walks (batch, 64-row) tiles; both GEMMs of a tile run
on wgmma with f32 accumulators in registers, fed by a cp.async ring that
runs on across the tiles; the gate is applied in registers and the
epilogue writes audio and skip 16 bytes a thread.  Its weight slices come
from the bf16 image of `ops/wn_image.py::weight_image` (`layer_images`;
`pack_wn_layer` stores it with the pack, and the kernel needs it).  What
holds it: every tile streams ~1 MB of weights from L2 into its SM (~0.63
GB a launch at the serving shape).

f32 at C = 256, the synthesis CLI's default path (96 launches a dense
batch at B = 8, T = 20000: 168 GFLOP, 2.50 ms at 67 TFLOP/s f32, bound by
the FMA rate): the f32 SIMT tile of `csrc/wn_simt.cuh`, shared with the
flow kernel.  One persistent block of 8 warps per SM walks the tiles; each
thread owns 8 rows x 8 tanh columns and the 8 sigmoid columns that pair
with them (128 f32 accumulators), so both GEMMs run in one pass over all
2C columns and the gate runs in registers; a 2-stage ring feeds the K
steps (weights by 16-byte cp.async, x 16 bytes a thread through registers
into K-major slices) and runs on across the tiles; operand fragments are
16-byte shared loads; the last layer is a template parameter.  On an H100
it runs at ~62 % of its FMA bound.  The FMA arithmetic is the plain version's, with the biases
and cond added first (only the order of the f32 sums differs).  cond must
have batch and time strides a multiple of 4 and a 16-byte aligned
address.  f32 and bf16 at other widths (C % 128 == 0) run the older tile
of `csrc/wn_tile.cuh`: one block per tile, CUDA-core FMAs in f32, wmma in
bf16.  Taps read zero outside [0, T), which is the conv's zero padding, so
every dilation runs in the kernel and the caller pads and re-masks
nothing.

The kernels are built with nvcc for sm_90a from the repository's sources
at first use (`ops/cuda_lib.py`) and loaded with ctypes.  CPU tensors take
`wn_layer_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fac_via_ppg_torch.ops.cuda_lib import CudaLibrary
from fac_via_ppg_torch.ops.wn_image import KC, KERNEL_C, weight_image

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_pi = ctypes.POINTER(ctypes.c_int)
_LAYER = [_p, _p, _ll, _ll, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p]
_LIB = CudaLibrary("wn_layer", {
    "wn_layer_f32": _LAYER, "wn_layer_f32_tile": _LAYER,
    "wn_layer_bf16_tile": _LAYER, "wn_layer_bf16": _LAYER,
    "wn_layer_f32_occupancy": [_pi, _pi],
    "wn_layer_bf16_occupancy": [_pi, _pi]})
build = _LIB.build

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


def pack_in_weight(conv_weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight (2C, C, 3) -> tap-stacked matmul form (3C, 2C):
    tap j multiplies x[t + (j-1)*d]."""
    return torch.cat([conv_weight[:, :, j].T
                      for j in range(conv_weight.shape[2])], dim=0)


def layer_images(in_w, rs_w) -> dict:
    """The bf16 wgmma tile's weight image of L layers: in_w L tap-stacked
    (3C, 2C) weights, rs_w L res/skip weights (C, 2C), of which the last
    may be the skip-only (C, C): it goes to the skip columns [C, 2C), with
    zero residual columns, as in the flow pack.  -> {"in_img":
    (L, 3C/KC, 2C, KC), "rs_img": (L, C/KC, 2C, KC)} in bf16."""
    w_in = torch.stack(list(in_w))
    C = w_in.shape[-1] // 2
    w_rs = w_in.new_zeros((len(rs_w), C, 2 * C))
    for i, w in enumerate(rs_w):
        w_rs[i, :, 2 * C - w.shape[1]:] = w
    img = weight_image({"w_in": w_in, "w_rs": w_rs})
    return {"in_img": img["w_in_img"], "rs_img": img["w_rs_img"]}


def kernel_resources(dtype=torch.bfloat16) -> tuple:
    """The C = 256 kernel's (blocks per SM, dynamic shared memory bytes) on
    the current card: the bf16 wgmma kernel, or with dtype=torch.float32
    the f32 SIMT kernel."""
    name = "f32" if dtype == torch.float32 else "bf16"
    return _LIB.occupancy(f"wn_layer_{name}_occupancy")


def wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, dilation: int,
                   last: bool = False):
    """The layer in plain PyTorch (the kernel's reference; CPU path)."""
    B, T, C = x.shape
    d = dilation
    xp = F.pad(x, (0, 0, d, d))
    x_cat = torch.cat([xp[:, :T], xp[:, d:d + T], xp[:, 2 * d:2 * d + T]],
                      dim=2)
    z = torch.matmul(x_cat.float(), w_in.float()) + b_in.float()
    z = z + cond.float()
    acts = (torch.tanh(z[..., :C]) * torch.sigmoid(z[..., C:])).to(x.dtype)
    rs = torch.matmul(acts.float(), w_rs.float()) + b_rs.float()
    if last:
        return x, rs.to(x.dtype)
    return x + rs[..., :C].to(x.dtype), rs[..., C:].to(x.dtype)


def check(name, t, shape, dtype, device):
    """Raises unless `t` has this shape, dtype and device."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")


def check_dense(name, t):
    """Raises unless `t` is contiguous and 16-byte aligned (the kernels
    read it in 16-byte vectors)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_cond_chunks(name, cond):
    """Raises unless the kernels' 16-byte copies of cond rows can take
    `cond`: batch and time strides a multiple of 16 bytes and a 16-byte
    aligned address."""
    n = 16 // cond.element_size()
    if cond.stride(0) % n or cond.stride(1) % n or cond.data_ptr() % 16:
        raise ValueError(f"{name}: cond needs batch and time strides a "
                         f"multiple of {n} and a 16-byte aligned address")


def wn_layer(x, cond, w_in, b_in, w_rs, b_rs, dilation: int,
             last: bool = False, in_img=None, rs_img=None):
    """Returns (audio, skip), each (B, T, C) in x.dtype.

    x (B, T, C) contiguous; cond (B, T, 2C), a view with unit channel
    stride is fine (the per-layer slice of the stacked cond projection);
    w_in (3C, 2C) tap-stacked [W(t-d); W(t); W(t+d)]; w_rs (C, 2C), or
    (C, C) with last=True.  On the card at C = 256, cond needs batch and
    time strides a multiple of 16 bytes and a 16-byte aligned address, and
    bf16 runs the wgmma tile: it needs this layer's weight image, in_img
    (3C/KC, 2C, KC) and rs_img (C/KC, 2C, KC) (`layer_images`;
    `pack_wn_layer` stores it).
    """
    if x.device.type == "cpu":
        return wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, dilation, last)
    if x.device.type != "cuda":
        raise ValueError(f"wn_layer: unsupported device {x.device}")
    dt, dev = x.dtype, x.device
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wn_layer: unsupported dtype {dt}")
    B, T, C = x.shape
    R = C if last else 2 * C
    if C % 128 or dilation < 1:
        raise ValueError(f"wn_layer: needs C % 128 == 0 and dilation >= 1, "
                         f"got C={C}, dilation={dilation}")
    check("cond", cond, (B, T, 2 * C), dt, dev)
    check("w_in", w_in, (3 * C, 2 * C), dt, dev)
    check("b_in", b_in, (2 * C,), dt, dev)
    check("w_rs", w_rs, (C, R), dt, dev)
    check("b_rs", b_rs, (R,), dt, dev)
    if cond.stride(2) != 1:
        raise ValueError("wn_layer: cond needs a unit channel stride")
    for name, t in (("x", x), ("w_in", w_in), ("b_in", b_in),
                    ("w_rs", w_rs), ("b_rs", b_rs)):
        check_dense(f"wn_layer: {name}", t)
    name = "f32" if dt == torch.float32 else "bf16"
    symbol = f"wn_layer_{name}_tile"
    if C == KERNEL_C:
        symbol = f"wn_layer_{name}"
        check_cond_chunks("wn_layer", cond)
    if symbol == "wn_layer_bf16":
        if in_img is None or rs_img is None:
            raise ValueError(f"wn_layer: bf16 at C={KERNEL_C} needs the "
                             "kernel's weight image (pack_wn_layer's "
                             "in_img / rs_img, or layer_images)")
        check("in_img", in_img, (3 * C // KC, 2 * C, KC), dt, dev)
        check("rs_img", rs_img, (C // KC, 2 * C, KC), dt, dev)
        check_dense("wn_layer: in_img", in_img)
        check_dense("wn_layer: rs_img", rs_img)
        w_in, w_rs = in_img, rs_img
    fn = _LIB.function(symbol)
    skip = torch.empty((B, T, C), dtype=dt, device=dev)
    audio = x if last else torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), cond.data_ptr(), cond.stride(0), cond.stride(1),
             w_in.data_ptr(), b_in.data_ptr(), w_rs.data_ptr(),
             b_rs.data_ptr(), audio.data_ptr(), skip.data_ptr(),
             B, T, C, R, dilation, int(last), stream)
    if err != 0:
        raise RuntimeError(f"wn_layer kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return audio, skip
