"""One WaveGlow WN layer as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel `fac_via_ppg_tpu/ops/wn_pallas.py::
wn_layer_pallas`.  One layer, channels-last (B, T, C):

    z     = [x(t-d) | x(t) | x(t+d)] @ W_in (3C, 2C) + b_in + cond   (f32 acc)
    acts  = tanh(z[..., :C]) * sigmoid(z[..., C:])      (rounded to x.dtype)
    rs    = acts @ W_rs + b_rs                                       (f32 acc)
    audio = x + rs[..., :C],  skip = rs[..., C:]
    last layer (W_rs (C, C)): skip = rs, audio = x

Bound on the H100 at the serving shapes (C = 256, bf16): 2*(3C*2C + C*2C)
FLOP per time row against (C + 2C + 2C) * 2 bytes moved, ~410 FLOP/byte,
above the card's ~295 FLOP/byte ridge, so the tensor cores bound it (989
TFLOP/s bf16).  The kernel (`csrc/wn_layer.cu`, tile code in
`csrc/wn_tile.cuh`) keeps the (T, 2C) pre-activation and the gate output on
the SM: one block per (batch, 64-row time tile); GEMM 1 in chunks of 64
tanh + 64 sigmoid columns with the gate applied from a f32 staging tile;
the gate output stays in shared memory as the A operand of GEMM 2, whose
epilogue writes audio and skip.  Taps read zero outside [0, T), which is
the conv's zero padding, so every dilation runs in the kernel and the
caller pads and re-masks nothing.  bf16 uses the tensor cores (wmma); f32
uses full-f32 FMAs.

The kernel is built with nvcc for sm_90a from the repository's source at
first use (`ops/cuda_lib.py`) and loaded with ctypes.  CPU tensors take
`wn_layer_plain`; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fac_via_ppg_torch.ops.cuda_lib import CudaLibrary

_SYMBOLS = {torch.float32: "wn_layer_f32", torch.bfloat16: "wn_layer_bf16"}
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = CudaLibrary("wn_layer", {
    name: [_p, _p, _ll, _ll, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
           _p] for name in _SYMBOLS.values()})
LIBRARY = _LIB.library
build = _LIB.build

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


def pack_in_weight(conv_weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight (2C, C, 3) -> tap-stacked matmul form (3C, 2C):
    tap j multiplies x[t + (j-1)*d]."""
    return torch.cat([conv_weight[:, :, j].T
                      for j in range(conv_weight.shape[2])], dim=0)


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


def wn_layer(x, cond, w_in, b_in, w_rs, b_rs, dilation: int,
             last: bool = False):
    """Returns (audio, skip), each (B, T, C) in x.dtype.

    x (B, T, C) contiguous; cond (B, T, 2C), a view with unit channel
    stride is fine (the per-layer slice of the stacked cond projection);
    w_in (3C, 2C) tap-stacked [W(t-d); W(t); W(t+d)]; w_rs (C, 2C), or
    (C, C) with last=True.
    """
    if x.device.type == "cpu":
        return wn_layer_plain(x, cond, w_in, b_in, w_rs, b_rs, dilation, last)
    if x.device.type != "cuda":
        raise ValueError(f"wn_layer: unsupported device {x.device}")
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"wn_layer: unsupported dtype {x.dtype}")
    B, T, C = x.shape
    R = C if last else 2 * C
    if C % 128 or dilation < 1:
        raise ValueError(f"wn_layer: needs C % 128 == 0 and dilation >= 1, "
                         f"got C={C}, dilation={dilation}")
    dt, dev = x.dtype, x.device
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
    fn = _LIB.function(_SYMBOLS[dt])
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
