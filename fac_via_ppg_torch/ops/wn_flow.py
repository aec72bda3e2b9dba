"""One whole WaveGlow WN coupling net per launch, as a hand-written Hopper
kernel.

Replaces the Pallas TPU kernel `fac_via_ppg_tpu/ops/wn_flow_pallas.py::
wn_flow_pallas`.  For audio (B, n_half, T) and the stacked cond projection
(B, T, L*2C), channels-last inside:

    x = start(audio)                               (f32 acc, rounded to dt)
    for l in range(L), d = 2**l:
        z     = [x(t-d) | x(t) | x(t+d)] @ W_in[l] + b_in[l] + cond_l   (f32)
        acts  = tanh(z[:, :C]) * sigmoid(z[:, C:])        (rounded to dt)
        rs    = acts @ W_rs[l] + b_rs[l]                            (f32)
        x    += rs[:, :C]      (not in the last layer; the add in dt)
        skip += rs[:, C:]      (the sum kept in dt, as on the TPU)
    out = end(skip)                                -> (B, 2*n_half, T)

x is zero outside [0, T) in every layer (the conv's zero padding).  Biases
stay f32; matmul weights, x, cond and the output are in dt (f32 or bf16).

Bound on the H100 at the vocoder's serving shape (B = 8, T = 10240,
C = 256, L = 8, n_half = 4, bf16): 8,263,680 FLOP per time row, 677 GFLOP,
0.685 ms at 989 TFLOP/s, against ~0.68 GB moved (the cond read), 0.20 ms
at 3.35 TB/s: bound by tensor-core operations.

The TPU kernel keeps each tile's residual window (tile + the 255-sample
receptive-field halo on each side) in VMEM, which does not fit a Hopper
block's 227 KB.  The kernel (`csrc/wn_flow.cu`) is one persistent
cooperative launch instead: each block owns fixed (batch, 64-row) tiles; x
lives in two (B, T, C) ping-pong buffers in device memory, separated
between layers by a grid-wide barrier; the skip sum of a tile is touched
only by its own block, which applies the end conv.  Per layer and tile the
(64, 2C) pre-activation and the gate output never leave the SM (the tile
code of `csrc/wn_tile.cuh`, shared with the WN layer kernel).  So the TPU's
overlap-save halo, guard lanes, tile padding of time and channel padding
are not needed: this function takes unpadded audio and returns unpadded
output.

The kernel is built with nvcc for sm_90a at first use (`ops/cuda_lib.py`)
and loaded with ctypes.  CPU tensors take `wn_flow_plain`; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from fac_via_ppg_torch.ops.cuda_lib import CudaLibrary
from fac_via_ppg_torch.ops.wn_layer import (
    check,
    check_dense,
    pack_in_weight,
    wn_layer_plain,
)

_SYMBOLS = {torch.float32: "wn_flow_f32", torch.bfloat16: "wn_flow_bf16"}
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = CudaLibrary("wn_flow", {
    name: [_p, _p, _ll, _ll] + [_p] * 12 + [_i] * 5 + [_p]
    for name in _SYMBOLS.values()})
LIBRARY = _LIB.library
build = _LIB.build

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


def pack_wn_flow(wn: dict, dtype=None) -> dict:
    """One flow's folded WN params (torch layouts) -> the kernel's form:

        w_start (n_half, C), w_in (L, 3C, 2C) tap-stacked, w_rs (L, C, 2C),
        w_end (C, 2*n_half) in `dtype` (default: the params' own);
        b_start (C,), b_in (L, 2C), b_rs (L, 2C), b_end (2*n_half,) in f32.

    The last layer's skip-only (C, C) projection sits in columns [C, 2C)
    of w_rs / b_rs with zero residual columns, as in the TPU pack."""
    dt = dtype or wn["start"]["weight"].dtype
    C = wn["start"]["weight"].shape[0]
    L = len(wn["in_layers"])
    w_rs = wn["start"]["weight"].new_zeros((L, C, 2 * C), dtype=torch.float32)
    b_rs = w_rs.new_zeros((L, 2 * C))
    for i, p in enumerate(wn["res_skip_layers"]):
        lo = 2 * C - p["weight"].shape[0]
        w_rs[i, :, lo:] = p["weight"][:, :, 0].T.float()
        b_rs[i, lo:] = p["bias"].float()

    def w(t):
        return t.to(dt).contiguous()

    def b(t):
        return t.float().contiguous()

    return {
        "w_start": w(wn["start"]["weight"][:, :, 0].T),
        "b_start": b(wn["start"]["bias"]),
        "w_in": w(torch.stack([pack_in_weight(p["weight"])
                               for p in wn["in_layers"]])),
        "b_in": b(torch.stack([p["bias"] for p in wn["in_layers"]])),
        "w_rs": w(w_rs),
        "b_rs": b_rs,
        "w_end": w(wn["end"]["weight"][:, :, 0].T),
        "b_end": b(wn["end"]["bias"]),
    }


def wn_flow_plain(packed: dict, audio_half: torch.Tensor,
                  cond: torch.Tensor) -> torch.Tensor:
    """The coupling net in plain PyTorch (the kernel's reference; CPU
    path): start conv, L x `wn_layer_plain`, end conv, rounding to
    audio_half.dtype where the kernel does."""
    dt = audio_half.dtype
    L, _, C2 = packed["w_in"].shape
    C = C2 // 2
    x = (torch.matmul(audio_half.transpose(1, 2).float(),
                      packed["w_start"].float())
         + packed["b_start"]).to(dt)
    skip_sum = None
    for i in range(L):
        last = i == L - 1
        lo = C if last else 0
        x, skip = wn_layer_plain(
            x, cond[:, :, 2 * C * i: 2 * C * (i + 1)], packed["w_in"][i],
            packed["b_in"][i], packed["w_rs"][i][:, lo:],
            packed["b_rs"][i][lo:], dilation=2 ** i, last=last)
        skip_sum = skip if skip_sum is None else skip_sum + skip
    out = (torch.matmul(skip_sum.float(), packed["w_end"].float())
           + packed["b_end"]).to(dt)
    return out.transpose(1, 2)


def wn_flow(packed: dict, audio_half: torch.Tensor,
            cond: torch.Tensor) -> torch.Tensor:
    """One coupling net: audio_half (B, n_half, T) contiguous, cond
    (B, T, L*2C) with unit channel stride, `packed` from pack_wn_flow in
    audio_half's dtype -> (B, 2*n_half, T)."""
    if audio_half.device.type == "cpu":
        return wn_flow_plain(packed, audio_half, cond)
    if audio_half.device.type != "cuda":
        raise ValueError(f"wn_flow: unsupported device {audio_half.device}")
    dt, dev = audio_half.dtype, audio_half.device
    if dt not in _SYMBOLS:
        raise ValueError(f"wn_flow: unsupported dtype {dt}")
    B, n_half, T = audio_half.shape
    L, _, C2 = packed["w_in"].shape
    C, n_out, f32 = C2 // 2, 2 * n_half, torch.float32
    if C % 128:
        raise ValueError(f"wn_flow: needs C % 128 == 0, got C={C}")
    check("cond", cond, (B, T, L * 2 * C), dt, dev)
    if cond.stride(2) != 1:
        raise ValueError("wn_flow: cond needs a unit channel stride")
    shapes = {"w_start": ((n_half, C), dt), "b_start": ((C,), f32),
              "w_in": ((L, 3 * C, 2 * C), dt), "b_in": ((L, 2 * C), f32),
              "w_rs": ((L, C, 2 * C), dt), "b_rs": ((L, 2 * C), f32),
              "w_end": ((C, n_out), dt), "b_end": ((n_out,), f32)}
    for name, (shape, t_dt) in shapes.items():
        check(name, packed[name], shape, t_dt, dev)
        check_dense(f"wn_flow: {name}", packed[name])
    check_dense("wn_flow: audio_half", audio_half)
    x0, x1, skip = (torch.empty((B, T, C), dtype=dt, device=dev)
                    for _ in range(3))
    out = torch.empty((B, n_out, T), dtype=dt, device=dev)
    fn = _LIB.function(_SYMBOLS[dt])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(audio_half.data_ptr(), cond.data_ptr(), cond.stride(0),
             cond.stride(1),
             *(packed[name].data_ptr() for name in shapes),
             x0.data_ptr(), x1.data_ptr(), skip.data_ptr(), out.data_ptr(),
             B, T, C, L, n_half, stream)
    if err != 0:
        raise RuntimeError(f"wn_flow kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
