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
only by its own block, which applies the end conv.  So the TPU's
overlap-save halo, guard lanes, tile padding of time and channel padding
are not needed: this function takes unpadded audio and returns unpadded
output.  The three (B, T, C) buffers (126 MB in bf16 at the serving shape)
do not fit the 50 MB L2: ~0.25 GB a layer goes to device memory.

The f32 form at C = 256, the synthesis CLI's int8 path (12 launches a
batch at B = 8, T = 20000: 1.32 TFLOP, 19.7 ms at 67 TFLOP/s f32, bound by
the FMA rate), runs each tile and layer on the f32 SIMT tile of
`csrc/wn_simt.cuh`, shared with the WN layer kernel: 128 f32 accumulators
a thread over all 2C columns in one pass, the gate in registers, a
2-stage ring over the plain row-major weights (cp.async) and x (through
registers, K-major), the last layer a template parameter (~57 % of its
FMA bound on an H100); cond needs batch and time strides a multiple of 4 and
a 16-byte aligned address.  f32 and bf16 at widths other than 256
(C % 128 == 0) run the tile code of `csrc/wn_tile.cuh` (shared with the
WN layer kernel).  The bf16 form at C = 256, the vocoder's, runs each tile and
layer on the wgmma tile of `csrc/wn_wgmma.cuh`, shared with the WN layer
kernel: both GEMMs on wgmma with f32 accumulators in registers; each of
two warpgroups owns all 64 rows and 128 tanh columns plus the 128 sigmoid
columns that pair with them, so the gate is applied in registers.  Its K
steps' weight slices come from a bf16 image of W_in and W_rs that
`ops/wn_image.py::weight_image` lays out once, in the kernel's column
order and in wgmma's swizzled K-major layout (`pack_wn_flow` stores it
with the pack; the kernel needs it).  The gate is exact f32 tanh and
sigmoid, as on the TPU.  The blocks (one a SM) run in clusters of
`CLUSTER` = 2, one TPC, and a third warpgroup feeds each block through
mbarrier rings: every 32 KB weight slice is read from L2 once for the
cluster, each block multicasting its half into both blocks' shared memory
(16 KB a step a block from L2, 19.8 GB a flow at the 640-frame bucket
instead of 39.6), and the x slices come by TMA, eight steps ahead.  The
two blocks of a cluster walk their tiles in lock-step; a tile past the
last runs masked.  Launched cooperative and clustered together
(`cudaLaunchKernelEx`), one cluster per TPC (66 on an H100 SXM); the
output is bit for bit the cp.async-fed form's.  `launches` counts the
launches and `cluster_launches` those in clusters (every bf16 one at
C = 256); the `waveglow.coupling` span's `cluster` attribute is the
cluster size (`cluster_size`; 0 where no cluster runs).  What
bounds it now is not the L2's weight stream but the gate and the
epilogue (~14 us of a tile and layer's ~31 at the serving shape), during
which the tensor cores idle, and the stages a block can hold (32 KB a
step, three steps in flight).

The kernel is built with nvcc for sm_90a at first use (`ops/cuda_lib.py`)
and loaded with ctypes.  CPU tensors take `wn_flow_plain`; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from fac_via_ppg_torch.ops.cuda_lib import CudaLibrary
from fac_via_ppg_torch.ops.wn_image import KC, KERNEL_C, weight_image
from fac_via_ppg_torch.ops.wn_layer import (
    check,
    check_cond_chunks,
    check_dense,
    pack_in_weight,
    wn_layer_plain,
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_pi = ctypes.POINTER(ctypes.c_int)
_FLOW = [_p, _p, _ll, _ll] + [_p] * 12 + [_i] * 5 + [_p]
_LIB = CudaLibrary("wn_flow", {
    "wn_flow_f32": _FLOW, "wn_flow_f32_tile": _FLOW, "wn_flow_bf16": _FLOW,
    "wn_flow_bf16_tile": _FLOW, "wn_flow_f32_occupancy": [_pi, _pi],
    "wn_flow_bf16_occupancy": [_pi, _pi], "wn_flow_bf16_clusters": [_pi, _pi],
    "wn_flow_f32_gemm1_tile": [_p, _i, _i, _i, _p, _p, _p],
    "wn_flow_bf16_gemm1_tile": [_p, _i, _i, _i, _p, _p, _p]})
build = _LIB.build

# Kernel launches since the last reset (the caller sets them to 0): all of
# them, and those in clusters that share each weight read (CLUSTER blocks).
launches = 0
cluster_launches = 0

# The blocks of a cluster of the bf16 kernel at C = 256.
CLUSTER = 2


def cluster_size(dtype, C: int, device) -> int:
    """The cluster size of the flow kernel that `wn_flow` launches for
    this dtype, width and device: CLUSTER for bf16 at C = 256 on the card,
    else 0 (no cluster: the plain version, the f32 and other-width
    kernels)."""
    on_card = torch.device(device).type == "cuda"
    return CLUSTER if on_card and dtype == torch.bfloat16 \
        and C == KERNEL_C else 0


def kernel_resources(dtype=torch.bfloat16) -> tuple:
    """The C = 256 kernel's resources on the current card: with
    dtype=torch.float32 the f32 SIMT kernel's (blocks per SM, dynamic
    shared memory bytes); the bf16 wgmma kernel's (blocks per SM, dynamic
    shared memory bytes, cluster size, clusters the card holds at once)."""
    if dtype == torch.float32:
        return _LIB.occupancy("wn_flow_f32_occupancy")
    return (*_LIB.occupancy("wn_flow_bf16_occupancy"),
            *_LIB.occupancy("wn_flow_bf16_clusters"))


def gemm1_tile(x: torch.Tensor, w: torch.Tensor, t0: int,
               dilation: int) -> torch.Tensor:
    """One tile's GEMM 1 through a C = 256 kernel's ring and product path
    alone: x (T, C) on the card, contiguous; bf16: w one layer's image
    (3C/KC, 2C, KC) (a check of the image, swizzle and wgmma descriptors);
    f32: w that layer's W_in (3C, 2C) (a check of the SIMT tile's ring and
    ownership) -> (64, 2C) f32, the taps [x(t-d) | x(t) | x(t+d)] of rows
    t0.. @ W_in, in W_in's column order."""
    T, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or C != KERNEL_C \
            or not x.is_contiguous():
        raise ValueError("gemm1_tile: needs contiguous f32 or bf16 x "
                         "(T, 256)")
    if x.dtype == torch.bfloat16:
        check("w_in_img", w, (3 * C // KC, 2 * C, KC), x.dtype, x.device)
    else:
        check("w_in", w, (3 * C, 2 * C), x.dtype, x.device)
    check_dense("gemm1_tile: w", w)
    out = torch.empty((64, 2 * C), dtype=torch.float32, device=x.device)
    name = "f32" if x.dtype == torch.float32 else "bf16"
    err = _LIB.function(f"wn_flow_{name}_gemm1_tile")(
        x.data_ptr(), T, t0, dilation, w.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm1_tile launch failed: CUDA error {err}")
    return out


def pack_wn_flow(wn: dict, dtype=None) -> dict:
    """One flow's folded WN params (torch layouts) -> the kernel's form:

        w_start (n_half, C), w_in (L, 3C, 2C) tap-stacked, w_rs (L, C, 2C),
        w_end (C, 2*n_half) in `dtype` (default: the params' own);
        b_start (C,), b_in (L, 2C), b_rs (L, 2C), b_end (2*n_half,) in f32.

    The last layer's skip-only (C, C) projection sits in columns [C, 2C)
    of w_rs / b_rs with zero residual columns, as in the TPU pack.  A
    bf16 pack at the kernel's width also holds `weight_image`'s
    w_in_img / w_rs_img, built once here."""
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

    packed = {
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
    if dt == torch.bfloat16 and C == KERNEL_C:
        packed.update(weight_image(packed))
    return packed


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
    audio_half's dtype -> (B, 2*n_half, T).  On the card at C = 256, cond
    needs batch and time strides a multiple of 16 bytes and a 16-byte
    aligned address, and bf16 runs the wgmma tile: its pack must hold
    `weight_image`'s arrays, as pack_wn_flow's does."""
    if audio_half.device.type == "cpu":
        return wn_flow_plain(packed, audio_half, cond)
    if audio_half.device.type != "cuda":
        raise ValueError(f"wn_flow: unsupported device {audio_half.device}")
    dt, dev = audio_half.dtype, audio_half.device
    if dt not in (torch.float32, torch.bfloat16):
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
    args = [packed[name] for name in shapes]
    name = "f32" if dt == f32 else "bf16"
    symbol = f"wn_flow_{name}_tile"
    if C == KERNEL_C:
        symbol = f"wn_flow_{name}"
        check_cond_chunks("wn_flow", cond)
    if symbol == "wn_flow_bf16":
        if "w_in_img" not in packed:
            raise ValueError(f"wn_flow: a bf16 pack at C={KERNEL_C} needs "
                             "the kernel's weight image (pack_wn_flow, or "
                             "packed.update(weight_image(packed)))")
        for name, shape in (("w_in_img", (L, 3 * C // KC, 2 * C, KC)),
                            ("w_rs_img", (L, C // KC, 2 * C, KC))):
            check(name, packed[name], shape, dt, dev)
            check_dense(f"wn_flow: {name}", packed[name])
        args[2], args[4] = packed["w_in_img"], packed["w_rs_img"]
    x0, x1, skip = (torch.empty((B, T, C), dtype=dt, device=dev)
                    for _ in range(3))
    out = torch.empty((B, n_out, T), dtype=dt, device=dev)
    fn = _LIB.function(symbol)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(audio_half.data_ptr(), cond.data_ptr(), cond.stride(0),
             cond.stride(1), *(t.data_ptr() for t in args),
             x0.data_ptr(), x1.data_ptr(), skip.data_ptr(), out.data_ptr(),
             B, T, C, L, n_half, stream)
    if err != 0:
        raise RuntimeError(f"wn_flow kernel launch failed: CUDA error {err}")
    global launches, cluster_launches
    launches += 1
    if symbol == "wn_flow_bf16":
        cluster_launches += 1
    return out
