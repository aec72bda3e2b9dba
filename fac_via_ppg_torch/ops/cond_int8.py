"""The vocoder's int8 cond projection as one hand-written Hopper kernel.

For the grouped spect's int8 codes (B, G, K), channels-last, their scale
s (B, G) per column or one per tensor, and one flow's pack (`wq` (N, K)
int8, `w_scale` (N,) and `bias` (N,) f32, from models/waveglow.py::
pack_waveglow_int8cond):

    cond[b, g, n] = round( ((float(codes[b, g] . wq[n]) * s) * w_scale[n])
                           + bias[n] )                  -> (B, G, N)

the int32 sum exact, each f32 product and the add rounded on its own, one
rounding to the output dtype: the JAX package's order
(fac_via_ppg_tpu/models/waveglow.py:451, `_cond_all`, an XLA einsum; it
has no Pallas kernel here, so this kernel replaces none).

On the card `csrc/cond_int8.cu` computes it in one launch: an s8 `wgmma`
GEMM whose epilogue dequantizes in registers and stores only the rounded
cond, so no int32 or f32 (M, N) intermediate reaches device memory.  At
the vocoder's mean batch (M = B*G = 307,200, K = 640, N = 4096) its floor
is 1.61 TOP, 0.81 ms at 1,979 TOP/s, beside a 2.5 GB bf16 store (0.75 ms
at 3.35 TB/s).  Persistent blocks each keep a 256-column band of the
weights (permuted within 32-row groups, so that a thread's sums are 8
adjacent output columns) in shared memory and stream the codes through a
TMA ring; two warpgroups alternate between one tile's products and the
other tile's epilogue, which stores 16 bytes a thread straight from
registers (the source's note).  It takes K % 16 == 0 and K <= 640,
N % 8 == 0 and any M.

The kernel is built with nvcc for sm_90a at first use (`ops/cuda_lib.py`;
the TMA descriptors' encoder is found through the runtime's driver entry
point) and loaded with ctypes.  CPU tensors take `cond_int8_plain`, the int32 matmul chain;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from fac_via_ppg_torch.ops.cuda_lib import CudaLibrary
from fac_via_ppg_torch.ops.wn_layer import check, check_dense

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_pi = ctypes.POINTER(ctypes.c_int)
_LIB = CudaLibrary("cond_int8", {
    "cond_int8": [_p, _p, _p, _ll, _p, _p, _p, _i, _i, _i, _i, _p],
    "cond_int8_occupancy": [_pi, _pi]})
build = _LIB.build

# the largest K the kernel's resident weight band in shared memory takes
MAX_K = 640

# Kernel launches since the last reset (the caller sets it to 0).
launches = 0


def kernel_resources() -> tuple:
    """The kernel's (blocks per SM, dynamic shared memory bytes) on the
    current card, at K = 640."""
    return _LIB.occupancy("cond_int8_occupancy")


def dequantize(acc: torch.Tensor, s_scale: torch.Tensor, pk: dict,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The int32 sums (B, G, N) -> the cond: acc * s * w_scale + bias in
    f32, each operation rounded, then rounded to out_dtype.  s_scale is a
    scalar or (B, G)."""
    s = s_scale if s_scale.dim() == 0 else s_scale[:, :, None]
    return (acc.float() * s * pk["w_scale"] + pk["bias"]).to(out_dtype)


def int8_product(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(B, G, K) int8 codes . (N, K) int8 weights -> (B, G, N) int32,
    exact: an int32 matmul on the CPU, a float64 one on the card, where
    PyTorch has no int32 matmul (each sum, at most K * 127^2 in size, is
    an integer that float64 holds exactly)."""
    B, G, K = codes.shape
    rows = codes.reshape(B * G, K)
    if codes.device.type == "cpu":
        acc = torch.matmul(rows.to(torch.int32), wq.T.to(torch.int32))
    else:
        acc = torch.matmul(rows.double(), wq.T.double()).to(torch.int32)
    return acc.reshape(B, G, -1)


def cond_int8_plain(codes: torch.Tensor, s_scale: torch.Tensor, pk: dict,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The projection in plain PyTorch (the kernel's reference; the CPU
    path): the exact int32 product, then `dequantize`."""
    return dequantize(int8_product(codes, pk["wq"]), s_scale, pk, out_dtype)


def cond_int8(codes: torch.Tensor, s_scale: torch.Tensor, pk: dict,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The stacked cond projection: codes (B, G, K) int8 contiguous, s_scale
    (B, G) f32 or a scalar, pk a flow's int8 cond pack on codes' device ->
    (B, G, N) in out_dtype (bf16 or f32 on the card)."""
    if codes.device.type == "cpu":
        return cond_int8_plain(codes, s_scale, pk, out_dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"cond_int8: unsupported device {codes.device}")
    dev, f32 = codes.device, torch.float32
    if codes.dim() != 3 or codes.dtype != torch.int8:
        raise ValueError(f"cond_int8: codes must be (B, G, K) int8, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    B, G, K = codes.shape
    N = pk["wq"].shape[0]
    if K % 16 or K > MAX_K or N % 8:
        raise ValueError(f"cond_int8: the kernel takes K % 16 == 0, K <= "
                         f"{MAX_K} and N % 8 == 0; got M={B * G}, K={K}, "
                         f"N={N}")
    if out_dtype not in (torch.bfloat16, f32):
        raise ValueError(f"cond_int8: unsupported out_dtype {out_dtype}")
    check("wq", pk["wq"], (N, K), torch.int8, dev)
    for name in ("w_scale", "bias"):
        check(name, pk[name], (N,), f32, dev)
    if s_scale.dim() == 0:
        check("s_scale", s_scale, (), f32, dev)
        s_stride = 0
    else:
        check("s_scale", s_scale, (B, G), f32, dev)
        if not s_scale.is_contiguous():
            raise ValueError("cond_int8: s_scale must be contiguous")
        s_stride = 1
    for name, t in (("codes", codes), ("wq", pk["wq"]),
                    ("w_scale", pk["w_scale"]), ("bias", pk["bias"])):
        check_dense(f"cond_int8: {name}", t)
    out = torch.empty((B, G, N), dtype=out_dtype, device=dev)
    if B * G == 0:
        return out
    err = _LIB.function("cond_int8")(
        codes.data_ptr(), pk["wq"].data_ptr(), s_scale.data_ptr(), s_stride,
        pk["w_scale"].data_ptr(), pk["bias"].data_ptr(), out.data_ptr(),
        B * G, N, K, int(out_dtype == f32),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cond_int8 kernel launch failed (M={B * G}, "
                           f"K={K}, N={N}): error {err}")
    global launches
    launches += 1
    return out
