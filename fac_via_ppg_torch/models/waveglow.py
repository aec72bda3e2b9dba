"""WaveGlow normalizing-flow vocoder (torch): inference, and the training
forward `waveglow_forward`.

The port of fac_via_ppg_tpu/models/waveglow.py (reference
src/waveglow/glow.py:62-311).  Parameters are the JAX package's
dictionaries in their folded form (weight-norm g/v already folded;
`weights.py` converts), layouts torch's: Conv1d (out, in, k),
ConvTranspose1d (in, out, k).  Layouts at the public functions follow the
JAX package: channels-first (B, C, T).

Three coupling-net implementations:
  * `wn_apply` -- the conv formulation (the JAX package's wn_impl="xla").
  * `wn_apply_layer` -- channels-last on the hand-written WN layer kernel
    (ops/wn_layer.py; the JAX package's wn_impl="pallas"); a bf16 pack at
    C = 256 carries the kernel's weight image.  The start
    conv, the stacked cond projection and the end conv are plain matmuls,
    as the JAX package computes them outside its kernel.
  * `wn_apply_flow` -- one launch of the whole-net kernel per flow
    (ops/wn_flow.py; the JAX package's wn_impl="flow").  The stacked cond
    projection is computed outside it, as in the JAX package.

Serving has one form: `serving_form` checks the options once
(`check_serving`), casts the weights once and builds the packs the
chosen path needs; `waveglow_serve` runs it and packs nothing;
`waveglow_infer` builds a form for one call.

The cond projection runs dense or, with `cond_impl="int8"`, as an int8
matmul with int32 accumulation (per-column activation scales,
per-out-channel weight scales) and exact dequantization: on the card one
launch of the hand-written kernel of ops/cond_int8.py, on channels-last
codes made once a call (`quantize_cond`).  The WN int8
rungs (conv formulation only, as in the JAX package) also run the dilated
in_layer convs and the res_skip convs of chosen flows on int8 codes
(`pack_waveglow_wn_int8`).  Training and inference both take the grouped
spect straight from the upsampler's phases (`upsample_grouped`).

Training takes the train form (`weight_norm_params`): every WN conv but
the end conv as weight-norm (g, v, bias), folded inside the forward's
autograd graph with the f32 norm and run on the conv formulation
(`wn_apply`), as the JAX package trains on its XLA convs.

Tensor parallelism (`serving_form(mesh=)` with a model axis above 1,
and `waveglow_forward(model_group=)` in training) runs the conv
formulation on each rank's WN channels (parallel/sharding.py's paired
rule; `wn_apply(model_group=)`), as the JAX package runs its XLA
formulation under GSPMD; the hand kernels take whole channels and raise
there.  Serving and training share one TP coupling net (`_wn_apply_tp`),
on parallel/tp.py's differentiable collectives; serving runs it under
no_grad.  The WN int8 rungs run on each rank's slice of their packs
(`tp_shard_wn_int8`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.ops.cond_int8 import cond_int8
from fac_via_ppg_torch.ops.layers import conv1d
from fac_via_ppg_torch.ops.wn_flow import cluster_size, pack_wn_flow, wn_flow
from fac_via_ppg_torch.ops.wn_image import KERNEL_C
from fac_via_ppg_torch.ops.wn_layer import (
    layer_images,
    pack_in_weight,
    wn_layer,
)
from fac_via_ppg_torch.parallel.tp import copy_to_model, reduce_from_model
from fac_via_ppg_torch.train.profiling import span
from fac_via_ppg_torch.weights import fold_wn


def tp_shard_waveglow(params, mesh):
    """This rank's slices of WaveGlow's params under the paired WN rule
    (parallel/sharding.py::waveglow_param_shardings): `serving_form`'s
    `packed_wn` under tensor parallelism."""
    from fac_via_ppg_torch.parallel.sharding import (
        apply_shardings,
        waveglow_param_shardings,
    )

    return apply_shardings(params, waveglow_param_shardings(mesh, params),
                           mesh)


def tp_shard_int8cond(cfg: WaveGlowConfig, packed: list, mesh) -> list:
    """This rank's rows of `pack_waveglow_int8cond`'s packs: each layer's
    two gate halves cut as the dense cond_layers are
    (parallel/sharding.py::int8cond_shardings).  On the card the rows feed
    the cond kernel (ops/cond_int8.py), whose N (the row count,
    L*2C/model) must be a multiple of 8."""
    from fac_via_ppg_torch.parallel.sharding import (
        apply_shardings,
        int8cond_shardings,
    )

    n = cfg.wn_n_layers * 2 * cfg.wn_n_channels // mesh.shape["model"]
    if packed[0]["wq"].is_cuda and n % 8:
        raise ValueError(f"int8 cond under model_parallel="
                         f"{mesh.shape['model']} gives {n} rows a rank; "
                         f"the int8 cond kernel needs a multiple of 8")
    return apply_shardings(packed, int8cond_shardings(mesh, packed,
                                                      cfg.wn_n_layers),
                           mesh)


def tp_shard_wn_int8(packed: list, mesh) -> list:
    """This rank's part of `pack_waveglow_wn_int8`'s packs under the
    paired rule (parallel/sharding.py::wn_int8_shardings): the in conv's
    codes, scales and bias on its paired output channels, the res_skip
    codes on their input channels, their per-output-channel scales and
    bias whole."""
    from fac_via_ppg_torch.parallel.sharding import (
        apply_shardings,
        wn_int8_shardings,
    )

    return apply_shardings(packed, wn_int8_shardings(mesh, packed), mesh)


def flow_channels(cfg: WaveGlowConfig) -> List[int]:
    """Audio channels entering each flow (reference glow.py:199-206)."""
    chans = []
    remaining = cfg.n_group
    for k in range(cfg.n_flows):
        if k % cfg.n_early_every == 0 and k > 0:
            remaining -= cfg.n_early_size
        chans.append(remaining)
    return chans


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """x @ w + b with f32 products and accumulation, rounded to dtype."""
    return (torch.matmul(x.float(), w.float()) + b.float()).to(dtype)


# ==========================================================================
# init
# ==========================================================================

def _conv_params(g: torch.Generator, in_ch, out_ch, k) -> dict:
    """torch Conv1d default (kaiming_uniform a=sqrt(5)) init."""
    bound = 1.0 / math.sqrt(in_ch * k)
    u = lambda shape: (torch.rand(shape, generator=g) * 2 - 1) * bound  # noqa: E731
    return {"weight": u((out_ch, in_ch, k)), "bias": u((out_ch,))}


def init_waveglow(cfg: WaveGlowConfig, generator: torch.Generator):
    """Returns params with the JAX package's structure and initial
    distributions, weight norm folded (identity at init).  The end convs
    are zero, so every coupling starts as the identity (glow.py:127-131)."""
    g = generator
    C = cfg.wn_n_channels
    n_mel_grouped = cfg.n_mel_channels * cfg.n_group
    params = {
        # ConvTranspose1d (in, out, k); in == out, so the Conv1d draw fits
        "upsample": _conv_params(g, cfg.n_mel_channels, cfg.n_mel_channels,
                                 cfg.upsample_kernel_size),
        "convinv": [],
        "wn": [],
    }
    for k, audio_ch in enumerate(flow_channels(cfg)):
        # Invertible 1x1: random orthonormal with det +1 (glow.py:73-80).
        w, _ = torch.linalg.qr(torch.randn((audio_ch, audio_ch), generator=g))
        if torch.linalg.det(w) < 0:
            w[:, 0] = -w[:, 0]
        params["convinv"].append({"weight": w})
        n_half = audio_ch // 2
        params["wn"].append({
            "start": _conv_params(g, n_half, C, 1),
            "end": {"weight": torch.zeros((2 * n_half, C, 1)),
                    "bias": torch.zeros((2 * n_half,))},
            "in_layers": [_conv_params(g, C, 2 * C, cfg.wn_kernel_size)
                          for _ in range(cfg.wn_n_layers)],
            "cond_layers": [_conv_params(g, n_mel_grouped, 2 * C, 1)
                            for _ in range(cfg.wn_n_layers)],
            "res_skip_layers": [
                _conv_params(g, C, 2 * C if i < cfg.wn_n_layers - 1 else C, 1)
                for i in range(cfg.wn_n_layers)],
        })
    return params


def weight_norm_params(params):
    """The folded form -> the train form: every WN conv but the zero end
    conv split as torch.nn.utils.weight_norm(dim=0) does, g = ||w|| per
    output channel and v = w (JAX `_weight_norm_init`)."""
    def split(p):
        w = p["weight"]
        return {"g": torch.sqrt(torch.sum(w ** 2, dim=(1, 2))), "v": w,
                "bias": p["bias"]}

    out = {"upsample": params["upsample"], "convinv": params["convinv"],
           "wn": []}
    for wn in params["wn"]:
        out["wn"].append({
            "start": split(wn["start"]), "end": wn["end"],
            "in_layers": [split(p) for p in wn["in_layers"]],
            "cond_layers": [split(p) for p in wn["cond_layers"]],
            "res_skip_layers": [split(p) for p in wn["res_skip_layers"]],
        })
    return out


def remove_weightnorm(params):
    """Adds the f32 1x1 inverses `convinv[k].weight_inverse`
    (glow.py:295-311).  Weight norm is already folded in the port's form."""
    out = dict(params)
    out["convinv"] = [
        {"weight": p["weight"],
         "weight_inverse": torch.linalg.inv(p["weight"].float())}
        for p in params["convinv"]
    ]
    return out


def cast_params(params, dtype: torch.dtype):
    """Cast floating-point leaves (e.g. to bf16 for serving); the 1x1
    inverses `weight_inverse` stay f32."""
    if isinstance(params, dict):
        return {k: v if k == "weight_inverse" else cast_params(v, dtype)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


# ==========================================================================
# upsampler and grouping
# ==========================================================================

def _upsample_phases(p: dict, spect: torch.Tensor,
                     hop: int) -> torch.Tensor:
    """The phase-decomposed transpose conv's one matmul (see
    upsample_phase_matmul): (B, C_in, F) -> (B, F, hop, C_out), f32
    products and accumulation, the bias added in f32, rounded to the
    spect's dtype."""
    weight = p["weight"]  # (C_in, C_out, K)
    c_in, c_out, k = weight.shape
    j_taps = -(-k // hop)
    w = weight.new_zeros((j_taps * hop, c_in, c_out))
    w[:k] = weight.permute(2, 0, 1)
    w_mat = (w.reshape(j_taps, hop, c_in, c_out).permute(0, 2, 1, 3)
             .reshape(j_taps * c_in, hop * c_out))
    B, _, F_ = spect.shape
    x_pad = F.pad(spect.transpose(1, 2), (0, 0, j_taps - 1, 0))
    x_cat = torch.cat([x_pad[:, j_taps - 1 - j: j_taps - 1 - j + F_]
                       for j in range(j_taps)], dim=-1)  # (B, F, J*C_in)
    out = torch.matmul(x_cat.float(), w_mat.float()).reshape(B, F_, hop, c_out)
    return (out + p["bias"].float()).to(spect.dtype)


def upsample_phase_matmul(p: dict, spect: torch.Tensor,
                          hop: int) -> torch.Tensor:
    """ConvTranspose1d(k, stride=hop) as one phase-decomposed matmul:

        out[b, q*hop + r, o] = sum_{j, i} spect[b, q - j, i] * W[i, o, j*hop + r]

    with J = ceil(k / hop) shifted copies of the mel frames.  Yields
    exactly F*hop samples, i.e. the reference's artifact cutoff (k - hop)
    is built in (glow.py:254-256).  (B, C_in, F) -> (B, C_out, F*hop)."""
    out = _upsample_phases(p, spect, hop)
    B, F_, _, c_out = out.shape
    return out.reshape(B, F_ * hop, c_out).transpose(1, 2)


def upsample_grouped(p: dict, spect: torch.Tensor, hop: int, n_group: int,
                     t_samples: Optional[int] = None) -> torch.Tensor:
    """upsample_phase_matmul + group_spect in one layout step (JAX
    `upsample_grouped`): the matmul's (B, F, hop, C) phases go straight to
    the grouped spect, sample t = g*n_group + n landing at
    [b, m*n_group + n, g].  The values are the two-step path's, bit for
    bit, and so is the layout: one contiguous (B, G, C*n_group) copy,
    returned as its (B, C*n_group, G) transpose, as group_spect returns
    it, so that the cond projection reads the same bytes in the same order.

    `t_samples` keeps its whole groups, sliced before the one copy.  Any
    hop works: the JAX form splits hop into (hop/n_group, n_group) and
    raises unless hop % n_group == 0, this one splits the flat sample
    axis, which is a view for every hop."""
    out = _upsample_phases(p, spect, hop)        # (B, F, hop, C)
    B, F_, _, C = out.shape
    T = F_ * hop if t_samples is None else min(t_samples, F_ * hop)
    G = T // n_group
    x = (out.reshape(B, F_ * hop, C)[:, :G * n_group]
         .reshape(B, G, n_group, C))             # a view
    return x.permute(0, 1, 3, 2).reshape(B, G, C * n_group).transpose(1, 2)


def group_spect(spect_up: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, M, T_samp) -> (B, M*n_group, T_samp/n_group), mel-major per group
    (reference glow.py:221-222)."""
    B, M, T = spect_up.shape
    G = T // n_group
    x = spect_up[:, :, :G * n_group].reshape(B, M, G, n_group)
    return x.permute(0, 2, 1, 3).reshape(B, G, M * n_group).transpose(1, 2)


def group_audio(audio: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, T) -> (B, n_group, T/n_group) (reference glow.py:224)."""
    B, T = audio.shape
    G = T // n_group
    return audio[:, :G * n_group].reshape(B, G, n_group).transpose(1, 2)


def ungroup_audio(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_group, G) -> (B, T) (reference glow.py:292)."""
    return audio.transpose(1, 2).reshape(audio.shape[0], -1)


# ==========================================================================
# WN coupling network
# ==========================================================================

def quantize_per_tensor_int8(x: torch.Tensor):
    """Dynamic symmetric per-tensor int8: (q, scale) with x ~= q * scale."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_column_int8(x: torch.Tensor):
    """Dynamic symmetric int8 per (batch, position) column of a (B, C, G)
    activation: (q, scale (B, G)) with x[b, :, g] ~= q[b, :, g] * s[b, g].
    The scale sits outside the matmul's contraction over C, so
    dequantization is exact."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None, :]), -127, 127)
    return q.to(torch.int8), scale


def _per_row_int8(w: torch.Tensor):
    """Symmetric int8 codes of an f32 weight, one scale per output row
    (dim 0): (codes, scales)."""
    dims = tuple(range(1, w.dim()))
    scale = torch.clamp(w.abs().amax(dim=dims), min=1e-8) / 127.0
    shape = (-1,) + (1,) * len(dims)
    q = torch.clamp(torch.round(w / scale.view(shape)), -127, 127)
    return q.to(torch.int8), scale


def pack_waveglow_int8cond(cfg: WaveGlowConfig, params: dict) -> list:
    """Per flow, the stacked cond weights (L*2C, n_mel*n_group) as int8
    with per-out-channel symmetric scales, and the bias in f32.  Computed
    once outside the call; feed to waveglow_infer(cond_impl="int8",
    packed_cond=...).  Lossy: gate it on a measured SNR
    (eval/int8_snr.select_cond_impl)."""
    packed = []
    for wn in params["wn"]:
        w = torch.cat([p["weight"] for p in wn["cond_layers"]],
                      dim=0)[:, :, 0].float()
        b = torch.cat([p["bias"] for p in wn["cond_layers"]], dim=0)
        wq, w_scale = _per_row_int8(w)
        packed.append({"wq": wq, "w_scale": w_scale, "bias": b.float()})
    return packed


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: torch._int_mm
    on CUDA (M > 16, K and N multiples of 8, else ValueError), an int32
    matmul on the CPU (|sums| < 2^31 for K < 2^17)."""
    if a.device.type == "cuda":
        (M, K), N = a.shape, b.shape[1]
        if M <= 16 or K % 8 or N % 8:
            raise ValueError(f"torch._int_mm needs M > 16 and K, N multiples"
                             f" of 8; got M={M}, K={K}, N={N}")
        return torch._int_mm(a.contiguous(), b.contiguous())
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def pack_waveglow_wn_int8(cfg: WaveGlowConfig, params: dict) -> list:
    """Per flow, per layer, the WN in_layer dilated conv and res_skip 1x1
    conv as int8 codes with per-out-channel scales (the in conv's scale
    shared by its 3 taps), biases in f32 (JAX `pack_waveglow_wn_int8`).
    Computed once outside the call; feed to waveglow_infer(wn_int8_flows=n
    or wn_int8_rs_flows=n, packed_wn_int8=...).  Lossy, and the error
    feeds back through the later flows: measure the SNR ladder
    (eval/int8_snr.run_ladder(include_wn_int8=True)) first.

    Per layer: "wq" (3, 2C, C) tap-major, "wq_stacked" (2C, 3C) for the
    per-tensor variant, "w_scale" (2C,), "bias", "rs_wq" (2C|C, C),
    "rs_w_scale", "rs_bias"."""
    packed = []
    for wn in (fold_wn(wn) for wn in params["wn"]):
        layers = []
        for p, rs in zip(wn["in_layers"], wn["res_skip_layers"]):
            wq, w_scale = _per_row_int8(p["weight"].float())   # (2C, C, 3)
            rs_q, rs_scale = _per_row_int8(rs["weight"][:, :, 0].float())
            layers.append({
                "wq": wq.permute(2, 0, 1).contiguous(),
                "wq_stacked": wq.permute(0, 2, 1).reshape(wq.shape[0], -1),
                "w_scale": w_scale,
                "bias": p["bias"].float(),
                "rs_wq": rs_q,
                "rs_w_scale": rs_scale,
                "rs_bias": rs["bias"].float(),
            })
        packed.append(layers)
    return packed


def _int8_conv1x1(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """einsum("oc,bcg->bog") of int8 codes with int32 accumulation, as
    one (B*G, C) @ (C, O) matmul: (B, G, O) int32, channels-last."""
    B, C, G = xq.shape
    return _int8_matmul(xq.transpose(1, 2).reshape(B * G, C),
                        wq.T).reshape(B, G, -1)


def _rs_int8_product(pk: dict, acts: torch.Tensor) -> torch.Tensor:
    """The res_skip 1x1 conv's product on int8 codes, dequantized, no
    bias, f32 channels-last (B, G, 2C|C).  The gate output lies in (-1,
    1), so round(acts * 127) is its code with the static scale 1/127:
    no activation scale is measured, so a rank holding some of the input
    channels (tensor parallelism) needs no model-group max."""
    aq = torch.clamp(torch.round(acts.float() * 127.0), -127, 127)
    acc = _int8_conv1x1(pk["rs_wq"], aq.to(torch.int8))
    return acc.float() * (pk["rs_w_scale"] / 127.0)


def _rs_conv_int8(pk: dict, acts: torch.Tensor) -> torch.Tensor:
    """The res_skip 1x1 conv on int8 codes (JAX `_rs_conv_int8`): one
    int32 product, dequantized through rs_w_scale / 127 with the bias in
    f32, rounded to the acts' dtype.  (B, C, G) -> (B, 2C|C, G)."""
    out = _rs_int8_product(pk, acts) + pk["rs_bias"]
    return out.to(acts.dtype).transpose(1, 2)


def _shift3(t: torch.Tensor, dilation: int) -> list:
    """The k=3 conv's three taps of t's last axis, zero outside [0, G):
    tap j holds t[..., g + (j - 1) * dilation] (JAX `shift3`)."""
    G = t.shape[-1]
    outs = []
    for j in range(3):
        s = (j - 1) * dilation
        if s < 0:
            outs.append(F.pad(t, (-s, 0))[..., :G])
        elif s > 0:
            outs.append(F.pad(t, (0, s))[..., s:])
        else:
            outs.append(t)
    return outs


def _in_conv_int8(pk: dict, x: torch.Tensor, dilation: int,
                  quant: str = "column") -> torch.Tensor:
    """The WN in_layer k=3 dilated conv on int8 codes (JAX
    `_in_conv_int8`), as its three taps, out[t] = sum_j W[:, :, j] @
    x[t + (j-1)*d], the shifts zero-padded at the sequence edges.

    quant="column": x quantized per (batch, position) column; each tap is
    its own int32 product, dequantized through its shifted column scale,
    the three summed in f32, then * w_scale + bias.  quant="tensor": one
    per-tensor scale and one stacked (2C, 3C) product over the
    tap-concatenated codes.  (B, C, G) -> (B, 2C, G) in x's dtype."""
    if quant == "tensor":
        xq, xs = quantize_per_tensor_int8(x)
        acc = _int8_conv1x1(pk["wq_stacked"],
                            torch.cat(_shift3(xq, dilation), dim=1))
        out = acc.float() * (xs * pk["w_scale"]) + pk["bias"]
        return out.to(x.dtype).transpose(1, 2)
    xq, xs = quantize_per_column_int8(x)                   # int8, (B, G)
    acc = None
    for wq, q, s in zip(pk["wq"], _shift3(xq, dilation),
                        _shift3(xs, dilation)):
        term = _int8_conv1x1(wq, q).float() * s[:, :, None]
        acc = term if acc is None else acc + term
    out = acc * pk["w_scale"] + pk["bias"]
    return out.to(x.dtype).transpose(1, 2)


def _project_span(x: torch.Tensor, N: int, impl: str, esz: int):
    """The span of one stacked cond projection of the grouped spect or
    its codes `x` (B, K, G) onto N = L*2C channels: M = B*G rows, `impl`
    "int8" or "dense", `esz` the bytes of the spect's dtype."""
    B, K, G = x.shape
    return span("waveglow.cond.project", x.device, M=B * G, K=K, N=N,
                impl=impl, esz=esz)


def quantize_cond(spect_grouped: torch.Tensor, quant: str = "column"):
    """The grouped spect (B, K, G) as `_cond_int8` takes it, once a call:
    its int8 codes channels-last (B, G, K), the kernel's K-major rows,
    and their scale, (B, G) per (batch, position) column (quant="column")
    or one per tensor ("tensor")."""
    quantize = (quantize_per_column_int8 if quant == "column"
                else quantize_per_tensor_int8)
    q, s = quantize(spect_grouped)
    return q.transpose(1, 2).contiguous(), s


def _cond_int8(codes: torch.Tensor, s_scale: torch.Tensor, pk: dict,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The stacked cond projection on the channels-last int8 codes
    (B, G, K) of `quantize_cond`, channels-last (B, G, L*2C): int32
    accumulation, then acc * s_scale * w_scale + bias in f32 (the JAX
    package's order), rounded to out_dtype (ops/cond_int8.py: one kernel
    launch on the card).  s_scale is a scalar (per-tensor) or (B, G)
    (per-column)."""
    with _project_span(codes.transpose(1, 2), pk["wq"].shape[0], "int8",
                       out_dtype.itemsize):
        return cond_int8(codes, s_scale, pk, out_dtype)


def _cond_all(wn: dict, spect_grouped: torch.Tensor,
              cond_int8=None) -> torch.Tensor:
    """All layers' cond projections as ONE stacked (B, L*2C, G) conv over
    the grouped spect, which is constant across the layer loop;
    `cond_int8 = (codes, scale, flow pack)` runs it in int8."""
    if cond_int8 is not None:
        return _cond_int8(*cond_int8, spect_grouped.dtype).transpose(1, 2)
    layers = wn["cond_layers"]
    N = sum(p["weight"].shape[0] for p in layers)
    with _project_span(spect_grouped, N, "dense",
                       spect_grouped.element_size()):
        w = torch.cat([p["weight"] for p in layers], dim=0)
        b = torch.cat([p["bias"] for p in layers], dim=0)
        return conv1d({"weight": w, "bias": b}, spect_grouped)


def fold_wn_tp(wn: dict, group) -> dict:
    """`fold_wn` of this rank's WN channels (the train form cut by the
    paired rule): `in_layers` / `cond_layers` hold whole output channels,
    so their weight norm is local; `res_skip_layers` hold v's input
    channels, so each output channel's ||v|| sums every rank's squares:
    one `reduce_from_model` of every layer's partial sums, and g with the
    norms through one `copy_to_model`, since a rank's use of them reaches
    only its channels' gradients.  w = g * v / ||v||, the norm in f32, as
    `weights._weight_norm_fold`."""
    out = fold_wn({k: v for k, v in wn.items() if k != "res_skip_layers"}
                  | {"res_skip_layers": []})
    rs = wn["res_skip_layers"]
    sq = torch.cat([torch.sum(p["v"].float() ** 2, dim=(1, 2)) for p in rs])
    norm = torch.sqrt(reduce_from_model(sq, group))
    sizes = [p["g"].shape[0] for p in rs]
    g_norm = copy_to_model(torch.cat([torch.cat([p["g"].float() for p in rs]),
                                      norm]), group)
    gs, norms = g_norm.split(sum(sizes))
    for p, g, n in zip(rs, gs.split(sizes), norms.split(sizes)):
        w = g[:, None, None] * p["v"].float() / n[:, None, None]
        out["res_skip_layers"].append({"weight": w.to(p["v"].dtype),
                                       "bias": p["bias"]})
    return out


def _wn_apply_tp(cfg: WaveGlowConfig, wn: dict, audio_half: torch.Tensor,
                 spect_grouped: torch.Tensor, cond_int8, group,
                 in_int8=None, in_int8_quant: str = "column",
                 rs_int8=None) -> torch.Tensor:
    """`wn_apply` on this rank's WN channels (parallel/sharding.py::
    waveglow_param_shardings), the one tensor-parallel coupling net of
    serving and training: the gate is local, each res_skip conv a partial
    sum over the rank's channels, its C residual channels summed over the
    model group per layer (but the last), the skip sum once before `end`;
    the reductions and biases in f32 (or wider), rounded once.  The audio
    entering each in_layer and the grouped spect entering the cond convs
    go through `copy_to_model`, so that `start`'s and the upsampler's
    gradients sum every rank's part.  `in_int8` / `rs_int8` are this
    rank's parts of the WN int8 packs (`tp_shard_wn_int8`)."""
    C = cfg.wn_n_channels
    c = wn["in_layers"][0]["weight"].shape[0] // 2
    audio = conv1d(wn["start"], audio_half)
    cond = _cond_all(wn, copy_to_model(spect_grouped, group), cond_int8)
    acc = torch.promote_types(audio.dtype, torch.float32)
    skip, skip_b = None, 0.0
    for i in range(cfg.wn_n_layers):
        dilation = 2 ** i
        pad = (cfg.wn_kernel_size * dilation - dilation) // 2
        x = copy_to_model(audio, group)
        if in_int8 is not None and cfg.wn_kernel_size == 3:
            in_act = _in_conv_int8(in_int8[i], x, dilation, in_int8_quant)
        else:
            in_act = conv1d(wn["in_layers"][i], x, padding=pad,
                            dilation=dilation)
        in_act = in_act + cond[:, 2 * c * i: 2 * c * (i + 1)]
        acts = torch.tanh(in_act[:, :c]) * torch.sigmoid(in_act[:, c:])
        if rs_int8 is not None:
            part = _rs_int8_product(rs_int8[i], acts).transpose(1, 2)
            bias = rs_int8[i]["rs_bias"].float()
        else:
            rs = wn["res_skip_layers"][i]
            part = F.conv1d(acts, rs["weight"]).to(acc)      # no bias
            bias = rs["bias"].to(acc)
        if i < cfg.wn_n_layers - 1:
            res = reduce_from_model(part[:, :C], group)
            audio = audio + (res + bias[:C, None]).to(audio.dtype)
            part, bias = part[:, C:], bias[C:]
        skip = part if skip is None else skip + part
        skip_b = skip_b + bias
    output = (reduce_from_model(skip, group)
              + skip_b[:, None]).to(audio.dtype)
    return conv1d(wn["end"], output)


def wn_apply(cfg: WaveGlowConfig, wn: dict, audio_half: torch.Tensor,
             spect_grouped: torch.Tensor, cond_int8=None, in_int8=None,
             in_int8_quant: str = "column", rs_int8=None,
             model_group=None) -> torch.Tensor:
    """(B, n_half, T) x (B, 640, T) -> (B, 2*n_half, T), conv formulation.

    `in_int8` / `rs_int8` (this flow's pack_waveglow_wn_int8 entry) run
    the dilated in_layer convs (k=3 only; `in_int8_quant` "column" or
    "tensor") / the res_skip convs on int8 codes, the WN int8 rungs.

    `model_group` (tensor parallelism): `wn` holds this rank's channels
    (parallel/sharding.py), `in_int8` / `rs_int8` this rank's part of
    their packs; the output is every rank's whole one."""
    if model_group is not None:
        return _wn_apply_tp(cfg, wn, audio_half, spect_grouped, cond_int8,
                            model_group, in_int8, in_int8_quant, rs_int8)
    C = cfg.wn_n_channels
    audio = conv1d(wn["start"], audio_half)
    cond = _cond_all(wn, spect_grouped, cond_int8)
    output = None
    for i in range(cfg.wn_n_layers):
        dilation = 2 ** i
        pad = (cfg.wn_kernel_size * dilation - dilation) // 2
        if in_int8 is not None and cfg.wn_kernel_size == 3:
            in_act = _in_conv_int8(in_int8[i], audio, dilation,
                                   in_int8_quant)
        else:
            in_act = conv1d(wn["in_layers"][i], audio, padding=pad,
                            dilation=dilation)
        in_act = in_act + cond[:, 2 * C * i: 2 * C * (i + 1)]
        acts = torch.tanh(in_act[:, :C]) * torch.sigmoid(in_act[:, C:])
        if rs_int8 is not None:
            res_skip = _rs_conv_int8(rs_int8[i], acts)
        else:
            res_skip = conv1d(wn["res_skip_layers"][i], acts)
        if i < cfg.wn_n_layers - 1:
            audio = audio + res_skip[:, :C]
            skip = res_skip[:, C:]
        else:
            skip = res_skip
        output = skip if output is None else output + skip
    return conv1d(wn["end"], output)


def pack_wn_layer(wn: dict) -> dict:
    """One flow's WN params -> the channels-last form of wn_apply_layer.
    A bf16 pack at the wgmma tile's width (C = 256) also holds the layer
    kernel's weight image, `in_img` (L, 3C/KC, 2C, KC) and `rs_img`
    (L, C/KC, 2C, KC) (ops/wn_layer.layer_images), built once here."""
    c = lambda t: t.contiguous()  # noqa: E731
    packed = {
        "start_w": c(wn["start"]["weight"][:, :, 0].T),
        "start_b": wn["start"]["bias"],
        "cond_w": c(torch.cat([p["weight"] for p in wn["cond_layers"]],
                              dim=0)[:, :, 0].T),
        "cond_b": torch.cat([p["bias"] for p in wn["cond_layers"]], dim=0),
        "in_w": [c(pack_in_weight(p["weight"])) for p in wn["in_layers"]],
        "in_b": [c(p["bias"]) for p in wn["in_layers"]],
        "rs_w": [c(p["weight"][:, :, 0].T) for p in wn["res_skip_layers"]],
        "rs_b": [c(p["bias"]) for p in wn["res_skip_layers"]],
        "end_w": c(wn["end"]["weight"][:, :, 0].T),
        "end_b": wn["end"]["bias"],
    }
    w_in = packed["in_w"][0]
    if w_in.dtype == torch.bfloat16 and w_in.shape[1] // 2 == KERNEL_C:
        packed.update(layer_images(packed["in_w"], packed["rs_w"]))
    return packed


def pack_waveglow_layer(cfg: WaveGlowConfig, params: dict) -> list:
    """Every flow's channels-last pack, computed once outside the call."""
    if cfg.wn_kernel_size != 3:
        raise ValueError("the WN layer kernel needs wn_kernel_size=3, got "
                         f"{cfg.wn_kernel_size}")
    return [pack_wn_layer(wn) for wn in params["wn"]]


def wn_apply_layer(cfg: WaveGlowConfig, packed: dict,
                   audio_half: torch.Tensor,
                   spect_grouped: torch.Tensor) -> torch.Tensor:
    """`wn_apply` on the WN layer kernel, channels-last inside.

    The kernel reads zeros outside [0, T) itself, so time needs no tile
    padding and the residual stream no re-masking between layers."""
    C, L = cfg.wn_n_channels, cfg.wn_n_layers
    dt = audio_half.dtype
    x = _dense(audio_half.transpose(1, 2), packed["start_w"],
               packed["start_b"], dt).contiguous()
    with _project_span(spect_grouped, packed["cond_w"].shape[1], "dense",
                       spect_grouped.element_size()):
        cond = _dense(spect_grouped.transpose(1, 2), packed["cond_w"],
                      packed["cond_b"], dt)                 # (B, T, L*2C)
    img = "in_img" in packed
    skip_sum = None
    for i in range(L):
        x, skip = wn_layer(
            x, cond[:, :, 2 * C * i: 2 * C * (i + 1)],
            packed["in_w"][i], packed["in_b"][i],
            packed["rs_w"][i], packed["rs_b"][i],
            dilation=2 ** i, last=(i == L - 1),
            in_img=packed["in_img"][i] if img else None,
            rs_img=packed["rs_img"][i] if img else None,
        )
        skip_sum = skip if skip_sum is None else skip_sum + skip
    out = _dense(skip_sum, packed["end_w"], packed["end_b"], dt)
    return out.transpose(1, 2)


def pack_waveglow_flow(cfg: WaveGlowConfig, params: dict,
                       dtype: Optional[torch.dtype] = None) -> list:
    """Every flow's whole-net kernel pack (ops/wn_flow.pack_wn_flow), plus
    its stacked cond projection `cond_w` (n_mel*n_group, L*2C) and
    `cond_b`, computed once outside the call.  `dtype` casts the matmul
    weights (bf16 serving); biases stay f32."""
    if cfg.wn_kernel_size != 3:
        raise ValueError("the WN flow kernel needs wn_kernel_size=3, got "
                         f"{cfg.wn_kernel_size}")
    packs = []
    for wn in params["wn"]:
        pk = pack_wn_flow(wn, dtype)
        cond_w = torch.cat([p["weight"] for p in wn["cond_layers"]], dim=0)
        pk["cond_w"] = cond_w[:, :, 0].T.to(pk["w_in"].dtype).contiguous()
        pk["cond_b"] = torch.cat([p["bias"] for p in wn["cond_layers"]],
                                 dim=0).float()
        packs.append(pk)
    return packs


def wn_apply_flow(cfg: WaveGlowConfig, packed: dict,
                  audio_half: torch.Tensor, spect_grouped: torch.Tensor,
                  cond_int8=None) -> torch.Tensor:
    """`wn_apply` as ONE launch of the whole-net kernel (ops/wn_flow.py).
    The stacked cond projection, dense or int8, is computed here,
    channels-last; the kernel reads zeros outside [0, T) itself, so
    nothing is padded."""
    dt = audio_half.dtype
    if cond_int8 is None:
        with _project_span(spect_grouped, packed["cond_w"].shape[1],
                           "dense", spect_grouped.element_size()):
            cond = _dense(spect_grouped.transpose(1, 2), packed["cond_w"],
                          packed["cond_b"], dt)             # (B, T, L*2C)
    else:
        cond = _cond_int8(*cond_int8, dt)
    return wn_flow(packed, audio_half.contiguous(), cond)


# ==========================================================================
# forward (training)
# ==========================================================================

def _flow_forward(cfg: WaveGlowConfig, w: torch.Tensor, wn: dict,
                  audio_g: torch.Tensor, spect_g: torch.Tensor,
                  model_group=None):
    """One flow: the 1x1 conv (its log-determinant in f32 whatever the
    dtype), then the affine coupling on the folded net (this rank's
    channels under `model_group`)."""
    n_half = audio_g.shape[1] // 2
    logdet = torch.linalg.slogdet(w.float())[1]
    mixed = torch.einsum("oc,bct->bot", w.float(),
                         audio_g.float()).to(audio_g.dtype)
    audio_0, audio_1 = mixed[:, :n_half], mixed[:, n_half:]
    if model_group is None:
        wn_out = wn_apply(cfg, fold_wn(wn), audio_0, spect_g)
    else:
        wn_out = wn_apply(cfg, fold_wn_tp(wn, model_group), audio_0,
                          spect_g, model_group=model_group)
    log_s, b = wn_out[:, n_half:], wn_out[:, :n_half]
    audio_1 = torch.exp(log_s) * audio_1 + b
    return torch.cat([audio_0, audio_1], dim=1), log_s, logdet


def waveglow_forward(cfg: WaveGlowConfig, params, spect: torch.Tensor,
                     audio: torch.Tensor, remat: bool = False,
                     model_group=None):
    """((B, 80, F) mel, (B, T) audio) -> (z, log_s_list, log_det_w_list)
    (reference glow.py:215-250; JAX `models/waveglow.py:703-778`).

    `params` is the train form (weight_norm_params).  `remat=True` runs
    each flow under torch.utils.checkpoint: the backward pass recomputes
    the flow's WN activations instead of keeping them.  The grouped spect
    comes straight from the upsampler's phases (upsample_grouped; the JAX
    package's `grouped_upsample=True`, whose values its False path shares
    bit for bit).  `model_group` (tensor parallelism): `params["wn"]` are
    this rank's channels (`waveglow_param_shardings` on the train form),
    the rest whole; the outputs are whole on every rank."""
    T = audio.shape[1]
    spect_g = upsample_grouped(params["upsample"], spect, cfg.hop_length,
                               cfg.n_group, t_samples=T)
    audio_g = group_audio(audio, cfg.n_group)
    B, _, G = audio_g.shape
    chunks, log_s_list, log_det_list = [], [], []
    for k in range(cfg.n_flows):
        if k % cfg.n_early_every == 0 and k > 0:
            chunks.append(audio_g[:, :cfg.n_early_size])
            audio_g = audio_g[:, cfg.n_early_size:]
        args = (cfg, params["convinv"][k]["weight"], params["wn"][k],
                audio_g, spect_g, model_group)
        if remat:
            audio_g, log_s, logdet = checkpoint(
                _flow_forward, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            audio_g, log_s, logdet = _flow_forward(*args)
        log_det_list.append(B * G * logdet)
        log_s_list.append(log_s)
    chunks.append(audio_g)
    return torch.cat(chunks, dim=1), log_s_list, log_det_list


# ==========================================================================
# inference
# ==========================================================================

# The JAX package's names of the coupling-net implementations, each mapped
# to the port's: "xla" (its conv formulation) to "conv", "pallas" (its WN
# layer kernel) to "layer"; "flow" is the same word in both.
WN_IMPL_ALIASES = {"xla": "conv", "pallas": "layer"}
WN_IMPLS = ("conv", "layer", "flow")


def resolve_wn_impl(name: str) -> str:
    """A coupling-net implementation's name, the JAX package's or the
    port's -> the port's ("conv", "layer" or "flow")."""
    name = WN_IMPL_ALIASES.get(name, name)
    if name not in WN_IMPLS:
        raise ValueError(f"unknown wn_impl {name!r}: one of "
                         f"{list(WN_IMPLS) + list(WN_IMPL_ALIASES)}")
    return name


def waveglow_noise(cfg: WaveGlowConfig, B: int, G: int,
                   generator: Optional[torch.Generator], device) -> list:
    """The unit-variance draws `waveglow_serve` takes from `generator` for
    a batch of B rows of G groups, in its order (its `noise=` form): the
    (B, n_remaining, G) seed, then one (B, n_early_size, G) chunk per
    early output, k descending.  A data-parallel rank draws the global
    batch's and takes its rows, so it equals the one-process call."""
    out = [torch.randn((B, flow_channels(cfg)[-1], G), generator=generator,
                       device=device)]
    out += [torch.randn((B, cfg.n_early_size, G), generator=generator,
                        device=device)
            for k in reversed(range(cfg.n_flows))
            if k % cfg.n_early_every == 0 and k > 0]
    return out


def check_serving(cfg: WaveGlowConfig, wn_impl: str,
                  cond_impl: str = "dense", cond_quant: str = "column",
                  wn_int8_flows: int = 0, wn_int8_rs_flows: int = 0,
                  wn_int8_quant: str = "column", model: int = 1) -> None:
    """Raises ValueError unless the port serves this combination of
    `serving_form`'s options (`model`: the mesh's model axis), the one
    place they are checked; a CLI runs it on its options before it loads
    anything."""
    if model > 1 and wn_impl != "conv":
        raise ValueError(
            f"model_parallel > 1 runs the conv formulation (--wn_impl "
            f"conv, the JAX package's 'xla'), not wn_impl={wn_impl!r}: "
            f"the hand kernels take whole channels")
    if wn_impl not in WN_IMPLS:
        raise ValueError(f"unknown wn_impl {wn_impl!r}")
    if cond_impl not in ("dense", "int8"):
        raise ValueError(f"unknown cond_impl {cond_impl!r}")
    if cond_quant not in ("column", "tensor"):
        raise ValueError(f"unknown cond_quant {cond_quant!r}")
    if cond_impl == "int8" and wn_impl == "layer":
        raise ValueError("cond_impl='int8' requires --wn_impl flow or conv "
                         "(xla): the WN layer kernel takes the dense cond")
    if wn_int8_quant not in ("column", "tensor"):
        raise ValueError(f"unknown wn_int8_quant {wn_int8_quant!r}")
    if wn_int8_flows or wn_int8_rs_flows:
        if wn_impl != "conv":
            raise ValueError("--wn_int8_flows / --wn_int8_rs_flows: "
                             "wn_int8_flows/rs requires wn_impl='xla' (the "
                             "port's 'conv')")
        if wn_int8_flows and cfg.wn_kernel_size != 3:
            raise ValueError("wn_int8_flows supports wn_kernel_size=3 "
                             f"only, got {cfg.wn_kernel_size}")


@dataclasses.dataclass(frozen=True)
class WaveGlowServing:
    """WaveGlow's serving form (`serving_form`).  `params` are the cast
    weights; `wn` is each flow's coupling net as `wn_impl` takes it: the
    layer or flow kernel's pack, or the conv formulation's WN params
    (this rank's channels under TP, whose group is `model_group`);
    `cluster` is the flow kernel's cluster size (0: none runs), which
    each `waveglow.coupling` span reports."""
    cfg: WaveGlowConfig
    params: dict
    dtype: Optional[torch.dtype]
    wn_impl: str
    wn: list
    cond_impl: str
    cond_quant: str
    packed_cond: Optional[list]
    wn_int8_flows: int
    wn_int8_rs_flows: int
    wn_int8_quant: str
    packed_wn_int8: Optional[list]
    model_group: object
    cluster: int


def serving_form(cfg: WaveGlowConfig, params, *,
                 dtype: Optional[torch.dtype] = None,
                 wn_impl: str = "layer",
                 packed_wn: Optional[list] = None,
                 cond_impl: str = "dense",
                 packed_cond: Optional[list] = None,
                 cond_quant: str = "column",
                 wn_int8_flows: int = 0,
                 packed_wn_int8: Optional[list] = None,
                 wn_int8_quant: str = "column",
                 wn_int8_rs_flows: int = 0, mesh=None) -> WaveGlowServing:
    """The one way to serve WaveGlow, built once: `params` (the
    remove_weightnorm form) checked with the options (`check_serving`),
    cast once to `dtype` and packed for `wn_impl`.  A pack given is used
    as it is; a missing one is built here.  The int8 packs are made from
    `params` as given, before the cast: the f32 params give the f32
    weights' codes, as every serving caller packs them, while
    `waveglow_infer(dtype=)` casts first, so its packs hold the cast
    weights' codes, as the JAX package's do.

    `dtype=torch.bfloat16` runs the flows in bf16 with f32 matmul
    accumulation; the 1x1 inverses stay f32 (the reference's fp16 mode
    likewise, inference.py:38-41).

    `wn_impl`: "layer" (the WN layer kernel; `packed_wn` from
    pack_waveglow_layer), "flow" (the whole-net kernel, one launch per
    flow; `packed_wn` from pack_waveglow_flow) or "conv".

    `cond_impl="int8"` (conv and flow) runs the stacked cond projections
    on int8 codes: the grouped spect is quantized once per call, per
    (batch, position) column (`cond_quant="tensor"`: one scale), the
    weights per out channel (`packed_cond` from pack_waveglow_int8cond).
    Lossy: gate it on a measured SNR (eval/int8_snr.select_cond_impl).

    The WN int8 rungs (conv only, the JAX package's xla): `wn_int8_flows=n`
    runs the dilated in_layer convs of the n narrowest flows (k < n, the
    last run) on int8 codes (k=3 only; `wn_int8_quant` "column" or
    "tensor"), `wn_int8_rs_flows=n` their res_skip convs; `packed_wn_int8`
    from pack_waveglow_wn_int8.  Lossy, and the error feeds back through
    the later flows: measure eval/int8_snr.run_ladder(include_wn_int8=True)
    first.

    `mesh` with a model axis above 1 (parallel/mesh.py) runs tensor
    parallel on the conv formulation (`wn_impl` "layer" / "flow" raise):
    `packed_wn` is this rank's WN params (`tp_shard_waveglow`),
    `packed_cond` its int8 rows (`tp_shard_int8cond`), `packed_wn_int8`
    its part of the WN int8 packs (`tp_shard_wn_int8`), each cut here
    when absent, the other params whole."""
    model = 1 if mesh is None else mesh.shape["model"]
    check_serving(cfg, wn_impl, cond_impl, cond_quant, wn_int8_flows,
                  wn_int8_rs_flows, wn_int8_quant, model)
    tp = model > 1
    if cond_impl == "int8" and packed_cond is None:
        packed_cond = pack_waveglow_int8cond(cfg, params)
        if tp:
            packed_cond = tp_shard_int8cond(cfg, packed_cond, mesh)
    if (wn_int8_flows or wn_int8_rs_flows) and packed_wn_int8 is None:
        packed_wn_int8 = pack_waveglow_wn_int8(cfg, params)
        if tp:
            packed_wn_int8 = tp_shard_wn_int8(packed_wn_int8, mesh)
    serve = params if dtype is None else cast_params(params, dtype)
    if tp:
        wn = (packed_wn if packed_wn is not None
              else tp_shard_waveglow(serve, mesh))["wn"]
    elif wn_impl == "conv":
        wn = serve["wn"]
    elif packed_wn is not None:
        wn = packed_wn
    else:
        pack = pack_waveglow_flow if wn_impl == "flow" else \
            pack_waveglow_layer
        wn = pack(cfg, serve)
    cluster = 0
    if wn_impl == "flow":
        w = wn[0]["w_in"]
        cluster = cluster_size(w.dtype, cfg.wn_n_channels, w.device)
    return WaveGlowServing(
        cfg, serve, dtype, wn_impl, wn, cond_impl, cond_quant, packed_cond,
        wn_int8_flows, wn_int8_rs_flows, wn_int8_quant, packed_wn_int8,
        mesh.model_group if tp else None, cluster)


def _coupling(form: WaveGlowServing):
    """The coupling net of `form`, chosen once a call:
    (flow k, audio half, grouped spect, int8 cond or None) -> WN output."""
    cfg, wn, wn8 = form.cfg, form.wn, form.packed_wn_int8
    if form.wn_impl == "layer":
        return lambda k, x, s, c8: wn_apply_layer(cfg, wn[k], x, s)
    if form.wn_impl == "flow":
        return lambda k, x, s, c8: wn_apply_flow(cfg, wn[k], x, s, c8)
    return lambda k, x, s, c8: wn_apply(
        cfg, wn[k], x, s, c8,
        in_int8=wn8[k] if k < form.wn_int8_flows else None,
        in_int8_quant=form.wn_int8_quant,
        rs_int8=wn8[k] if k < form.wn_int8_rs_flows else None,
        model_group=form.model_group)


def waveglow_serve(form: WaveGlowServing, spect: torch.Tensor,
                   sigma: float,
                   generator: Optional[torch.Generator] = None,
                   noise=None) -> torch.Tensor:
    """(B, 80, F) mel -> (B, F*hop) audio (reference glow.py:252-293) on
    the serving form `form`, the spect cast to its dtype; nothing is
    cast or packed here.  The grouped spect comes straight from the
    upsampler's phases (upsample_grouped; the JAX package's
    `grouped_upsample=True`, whose values its False path shares bit for
    bit).

    `noise` injects the unit-variance draws, in `waveglow_noise`'s order
    (glow.py:261-268, 284-289), instead of sampling them from `generator`;
    each is scaled by `sigma` here.  Under tensor
    parallelism every rank of the model group draws the same noise (equal
    generators) and returns the whole audio."""
    cfg, params = form.cfg, form.params
    B, F_ = spect.shape[0], spect.shape[2]
    with span("waveglow.infer", spect.device, B=B,
              G=F_ * cfg.hop_length // cfg.n_group, flows=cfg.n_flows):
        if form.dtype is not None:
            spect = spect.to(form.dtype)
        dev = spect.device
        with span("waveglow.upsample", dev, B=B, frames=F_):
            spect_g = upsample_grouped(params["upsample"], spect,
                                       cfg.hop_length, cfg.n_group)
        dt = spect_g.dtype
        B, K, G = spect_g.shape
        if noise is None:
            noise = waveglow_noise(cfg, B, G, generator, dev)
        noise_iter = iter(noise)

        def draw():
            return torch.as_tensor(next(noise_iter), dtype=torch.float32,
                                   device=dev)

        audio = (sigma * draw()).to(dt)
        coupling = _coupling(form)
        cond_q = None
        if form.cond_impl == "int8":
            # the spect is constant across flows: quantized once per call
            with span("waveglow.cond.quantize", dev, M=B * G, K=K,
                      esz=spect_g.element_size()):
                cond_q = quantize_cond(spect_g, form.cond_quant)

        for k in reversed(range(cfg.n_flows)):
            n_half = audio.shape[1] // 2
            c8 = None if cond_q is None else (*cond_q, form.packed_cond[k])
            with span("waveglow.coupling", dev, B=B, T=G, n_half=n_half,
                      C=cfg.wn_n_channels, L=cfg.wn_n_layers,
                      esz=audio.element_size(), cluster=form.cluster):
                audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
                wn_out = coupling(k, audio_0, spect_g, c8)
                s, b = wn_out[:, n_half:], wn_out[:, :n_half]
                audio_1 = (audio_1 - b) * torch.exp(-s)
                audio = torch.cat([audio_0, audio_1], dim=1)

            with span("waveglow.inverse", dev, B=B, T=G, c=audio.shape[1]):
                conv = params["convinv"][k]
                w_inv = conv.get("weight_inverse")
                if w_inv is None:
                    w_inv = torch.linalg.inv(conv["weight"].float())
                audio = torch.einsum("oc,bct->bot", w_inv.float(),
                                     audio.float()).to(dt)
                if k % cfg.n_early_every == 0 and k > 0:
                    z = (sigma * draw()).to(dt)
                    audio = torch.cat([z, audio], dim=1)
        return ungroup_audio(audio)


def waveglow_infer(cfg: WaveGlowConfig, params, spect: torch.Tensor,
                   sigma: float,
                   generator: Optional[torch.Generator] = None,
                   dtype: Optional[torch.dtype] = None, noise=None,
                   wn_impl: str = "layer",
                   packed_wn: Optional[list] = None,
                   cond_impl: str = "dense",
                   packed_cond: Optional[list] = None,
                   cond_quant: str = "column",
                   wn_int8_flows: int = 0,
                   packed_wn_int8: Optional[list] = None,
                   wn_int8_quant: str = "column",
                   wn_int8_rs_flows: int = 0, mesh=None) -> torch.Tensor:
    """The JAX package's `waveglow_infer`: `waveglow_serve` on a
    `serving_form` built for this call alone, with its options; a caller
    that serves more than once builds the form once.  `dtype` casts
    `params` before the form is built, so an int8 pack made here holds
    the cast weights' codes."""
    if dtype is not None:
        params = cast_params(params, dtype)
    form = serving_form(
        cfg, params, dtype=dtype, wn_impl=wn_impl, packed_wn=packed_wn,
        cond_impl=cond_impl, packed_cond=packed_cond, cond_quant=cond_quant,
        wn_int8_flows=wn_int8_flows, packed_wn_int8=packed_wn_int8,
        wn_int8_quant=wn_int8_quant, wn_int8_rs_flows=wn_int8_rs_flows,
        mesh=mesh)
    return waveglow_serve(form, spect, sigma, generator, noise)
