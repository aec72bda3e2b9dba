"""WaveGlow normalizing-flow vocoder, inference only (torch).

The port of fac_via_ppg_tpu/models/waveglow.py (reference
src/waveglow/glow.py:62-311).  Parameters are the JAX package's
dictionaries in their folded form (weight-norm g/v already folded;
`weights.py` converts), layouts torch's: Conv1d (out, in, k),
ConvTranspose1d (in, out, k).  Layouts at the public functions follow the
JAX package: channels-first (B, C, T).

Two coupling-net implementations:
  * `wn_apply` -- the conv formulation (the JAX package's wn_impl="xla").
  * `wn_apply_layer` -- channels-last on the hand-written WN layer kernel
    (ops/wn_layer.py; the JAX package's wn_impl="pallas").  The start
    conv, the stacked cond projection and the end conv are plain matmuls,
    as the JAX package computes them outside its kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.ops.layers import conv1d
from fac_via_ppg_torch.ops.wn_layer import wn_layer


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

def upsample_phase_matmul(p: dict, spect: torch.Tensor,
                          hop: int) -> torch.Tensor:
    """ConvTranspose1d(k, stride=hop) as one phase-decomposed matmul:

        out[b, q*hop + r, o] = sum_{j, i} spect[b, q - j, i] * W[i, o, j*hop + r]

    with J = ceil(k / hop) shifted copies of the mel frames.  Yields
    exactly F*hop samples, i.e. the reference's artifact cutoff (k - hop)
    is built in (glow.py:254-256).  (B, C_in, F) -> (B, C_out, F*hop)."""
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
    out = (out + p["bias"].float()).to(spect.dtype)
    return out.reshape(B, F_ * hop, c_out).transpose(1, 2)


def group_spect(spect_up: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, M, T_samp) -> (B, M*n_group, T_samp/n_group), mel-major per group
    (reference glow.py:221-222)."""
    B, M, T = spect_up.shape
    G = T // n_group
    x = spect_up[:, :, :G * n_group].reshape(B, M, G, n_group)
    return x.permute(0, 2, 1, 3).reshape(B, G, M * n_group).transpose(1, 2)


def ungroup_audio(audio: torch.Tensor) -> torch.Tensor:
    """(B, n_group, G) -> (B, T) (reference glow.py:292)."""
    return audio.transpose(1, 2).reshape(audio.shape[0], -1)


# ==========================================================================
# WN coupling network
# ==========================================================================

def _cond_all(wn: dict, spect_grouped: torch.Tensor) -> torch.Tensor:
    """All layers' cond projections as ONE stacked (B, L*2C, G) conv over
    the grouped spect, which is constant across the layer loop."""
    w = torch.cat([p["weight"] for p in wn["cond_layers"]], dim=0)
    b = torch.cat([p["bias"] for p in wn["cond_layers"]], dim=0)
    return conv1d({"weight": w, "bias": b}, spect_grouped)


def wn_apply(cfg: WaveGlowConfig, wn: dict, audio_half: torch.Tensor,
             spect_grouped: torch.Tensor) -> torch.Tensor:
    """(B, n_half, T) x (B, 640, T) -> (B, 2*n_half, T), conv formulation."""
    C = cfg.wn_n_channels
    audio = conv1d(wn["start"], audio_half)
    cond = _cond_all(wn, spect_grouped)
    output = None
    for i in range(cfg.wn_n_layers):
        dilation = 2 ** i
        pad = (cfg.wn_kernel_size * dilation - dilation) // 2
        in_act = (conv1d(wn["in_layers"][i], audio, padding=pad,
                         dilation=dilation)
                  + cond[:, 2 * C * i: 2 * C * (i + 1)])
        acts = torch.tanh(in_act[:, :C]) * torch.sigmoid(in_act[:, C:])
        res_skip = conv1d(wn["res_skip_layers"][i], acts)
        if i < cfg.wn_n_layers - 1:
            audio = audio + res_skip[:, :C]
            skip = res_skip[:, C:]
        else:
            skip = res_skip
        output = skip if output is None else output + skip
    return conv1d(wn["end"], output)


def pack_in_weight(conv_weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight (2C, C, 3) -> tap-stacked matmul form (3C, 2C):
    tap j multiplies x[t + (j-1)*d]."""
    return torch.cat([conv_weight[:, :, j].T
                      for j in range(conv_weight.shape[2])], dim=0)


def pack_wn_layer(wn: dict) -> dict:
    """One flow's WN params -> the channels-last form of wn_apply_layer."""
    c = lambda t: t.contiguous()  # noqa: E731
    return {
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
    cond = _dense(spect_grouped.transpose(1, 2), packed["cond_w"],
                  packed["cond_b"], dt)                     # (B, T, L*2C)
    skip_sum = None
    for i in range(L):
        x, skip = wn_layer(
            x, cond[:, :, 2 * C * i: 2 * C * (i + 1)],
            packed["in_w"][i], packed["in_b"][i],
            packed["rs_w"][i], packed["rs_b"][i],
            dilation=2 ** i, last=(i == L - 1),
        )
        skip_sum = skip if skip_sum is None else skip_sum + skip
    out = _dense(skip_sum, packed["end_w"], packed["end_b"], dt)
    return out.transpose(1, 2)


# ==========================================================================
# inference
# ==========================================================================

def waveglow_infer(cfg: WaveGlowConfig, params, spect: torch.Tensor,
                   sigma: float,
                   generator: Optional[torch.Generator] = None,
                   dtype: Optional[torch.dtype] = None, noise=None,
                   wn_impl: str = "layer",
                   packed_wn: Optional[list] = None) -> torch.Tensor:
    """(B, 80, F) mel -> (B, F*hop) audio (reference glow.py:252-293).

    `dtype=torch.bfloat16` runs the flows in bf16 with f32 matmul
    accumulation; the 1x1 inverses stay f32 (the reference's fp16 mode
    likewise, inference.py:38-41).

    `noise` injects the unit-variance gaussian draws instead of sampling
    from `generator`: first the (B, n_remaining, G) seed (glow.py:261-268),
    then one (B, n_early_size, G) chunk per early output, k descending
    (glow.py:284-289).  Each is scaled by `sigma` here.

    `wn_impl`: "layer" (the WN layer kernel; `packed_wn` from
    pack_waveglow_layer keeps packing out of the call) or "conv".
    """
    if wn_impl not in ("layer", "conv"):
        raise ValueError(f"unknown wn_impl {wn_impl!r}")
    if dtype is not None:
        params = cast_params(params, dtype)
        spect = spect.to(dtype)
    dev = spect.device
    spect_g = group_spect(
        upsample_phase_matmul(params["upsample"], spect, cfg.hop_length),
        cfg.n_group)
    dt = spect_g.dtype
    B, _, G = spect_g.shape
    noise_iter = iter(noise) if noise is not None else None

    def draw(shape):
        if noise_iter is not None:
            return torch.as_tensor(next(noise_iter), dtype=torch.float32,
                                   device=dev)
        return torch.randn(shape, generator=generator, device=dev)

    audio = (sigma * draw((B, flow_channels(cfg)[-1], G))).to(dt)
    packed = None
    if wn_impl == "layer":
        packed = packed_wn or pack_waveglow_layer(cfg, params)

    for k in reversed(range(cfg.n_flows)):
        n_half = audio.shape[1] // 2
        audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
        if packed is not None:
            wn_out = wn_apply_layer(cfg, packed[k], audio_0, spect_g)
        else:
            wn_out = wn_apply(cfg, params["wn"][k], audio_0, spect_g)
        s, b = wn_out[:, n_half:], wn_out[:, :n_half]
        audio_1 = (audio_1 - b) * torch.exp(-s)
        audio = torch.cat([audio_0, audio_1], dim=1)

        conv = params["convinv"][k]
        w_inv = conv.get("weight_inverse")
        if w_inv is None:
            w_inv = torch.linalg.inv(conv["weight"].float())
        audio = torch.einsum("oc,bct->bot", w_inv.float(),
                             audio.float()).to(dt)
        if k % cfg.n_early_every == 0 and k > 0:
            z = (sigma * draw((B, cfg.n_early_size, G))).to(dt)
            audio = torch.cat([z, audio], dim=1)
    return ungroup_audio(audio)
