"""Writes the port's parameter trees as the reference's torch checkpoints
(the port of fac_via_ppg_tpu/train/export_torch.py), the inverse of
train/import_torch:

  * Tacotron2: `save_reference_tacotron2_checkpoint` writes the reference's
    {'iteration', 'state_dict', 'optimizer', 'learning_rate'} `.pt`
    (train_ppg2mel.py:143-149), which `utils/inference.load_tacotron2_model`
    and the JAX package's loader read.
  * WaveGlow: `export_waveglow_state_dict`; `torch.save` of it is a
    checkpoint that `utils/inference.load_waveglow_model` reads.  And the
    reference's own pickled-module format, {'model': <nn.Module>,
    'iteration', 'optimizer', 'learning_rate'} (train_waveglow.py:56-64):
    `save_reference_waveglow_checkpoint` loads the state dict into a
    structural twin (`build_waveglow_module`) whose classes are named
    glow.WaveGlow / glow.WN / glow.Invertible1x1Conv, the path the
    reference's checkpoints record, so the reference loads it directly;
    both packages' loaders read it too.
"""

from __future__ import annotations

import contextlib
import sys
import types
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.models.waveglow import flow_channels


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()


def export_waveglow_state_dict(params: dict,
                               cfg: WaveGlowConfig) -> "OrderedDict":
    """params -> torch state_dict with the reference's keys, in weight-norm
    (weight_g / weight_v) or folded form, whichever the params hold.  The
    cached 1x1 inverses are not part of the format and are dropped."""
    sd = OrderedDict()

    def wn_conv(prefix, p):
        if "g" in p:
            sd[f"{prefix}.bias"] = _t(p["bias"])
            sd[f"{prefix}.weight_g"] = _t(p["g"]).reshape(-1, 1, 1)
            sd[f"{prefix}.weight_v"] = _t(p["v"])
        else:
            sd[f"{prefix}.weight"] = _t(p["weight"])
            sd[f"{prefix}.bias"] = _t(p["bias"])

    sd["upsample.weight"] = _t(params["upsample"]["weight"])
    sd["upsample.bias"] = _t(params["upsample"]["bias"])
    for k in range(cfg.n_flows):
        sd[f"convinv.{k}.conv.weight"] = \
            _t(params["convinv"][k]["weight"])[:, :, None]
        wn = params["wn"][k]
        wn_conv(f"WN.{k}.start", wn["start"])
        sd[f"WN.{k}.end.weight"] = _t(wn["end"]["weight"])
        sd[f"WN.{k}.end.bias"] = _t(wn["end"]["bias"])
        for i in range(cfg.wn_n_layers):
            wn_conv(f"WN.{k}.in_layers.{i}", wn["in_layers"][i])
            wn_conv(f"WN.{k}.cond_layers.{i}", wn["cond_layers"][i])
            wn_conv(f"WN.{k}.res_skip_layers.{i}", wn["res_skip_layers"][i])
    return sd


_TWIN_GLOW: Optional[types.ModuleType] = None


def _twin_glow_module() -> types.ModuleType:
    """Classes named glow.WaveGlow / glow.WN / glow.Invertible1x1Conv, so
    the pickled module resolves to the reference's own classes where its
    glow is on sys.path at load time."""
    global _TWIN_GLOW
    if _TWIN_GLOW is None:
        mod = types.ModuleType("glow")
        for name in ("WaveGlow", "WN", "Invertible1x1Conv"):
            setattr(mod, name,
                    type(name, (nn.Module,), {"__module__": "glow"}))
        _TWIN_GLOW = mod
    return _TWIN_GLOW


def build_waveglow_module(cfg: WaveGlowConfig,
                          weight_norm: bool = True) -> nn.Module:
    """An nn.Module with the reference WaveGlow's exact submodule layout
    (glow.py:178-206), ready for load_state_dict and pickling; its WN convs
    carry torch.nn.utils.weight_norm (weight_g / weight_v) when
    `weight_norm`."""
    glow = _twin_glow_module()
    model = glow.WaveGlow()
    model.n_flows = cfg.n_flows
    model.n_group = cfg.n_group
    model.n_early_every = cfg.n_early_every
    model.n_early_size = cfg.n_early_size
    model.upsample = nn.ConvTranspose1d(
        cfg.n_mel_channels, cfg.n_mel_channels, cfg.upsample_kernel_size,
        stride=cfg.hop_length)
    model.WN = nn.ModuleList()
    model.convinv = nn.ModuleList()
    chans = flow_channels(cfg)
    cond_ch = cfg.n_mel_channels * cfg.n_group
    C = cfg.wn_n_channels

    def wn_norm(conv):
        return nn.utils.weight_norm(conv, name="weight") if weight_norm \
            else conv

    for k in range(cfg.n_flows):
        inv = glow.Invertible1x1Conv()
        inv.conv = nn.Conv1d(chans[k], chans[k], 1, bias=False)
        model.convinv.append(inv)

        n_half = chans[k] // 2
        wn = glow.WN()
        wn.n_layers = cfg.wn_n_layers
        wn.n_channels = C
        wn.start = wn_norm(nn.Conv1d(n_half, C, 1))
        wn.end = nn.Conv1d(C, 2 * n_half, 1)
        wn.in_layers = nn.ModuleList()
        wn.cond_layers = nn.ModuleList()
        wn.res_skip_layers = nn.ModuleList()
        for i in range(cfg.wn_n_layers):
            dilation = 2 ** i
            pad = (cfg.wn_kernel_size * dilation - dilation) // 2
            wn.in_layers.append(wn_norm(nn.Conv1d(
                C, 2 * C, cfg.wn_kernel_size, dilation=dilation,
                padding=pad)))
            wn.cond_layers.append(wn_norm(nn.Conv1d(cond_ch, 2 * C, 1)))
            res_ch = 2 * C if i < cfg.wn_n_layers - 1 else C
            wn.res_skip_layers.append(wn_norm(nn.Conv1d(C, res_ch, 1)))
        model.WN.append(wn)
    model.n_remaining_channels = chans[-1]
    return model


@contextlib.contextmanager
def _pickle_as_glow():
    """The twin classes as sys.modules['glow'] while torch.save runs
    (pickle checks a class's identity at save time), and only then."""
    prev = sys.modules.get("glow")
    sys.modules["glow"] = _twin_glow_module()
    try:
        yield
    finally:
        if prev is not None:
            sys.modules["glow"] = prev
        else:
            del sys.modules["glow"]


def save_reference_waveglow_checkpoint(
    path: str, params: dict, cfg: WaveGlowConfig,
    iteration: int = 0, learning_rate: float = 1e-4,
    optimizer_state: Optional[dict] = None, module: Optional[nn.Module] = None,
):
    """Write the reference's pickled-module checkpoint
    (train_waveglow.py:56-64).  Weight norm is on where the params hold
    (g, v) pairs.  `module`: a reference-layout module to load the weights
    into (the real glow.WaveGlow where the reference is importable); by
    default the structural twin."""
    sd = export_waveglow_state_dict(params, cfg)
    if module is None:
        module = build_waveglow_module(
            cfg, weight_norm=any("weight_g" in k for k in sd))
    module.load_state_dict(sd)
    payload = {
        "model": module,
        "iteration": int(iteration),
        "optimizer": optimizer_state if optimizer_state is not None else {},
        "learning_rate": float(learning_rate),
    }
    # the twin is installed as 'glow' only for the twin: a caller's real
    # glow module keeps resolving to its own classes
    if type(module) is _twin_glow_module().WaveGlow:
        with _pickle_as_glow():
            torch.save(payload, path)
    else:
        torch.save(payload, path)


def export_tacotron2_state_dict(params: dict, model_state: dict,
                                cfg: Tacotron2Config) -> "OrderedDict":
    """(params, model_state) -> the torch state_dict the reference loads."""
    sd = OrderedDict()

    def linear(prefix, p):
        sd[f"{prefix}.linear_layer.weight"] = _t(p["weight"])
        if "bias" in p:
            sd[f"{prefix}.linear_layer.bias"] = _t(p["bias"])

    def conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = _t(p["weight"])
        if "bias" in p:
            sd[f"{prefix}.conv.bias"] = _t(p["bias"])

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["weight"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["running_mean"])
        sd[f"{prefix}.running_var"] = _t(s["running_var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0,
                                                           dtype=torch.long)

    def lstm(prefix, p, suffix=""):
        for field in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"{prefix}.{field}{suffix}"] = _t(p[field])

    enc = params["encoder"]
    for i, layer in enumerate(enc["prenet"]["layers"]):
        linear(f"encoder.prenet.layers.{i}", layer)
    for i, c in enumerate(enc["convolutions"]):
        conv(f"encoder.convolutions.{i}.0", c["conv"])
        bn(f"encoder.convolutions.{i}.1", c["bn"],
           model_state["encoder"]["convolutions"][i])
    lstm("encoder.lstm", enc["lstm_fwd"], "_l0")
    lstm("encoder.lstm", enc["lstm_bwd"], "_l0_reverse")

    dec = params["decoder"]
    for i, layer in enumerate(dec["prenet"]["layers"]):
        linear(f"decoder.prenet.layers.{i}", layer)
    lstm("decoder.attention_rnn", dec["attention_rnn"])
    att = dec["attention"]
    linear("decoder.attention_layer.query_layer", att["query"])
    linear("decoder.attention_layer.memory_layer", att["memory"])
    linear("decoder.attention_layer.v", att["v"])
    conv("decoder.attention_layer.location_layer.location_conv",
         att["location_conv"])
    linear("decoder.attention_layer.location_layer.location_dense",
           att["location_dense"])
    lstm("decoder.decoder_rnn", dec["decoder_rnn"])
    linear("decoder.linear_projection", dec["linear_projection"])
    linear("decoder.gate_layer", dec["gate_layer"])

    for i, c in enumerate(params["postnet"]["convolutions"]):
        conv(f"postnet.convolutions.{i}.0", c["conv"])
        bn(f"postnet.convolutions.{i}.1", c["bn"],
           model_state["postnet"]["convolutions"][i])
    return sd


def save_reference_tacotron2_checkpoint(
    path: str, params: dict, model_state: dict, cfg: Tacotron2Config,
    iteration: int = 0, learning_rate: float = 1e-3,
    optimizer_state: Optional[dict] = None,
):
    """Write the reference's `.pt` dict format (train_ppg2mel.py:143-149)."""
    torch.save({
        "iteration": int(iteration),
        "state_dict": export_tacotron2_state_dict(params, model_state, cfg),
        "optimizer": optimizer_state if optimizer_state is not None else {},
        "learning_rate": float(learning_rate),
    }, path)
