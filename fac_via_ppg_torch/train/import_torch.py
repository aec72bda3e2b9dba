"""Reads the reference's torch checkpoints into the port's parameter trees
(the port of fac_via_ppg_tpu/train/import_torch.py).

  * PPG2Mel (Tacotron2): {'iteration', 'state_dict', 'optimizer',
    'learning_rate'} (reference train_ppg2mel.py:143-149); the state dict's
    keys are renamed onto the (params, model_state) trees, whose layouts
    already match torch's.
  * WaveGlow: the whole pickled module, {'model': glow.WaveGlow, ...}
    (train_waveglow.py:56-64); a bare state dict of the same keys also
    loads.  Both weight-norm (weight_g / weight_v) and folded
    (remove_weightnorm) state dicts are handled; `weights.fold_waveglow`
    folds the former.

Each loader tries `torch.load(..., weights_only=True)` first and unpickles
in full only a file that holds more than tensors and numbers.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Dict, Tuple

import torch

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig


def _t(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


# ==========================================================================
# Tacotron2
# ==========================================================================

def _lstm_tree(sd: Dict, prefix: str, suffix: str = "") -> dict:
    return {name: _t(sd[f"{prefix}.{name}{suffix}"])
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}


def import_tacotron2_state_dict(state_dict: Dict, cfg: Tacotron2Config
                                ) -> Tuple[dict, dict]:
    """torch Tacotron2 state_dict -> (params, model_state) of CPU tensors,
    the trees `models/tacotron2.py` takes (BatchNorm running stats in
    model_state)."""
    sd = state_dict

    def linear(prefix, bias=True):
        p = {"weight": _t(sd[f"{prefix}.linear_layer.weight"])}
        if bias:
            p["bias"] = _t(sd[f"{prefix}.linear_layer.bias"])
        return p

    def conv(prefix, bias=True):
        p = {"weight": _t(sd[f"{prefix}.conv.weight"])}
        if bias:
            p["bias"] = _t(sd[f"{prefix}.conv.bias"])
        return p

    def bn(prefix):
        return ({"weight": _t(sd[f"{prefix}.weight"]),
                 "bias": _t(sd[f"{prefix}.bias"])},
                {"running_mean": _t(sd[f"{prefix}.running_mean"]),
                 "running_var": _t(sd[f"{prefix}.running_var"])})

    def conv_stack(prefix, n):
        convs, states = [], []
        for i in range(n):
            bn_p, bn_s = bn(f"{prefix}.{i}.1")
            convs.append({"conv": conv(f"{prefix}.{i}.0"), "bn": bn_p})
            states.append(bn_s)
        return convs, states

    enc_convs, enc_bn_state = conv_stack("encoder.convolutions",
                                         cfg.encoder_n_convolutions)
    post_convs, post_bn_state = conv_stack("postnet.convolutions",
                                           cfg.postnet_n_convolutions)
    att = "decoder.attention_layer"
    params = {
        "encoder": {
            "prenet": {"layers": [
                linear("encoder.prenet.layers.0", bias=False),
                linear("encoder.prenet.layers.1", bias=False)]},
            "convolutions": enc_convs,
            "lstm_fwd": _lstm_tree(sd, "encoder.lstm", "_l0"),
            "lstm_bwd": _lstm_tree(sd, "encoder.lstm", "_l0_reverse"),
        },
        "decoder": {
            "prenet": {"layers": [
                linear("decoder.prenet.layers.0", bias=False),
                linear("decoder.prenet.layers.1", bias=False)]},
            "attention_rnn": _lstm_tree(sd, "decoder.attention_rnn"),
            "attention": {
                "query": linear(f"{att}.query_layer", bias=False),
                "memory": linear(f"{att}.memory_layer", bias=False),
                "v": linear(f"{att}.v", bias=False),
                "location_conv": conv(
                    f"{att}.location_layer.location_conv", bias=False),
                "location_dense": linear(
                    f"{att}.location_layer.location_dense", bias=False),
            },
            "decoder_rnn": _lstm_tree(sd, "decoder.decoder_rnn"),
            "linear_projection": linear("decoder.linear_projection"),
            "gate_layer": linear("decoder.gate_layer"),
        },
        "postnet": {"convolutions": post_convs},
    }
    model_state = {"encoder": {"convolutions": enc_bn_state},
                   "postnet": {"convolutions": post_bn_state}}
    return params, model_state


def load_reference_tacotron2_checkpoint(
    path: str, cfg: Tacotron2Config
) -> Tuple[dict, dict, int, float]:
    """The reference's `.pt` checkpoint -> (params, model_state, iteration,
    learning_rate).  Its payload holds only tensors and numbers, so it
    loads with `weights_only=True`; only a file that holds more is
    unpickled in full: load only checkpoints you trust."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        payload = torch.load(path, map_location="cpu", weights_only=False)
    params, model_state = import_tacotron2_state_dict(payload["state_dict"],
                                                      cfg)
    return (params, model_state, int(payload.get("iteration", 0)),
            float(payload.get("learning_rate", 0.0)))


# ==========================================================================
# WaveGlow
# ==========================================================================

def _install_glow_shims():
    """Register empty module classes so a pickled reference WaveGlow loads.

    Its pickle names classes of the modules 'glow' / 'waveglow.glow' /
    'waveglow.glow_old' / 'glow_old'; pickle restores __dict__ directly, so
    empty nn.Module subclasses suffice.  Returns the names this call
    registered, for `_remove_glow_shims`: a shim left in sys.modules would
    shadow a real module of that name.  Names already present are never
    overwritten.
    """
    def make_module(name):
        mod = types.ModuleType(name)
        for cls in ("WaveGlow", "WN", "Invertible1x1Conv"):
            setattr(mod, cls, type(cls, (torch.nn.Module,), {"__module__": name}))
        return mod

    installed = []
    for name in ("glow", "waveglow.glow", "waveglow.glow_old", "glow_old"):
        if name not in sys.modules:
            parent = name.rsplit(".", 1)[0] if "." in name else None
            if parent and parent not in sys.modules:
                sys.modules[parent] = types.ModuleType(parent)
                installed.append(parent)
            sys.modules[name] = make_module(name)
            installed.append(name)
    return installed


def _remove_glow_shims(installed):
    for name in installed:
        sys.modules.pop(name, None)


def import_waveglow_state_dict(sd: Dict, cfg: WaveGlowConfig) -> dict:
    """torch WaveGlow state_dict -> params tree of CPU tensors, with
    weight-norm (g, v, bias) or folded (weight, bias) convs as stored."""

    def wn_conv(prefix):
        if f"{prefix}.weight_g" in sd:
            g = _t(sd[f"{prefix}.weight_g"])
            return {"g": g.reshape(g.shape[0]),
                    "v": _t(sd[f"{prefix}.weight_v"]),
                    "bias": _t(sd[f"{prefix}.bias"])}
        return {"weight": _t(sd[f"{prefix}.weight"]),
                "bias": _t(sd[f"{prefix}.bias"])}

    params = {
        "upsample": {"weight": _t(sd["upsample.weight"]),
                     "bias": _t(sd["upsample.bias"])},
        "convinv": [],
        "wn": [],
    }
    for k in range(cfg.n_flows):
        params["convinv"].append(
            {"weight": _t(sd[f"convinv.{k}.conv.weight"][:, :, 0])})
        params["wn"].append({
            "start": wn_conv(f"WN.{k}.start"),
            "end": {"weight": _t(sd[f"WN.{k}.end.weight"]),
                    "bias": _t(sd[f"WN.{k}.end.bias"])},
            "in_layers": [wn_conv(f"WN.{k}.in_layers.{i}")
                          for i in range(cfg.wn_n_layers)],
            "cond_layers": [wn_conv(f"WN.{k}.cond_layers.{i}")
                            for i in range(cfg.wn_n_layers)],
            "res_skip_layers": [wn_conv(f"WN.{k}.res_skip_layers.{i}")
                                for i in range(cfg.wn_n_layers)],
        })
    return params


def _load_waveglow_state_dict(path: str) -> Dict:
    """The state dict in a reference `.pt` WaveGlow file: a bare state dict
    or a pickled module ({'model': glow.WaveGlow, ...} or the module).

    A bare state dict loads with `weights_only=True`.  Only a file that
    holds a pickled module is unpickled in full (with the glow shims):
    load only checkpoints you trust, as with the reference itself."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        installed = _install_glow_shims()
        try:
            payload = torch.load(path, map_location="cpu",
                                 weights_only=False)
        finally:
            _remove_glow_shims(installed)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    return payload.state_dict() if hasattr(payload, "state_dict") \
        else payload


def load_reference_waveglow_checkpoint(path: str,
                                       cfg: WaveGlowConfig) -> dict:
    """Reference `.pt` WaveGlow checkpoint -> params tree (see
    `_load_waveglow_state_dict` for the formats it reads)."""
    return import_waveglow_state_dict(_load_waveglow_state_dict(path), cfg)
