"""Reads the reference's WaveGlow checkpoints into the port's parameter
trees (the WaveGlow part of fac_via_ppg_tpu/train/import_torch.py).

The reference saves the whole pickled module, {'model': glow.WaveGlow, ...}
(train_waveglow.py:56-64); a bare state dict of the same keys also loads.
Both weight-norm (weight_g / weight_v) and folded (remove_weightnorm)
state dicts are handled; `weights.fold_waveglow` folds the former.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Dict

import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig


def _t(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


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


def load_reference_waveglow_checkpoint(path: str,
                                       cfg: WaveGlowConfig) -> dict:
    """Reference `.pt` WaveGlow checkpoint -> params tree.

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
    sd = payload.state_dict() if hasattr(payload, "state_dict") else payload
    return import_waveglow_state_dict(sd, cfg)
