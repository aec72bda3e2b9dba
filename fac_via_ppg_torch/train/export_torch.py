"""Writes the port's WaveGlow params as the reference's torch state dict
(the WaveGlow part of fac_via_ppg_tpu/train/export_torch.py), the inverse
of train/import_torch.import_waveglow_state_dict.  `torch.save` of the
result is a checkpoint that `utils/inference.load_waveglow_model` reads.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig


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
