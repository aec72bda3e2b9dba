"""Writes the port's parameter trees as the reference's torch checkpoints
(the port of fac_via_ppg_tpu/train/export_torch.py), the inverse of
train/import_torch:

  * Tacotron2: `save_reference_tacotron2_checkpoint` writes the reference's
    {'iteration', 'state_dict', 'optimizer', 'learning_rate'} `.pt`
    (train_ppg2mel.py:143-149), which `utils/inference.load_tacotron2_model`
    and the JAX package's loader read.
  * WaveGlow: `export_waveglow_state_dict`; `torch.save` of it is a
    checkpoint that `utils/inference.load_waveglow_model` reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig


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
