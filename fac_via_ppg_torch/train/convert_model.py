"""Old-format WaveGlow checkpoint upgrade (the port of
fac_via_ppg_tpu/train/convert_model.py).

The original WaveGlow release kept separate res_layers / skip_layers 1x1
convs; later checkpoints fuse them into res_skip_layers (reference
src/waveglow/convert_model.py:43-78 and glow_old.py).  This converter
fuses them the same way, on a torch state dict:

  res_skip.weight = cat([res.weight, skip.weight], dim=0)   (i < L-1)
  the last layer keeps only its skip conv,

each part's weight norm folded first (`weights.py`'s fold), as the
reference's remove_weight_norm does.  The other convs keep the form they
were stored in.

    python -m fac_via_ppg_torch.train.convert_model OLD.pt NEW.pt [-c config.json]

writes the upgraded weights as a state dict that the port's vocoder and
synthesis CLIs read.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.train.import_torch import (
    _load_waveglow_state_dict,
    import_waveglow_state_dict,
)
from fac_via_ppg_torch.weights import _weight_norm_fold


def import_old_waveglow_state_dict(sd: Dict, cfg: WaveGlowConfig) -> dict:
    """Old-format (res_layers + skip_layers) torch state dict -> params
    (the fused res_skip convs folded)."""
    fused = {k: v for k, v in sd.items()
             if ".res_layers." not in k and ".skip_layers." not in k}

    def folded(prefix):
        """(weight, bias) of one conv, its weight norm folded
        (reference convert_model.py:58-60)."""
        bias = torch.as_tensor(sd[f"{prefix}.bias"]).float()
        if f"{prefix}.weight_g" in sd:
            g = torch.as_tensor(sd[f"{prefix}.weight_g"]).float()
            p = _weight_norm_fold({
                "g": g.reshape(g.shape[0]),
                "v": torch.as_tensor(sd[f"{prefix}.weight_v"]).float(),
                "bias": bias})
            return p["weight"], bias
        return torch.as_tensor(sd[f"{prefix}.weight"]).float(), bias

    # fuse res + skip per WN block and layer (reference
    # convert_model.py:52-67)
    n_layers = cfg.wn_n_layers
    for k in range(cfg.n_flows):
        for i in range(n_layers):
            if f"WN.{k}.skip_layers.{i}.weight" not in sd and \
                    f"WN.{k}.skip_layers.{i}.weight_v" not in sd:
                continue
            skip_w, skip_b = folded(f"WN.{k}.skip_layers.{i}")
            if i < n_layers - 1:
                res_w, res_b = folded(f"WN.{k}.res_layers.{i}")
                weight = torch.cat([res_w, skip_w], dim=0)
                bias = torch.cat([res_b, skip_b])
            else:
                weight, bias = skip_w, skip_b
            fused[f"WN.{k}.res_skip_layers.{i}.weight"] = weight
            fused[f"WN.{k}.res_skip_layers.{i}.bias"] = bias
    return import_waveglow_state_dict(fused, cfg)


def load_old_reference_waveglow_checkpoint(path: str,
                                           cfg: WaveGlowConfig) -> dict:
    """Old-format checkpoint -> params: the reference's pickled module
    ({'model': glow.WaveGlow, ...}) or a bare state dict of its keys
    (import_torch's loader: load only checkpoints you trust)."""
    return import_old_waveglow_state_dict(_load_waveglow_state_dict(path),
                                          cfg)


def main(argv: Optional[List[str]] = None) -> str:
    """OLD.pt -> NEW.pt (the reference's convert_model.py, a state dict
    here); returns NEW's path."""
    from fac_via_ppg_torch.eval.int8_snr import waveglow_config_from_json
    from fac_via_ppg_torch.train.export_torch import \
        export_waveglow_state_dict

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_model_path")
    ap.add_argument("new_model_path")
    ap.add_argument("-c", "--config", default=None,
                    help="the WaveGlow config JSON (default: "
                    "WaveGlowConfig(), as the vocoder CLI's)")
    args = ap.parse_args(argv)
    cfg = (waveglow_config_from_json(args.config) if args.config
           else WaveGlowConfig())
    params = load_old_reference_waveglow_checkpoint(args.old_model_path, cfg)
    torch.save(export_waveglow_state_dict(params, cfg), args.new_model_path)
    return args.new_model_path


if __name__ == "__main__":
    main()
