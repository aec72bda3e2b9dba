"""Checkpoint loading for the port's inference entry points."""

from __future__ import annotations

from typing import Optional

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.models.waveglow import remove_weightnorm
from fac_via_ppg_torch.train.import_torch import (
    load_reference_waveglow_checkpoint,
)
from fac_via_ppg_torch.weights import fold_waveglow


def load_waveglow_model(path: str, cfg: Optional[WaveGlowConfig] = None):
    """The reference's `.pt` WaveGlow checkpoint (pickled {'model':
    glow.WaveGlow} or a bare state dict) -> the port's inference params on
    the CPU: weight norm folded and the f32 1x1 inverses cached
    (reference utils.py:177-181)."""
    cfg = cfg or WaveGlowConfig()
    return remove_weightnorm(
        fold_waveglow(load_reference_waveglow_checkpoint(path, cfg)))
