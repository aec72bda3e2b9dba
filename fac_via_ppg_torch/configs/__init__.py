from fac_via_ppg_torch.configs.hparams import (
    HParamsView,
    Tacotron2Config,
    WaveGlowConfig,
    create_hparams,
    create_hparams_stage,
)

import json
import os

# The WaveGlow trainer's 4-section config (reference src/waveglow/
# config.json), the port's copy of the JAX package's.
DEFAULT_WAVEGLOW_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "waveglow_config.json")


def load_waveglow_config(path: str = DEFAULT_WAVEGLOW_CONFIG_PATH) -> dict:
    """Load the 4-section WaveGlow config (reference src/waveglow/config.json)."""
    with open(path) as f:
        return json.load(f)
