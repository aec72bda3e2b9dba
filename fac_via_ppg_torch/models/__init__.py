"""Models of the port: Tacotron2 (PPG -> mel), WaveGlow (mel -> audio) and
its bias denoiser.  `init_tacotron2` / `init_waveglow` give seeded random
weights from a torch.Generator; `fac_via_ppg_torch.weights` converts the
JAX package's parameters."""

from fac_via_ppg_torch.models.tacotron2 import init_tacotron2
from fac_via_ppg_torch.models.waveglow import init_waveglow

__all__ = ["init_tacotron2", "init_waveglow"]
