"""WaveGlow bias denoiser (reference src/waveglow/denoiser.py:35-68), the
port of fac_via_ppg_tpu/models/denoiser.py.

Runs the vocoder on a zero (or random) mel of 88 frames at sigma=0 to
capture the model's bias spectrum, then subtracts `strength * bias` in the
magnitude-STFT domain and inverts.
"""

from __future__ import annotations

from typing import Optional

import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.dsp.stft import STFT
from fac_via_ppg_torch.models.waveglow import waveglow_infer


def bias_mel(cfg: WaveGlowConfig, mode: str = "zeros",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The bias pass's (1, n_mel, 88) f32 mel, on the CPU: zeros, or
    standard normal draws from `generator` (mode "normal")."""
    shape = (1, cfg.n_mel_channels, 88)
    if mode == "zeros":
        return torch.zeros(shape)
    if mode == "normal":
        return torch.randn(shape, generator=generator)
    raise ValueError(f"unsupported denoiser mode {mode!r}; "
                     f"choose 'zeros' or 'normal'")


class Denoiser:
    def __init__(
        self,
        cfg: WaveGlowConfig,
        waveglow_params,
        filter_length: int = 1024,
        hop_length: int = 160,
        win_length: int = 1024,
        mode: str = "zeros",
        generator: Optional[torch.Generator] = None,
    ):
        """Runs on the device of `waveglow_params`, through the WN layer
        kernel on CUDA.  mode="normal" draws the bias mel on the CPU from
        `generator` (default: a CPU generator seeded with 0) and moves it
        to that device, so that the CPU and the card build the same
        template."""
        self.stft = STFT(filter_length, hop_length, win_length)
        dev = waveglow_params["upsample"]["weight"].device
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        mel_input = bias_mel(cfg, mode, generator).to(dev)
        with torch.no_grad():
            bias_audio = waveglow_infer(cfg, waveglow_params, mel_input, 0.0)
            bias_spec, _ = self.stft.transform(bias_audio)
        # first frame's magnitude column is the bias template
        self.bias_spec = bias_spec[:, :, 0][:, :, None]

    def __call__(self, audio: torch.Tensor,
                 strength: float = 0.1) -> torch.Tensor:
        """(B, T) -> (B, 1, T') denoised audio (reference layout)."""
        spec, angles = self.stft.transform(audio)
        denoised = torch.clamp(spec - self.bias_spec * strength, min=0.0)
        return self.stft.inverse(denoised, angles)
