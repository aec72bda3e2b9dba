"""WaveGlow bias denoiser (reference src/waveglow/denoiser.py:35-68), the
port of fac_via_ppg_tpu/models/denoiser.py.

Runs the vocoder on a zero mel of 88 frames at sigma=0 to
capture the model's bias spectrum, then subtracts `strength * bias` in the
magnitude-STFT domain and inverts.
"""

from __future__ import annotations

import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.dsp.stft import STFT
from fac_via_ppg_torch.models.waveglow import waveglow_infer


class Denoiser:
    def __init__(
        self,
        cfg: WaveGlowConfig,
        waveglow_params,
        filter_length: int = 1024,
        hop_length: int = 160,
        win_length: int = 1024,
    ):
        """Runs on the device of `waveglow_params`, through the WN layer
        kernel on CUDA."""
        self.stft = STFT(filter_length, hop_length, win_length)
        dev = waveglow_params["upsample"]["weight"].device
        mel_input = torch.zeros((1, cfg.n_mel_channels, 88), device=dev)
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
