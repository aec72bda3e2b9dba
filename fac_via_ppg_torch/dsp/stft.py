"""STFT / iSTFT and the mel-spectrogram front end (torch), the port of
fac_via_ppg_tpu/dsp/stft.py.

Numerics follow the reference (src/common/stft.py:44-143), which computes
the STFT as a conv1d against a windowed Fourier basis on a reflect-padded
signal; here as framing + a real FFT, which is the same arithmetic:
  transform:  frame_k = x_pad[k*hop : k*hop + n_fft]
              S_k     = rfft(window * frame_k);  magnitude, phase
  inverse:    y = OLA_k(window * irfft(mag_k * e^{i phase_k})) / wss
              trimmed by n_fft//2 on both sides, wss = window sum-square
              envelope (reference src/common/audio_processing.py:39-88).
  mel:        log(clip(mel_basis @ |S|, 1e-5)), the projection one matmul
              (reference src/common/layers.py:74-112).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fac_via_ppg_torch.dsp.mel import mel_filterbank

_TINY_F32 = float(np.finfo(np.float32).tiny)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as scipy.signal.get_window('hann', n)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to `size` (librosa.util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def window_sumsquare(
    window: np.ndarray, n_frames: int, hop_length: int, n_fft: int
) -> np.ndarray:
    """Sum-square OLA envelope of the analysis window (reference
    audio_processing.py:39-88).  `window` is the win_length window; it is
    squared and center-padded to n_fft here."""
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    win_sq = pad_center(np.asarray(window, dtype=np.float64) ** 2, n_fft)
    for i in range(n_frames):
        sample = i * hop_length
        x[sample : min(n, sample + n_fft)] += win_sq[: max(0, min(n_fft, n - sample))]
    return x.astype(np.float32)


class STFT:
    """STFT configuration + precomputed window (defaults: reference
    src/common/stft.py:46)."""

    def __init__(self, filter_length: int = 800, hop_length: int = 200,
                 win_length: int = 800, window: str | None = "hann"):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window
        if window is not None:
            if filter_length < win_length:
                raise ValueError("filter_length must be >= win_length")
            if window != "hann":
                raise ValueError("Only the hann window is supported.")
            w = pad_center(hann_window(win_length), filter_length)
        else:
            w = np.ones(filter_length, dtype=np.float32)
        self.padded_window = w

    def num_frames(self, num_samples: int) -> int:
        padded = num_samples + 2 * (self.filter_length // 2)
        return (padded - self.filter_length) // self.hop_length + 1

    def _window(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.padded_window, dtype=torch.float32,
                               device=like.device)

    def _spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, n_frames, n_bins) complex, on the reflect-padded
        signal."""
        half = self.filter_length // 2
        x = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.filter_length, self.hop_length)
        return torch.fft.rfft(frames * self._window(x), n=self.filter_length,
                              dim=-1)

    def transform(self, x: torch.Tensor):
        """(B, T) waveform -> (magnitude, phase), each (B, n_bins, n_frames)."""
        spec = self._spectrum(x)
        real, imag = spec.real.float(), spec.imag.float()
        magnitude = torch.sqrt(real ** 2 + imag ** 2)
        phase = torch.atan2(imag, real)
        return magnitude.transpose(1, 2), phase.transpose(1, 2)

    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> magnitude (B, n_bins, n_frames), no phase."""
        return torch.abs(self._spectrum(x)).float().transpose(1, 2)

    def inverse(self, magnitude: torch.Tensor,
                phase: torch.Tensor) -> torch.Tensor:
        """(B, n_bins, n_frames) x2 -> (B, 1, T) waveform (reference layout)."""
        n_frames = magnitude.shape[-1]
        spec = torch.polar(magnitude, phase).transpose(1, 2)
        frames = torch.fft.irfft(spec, n=self.filter_length, dim=-1)
        frames = frames * self._window(frames)
        out_len = self.filter_length + self.hop_length * (n_frames - 1)
        out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                     kernel_size=(1, self.filter_length),
                     stride=(1, self.hop_length))[:, 0, 0]
        if self.window is not None:
            wss = torch.as_tensor(window_sumsquare(
                hann_window(self.win_length), n_frames, self.hop_length,
                self.filter_length), device=out.device)
            # Only correct where the envelope is numerically nonzero
            # (reference stft.py:125-130).
            safe = wss > _TINY_F32
            out = torch.where(safe, out / torch.where(safe, wss, 1.0), out)
        half = self.filter_length // 2
        return out[:, None, half:-half]


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clip(x) * C)  (reference audio_processing.py:110-116)."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor,
                                C: float = 1.0) -> torch.Tensor:
    return torch.exp(x) / C


class TacotronSTFT:
    """Waveform -> log-mel spectrogram (reference src/common/layers.py:74-112):
    reflect pad -> frame -> rFFT -> |.| -> mel matmul -> log compression."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: float = 8000.0):
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.stft_fn = STFT(filter_length, hop_length, win_length, "hann")
        self.mel_basis = mel_filterbank(sampling_rate, filter_length,
                                        n_mel_channels, mel_fmin, mel_fmax)

    def spectral_normalize(self, magnitudes):
        return dynamic_range_compression(magnitudes)

    def spectral_de_normalize(self, magnitudes):
        return dynamic_range_decompression(magnitudes)

    def mel_spectrogram(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T) in [-1, 1] -> (B, n_mel_channels, n_frames) log-mel, on
        y's device."""
        mag = self.stft_fn.magnitude(y)
        basis = torch.as_tensor(self.mel_basis, device=y.device)
        return dynamic_range_compression(torch.matmul(basis, mag))


def griffin_lim(magnitudes: torch.Tensor, stft_fn: STFT, n_iters: int = 30,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction (reference audio_processing.py:91-107).

    The initial phases are uniform in [-pi, pi) from `generator`, or the
    given `angles` (B, n_bins, n_frames)."""
    if angles is None:
        angles = (torch.rand(magnitudes.shape, generator=generator,
                             device=magnitudes.device) * 2 - 1) * math.pi
    signal = stft_fn.inverse(magnitudes, angles)[:, 0, :]
    for _ in range(n_iters):
        _, angles = stft_fn.transform(signal)
        signal = stft_fn.inverse(magnitudes, angles)[:, 0, :]
    return signal
