"""Kaldi-convention MFCC front-end: the host side (native C++ or numpy)
and the device side (`MfccTorch`).

`compute_mfcc(backend="auto")` runs the native C++ library
(native/src/frontend.cc, loaded by fac_via_ppg_torch/native.py) and takes
this module's numpy path where the JAX package does: no toolchain, or an
option combination the library does not implement.

The numpy path is a copy of fac_via_ppg_tpu/frontend/mfcc.py's (options set
as the reference does at src/ppg/compute_ppg.py:110-123: use_energy=False,
allow_downsample=True, frame_shift=10 ms, snip_edges=False):

  frame extraction (snip_edges=False):
      num_frames   = (num_samples + shift/2) // shift
      frame center = t*shift + shift/2, start = center - window/2,
      out-of-range samples mirrored (reflect without repeating the edge)
  per-frame: dither -> remove DC -> preemphasis (0.97) -> povey window
  FFT on pow2-padded window (400 -> 512), power spectrum (257 bins)
  23 HTK-mel triangular bins over [20 Hz, nyquist], floor eps, log
  DCT-II orthonormal -> first 13 ceps, cepstral lifter Q=22

Dither is driven by numpy's RandomState(seed) on the numpy path (the same
draws as the JAX package's numpy path) and by the library's own seeded
generator on the native path (the JAX package's native draws); the two
backends agree to 1e-3 apart from the dither.  Pass dither=0.0 for
deterministic features.

`MfccTorch` is the port of the JAX package's `MfccJax`: whole-utterance
MFCC on a device, one (n_frames, 512) rFFT and two small products.  Its
dither draws from a `torch.Generator`.  It computes in float64 from the
frames on and rounds the features to float32, as the numpy path does:
no TF32 setting reads a float64 product (the JAX program asks for
Precision.HIGHEST there, since log-compressed features drift under
TF32), and a float32 MFCC moves the full-width AM's posteriors from the
host path's by 3.3e-4 of a frame's largest posterior on an H100, where
float64 keeps them within 2.7e-5 (chip_smoke.py phase 11 (b), 32
speech-like utterances).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from fac_via_ppg_torch.utils.device import resolve_device


# --------------------------------------------------------------------------
# options
# --------------------------------------------------------------------------

@dataclass
class FrameExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey | hamming | hanning | rectangular
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True
    allow_downsample: bool = False

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


@dataclass
class MelBanksOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0 means nyquist + high_freq


@dataclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = field(default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = field(default_factory=MelBanksOptions)
    num_ceps: int = 13
    use_energy: bool = True  # Kaldi default; reference sets False
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


# --------------------------------------------------------------------------
# constants (windows, mel banks, DCT)
# --------------------------------------------------------------------------

def feature_window(opts: FrameExtractionOptions) -> np.ndarray:
    n = opts.window_size
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        w = (
            opts.blackman_coeff
            - 0.5 * np.cos(a * i)
            + (0.5 - opts.blackman_coeff) * np.cos(2 * a * i)
        )
    else:
        raise ValueError(f"Unknown window type {opts.window_type!r}")
    return w.astype(np.float64)


def _mel_scale_htk(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_banks(
    mel_opts: MelBanksOptions, frame_opts: FrameExtractionOptions
) -> np.ndarray:
    """HTK-mel triangular filterbank over FFT bins (Kaldi mel-computations).

    Returns (num_bins, padded_window_size // 2) weights: Kaldi drops the
    nyquist bin from its mel banks.
    """
    num_fft_bins = frame_opts.padded_window_size // 2
    nyquist = 0.5 * frame_opts.samp_freq
    low_freq = mel_opts.low_freq
    high_freq = (
        mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    )
    mel_low = _mel_scale_htk(low_freq)
    mel_high = _mel_scale_htk(high_freq)
    delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)

    fft_freqs = (
        np.arange(num_fft_bins, dtype=np.float64)
        * frame_opts.samp_freq
        / frame_opts.padded_window_size
    )
    mel_freqs = _mel_scale_htk(fft_freqs)

    left = mel_low + np.arange(mel_opts.num_bins)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (mel_freqs[None, :] - left) / delta
    down = (right - mel_freqs[None, :]) / delta
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float64)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II (Kaldi ComputeDctMatrix), truncated to num_ceps rows."""
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    m = np.sqrt(2.0 / num_bins) * np.cos(np.pi / num_bins * (n + 0.5) * k)
    m[0, :] = np.sqrt(1.0 / num_bins)
    return m


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(np.pi * i / q)


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------

def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    shift = opts.window_shift
    size = opts.window_size
    if opts.snip_edges:
        if num_samples < size:
            return 0
        return 1 + (num_samples - size) // shift
    return (num_samples + shift // 2) // shift


def frame_indices(num_samples: int, opts: FrameExtractionOptions) -> np.ndarray:
    """(n_frames, window_size) sample indices with Kaldi edge reflection."""
    n = num_frames(num_samples, opts)
    shift, size = opts.window_shift, opts.window_size
    if opts.snip_edges:
        starts = np.arange(n) * shift
    else:
        starts = np.arange(n) * shift + shift // 2 - size // 2
    idx = starts[:, None] + np.arange(size)[None, :]
    # Kaldi reflection: s < 0 -> -s - 1 ; s >= n -> 2n - 1 - s, repeated.
    for _ in range(4):  # window << num_samples in practice; a few passes suffice
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)
    return idx


# --------------------------------------------------------------------------
# resampling (allow_downsample)
# --------------------------------------------------------------------------

def resample_waveform(wav: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Windowed-sinc resampler following Kaldi's LinearResample conventions
    (lowpass at 0.99 * nyquist_out, num_zeros=6, Hann-windowed sinc)."""
    if fs_in == fs_out:
        return wav.astype(np.float64)
    num_zeros = 6
    cutoff = 0.99 * 0.5 * min(fs_in, fs_out)
    window_width = num_zeros / (2.0 * cutoff)  # seconds, each side

    n_in = len(wav)
    n_out = int(np.floor((n_in - 1) * fs_out / fs_in)) + 1
    t_out = np.arange(n_out, dtype=np.float64) / fs_out

    out = np.zeros(n_out, dtype=np.float64)
    half_width_samples = int(np.ceil(window_width * fs_in))
    center = t_out * fs_in  # fractional input index per output sample
    first = np.floor(center).astype(int) - half_width_samples
    offsets = np.arange(2 * half_width_samples + 2)
    idx = first[:, None] + offsets[None, :]
    t_in = idx / fs_in
    delta_t = t_in - t_out[:, None]

    # Hann-windowed sinc filter.
    in_window = np.abs(delta_t) < window_width
    window = np.where(
        in_window, 0.5 + 0.5 * np.cos(np.pi / window_width * delta_t), 0.0
    )
    x = 2.0 * cutoff * delta_t
    sinc = np.where(np.abs(x) > 1e-9, np.sin(np.pi * x) / (np.pi * np.where(x == 0, 1, x)), 1.0)
    filt = 2.0 * cutoff / fs_in * window * sinc

    valid = (idx >= 0) & (idx < n_in)
    samples = np.where(valid, wav.astype(np.float64)[np.clip(idx, 0, n_in - 1)], 0.0)
    out = (samples * filt).sum(axis=1)
    return out


# --------------------------------------------------------------------------
# numpy implementation (host path)
# --------------------------------------------------------------------------

def compute_mfcc(
    wav: np.ndarray,
    fs: float,
    opts: MfccOptions | None = None,
    seed: int = 0,
    backend: str = "auto",
) -> np.ndarray:
    """Waveform -> (n_frames, num_ceps) MFCCs, Kaldi conventions.

    Args:
        wav: (S,) or (S, C) samples in int16 scale; first channel only, as in
             reference feat.py:29-56.
        fs: sampling frequency of `wav`.
        opts: MfccOptions.
        seed: dither PRNG seed (only used when frame_opts.dither != 0).
        backend: 'auto' prefers the native C++ library and takes numpy
            where it cannot build or load, or where `native.supports`
            rejects the options; 'native' raises in both cases; 'numpy'
            forces numpy.
    """
    opts = opts or MfccOptions()
    fo = opts.frame_opts
    if wav.ndim >= 2:
        wav = wav[:, 0]
    wav = np.asarray(wav, dtype=np.float64)

    if fs != fo.samp_freq:
        if not fo.allow_downsample or fs < fo.samp_freq:
            raise ValueError(
                f"Sample rate {fs} != expected {fo.samp_freq} "
                "and allow_downsample is off."
            )
        wav = resample_waveform(wav, fs, fo.samp_freq)

    if backend in ("auto", "native"):
        from fac_via_ppg_torch import native

        if native.supports(opts):
            out = native.mfcc_compute(wav, fo.samp_freq, opts, seed=seed)
            if out is not None:
                return out
            if backend == "native":
                raise RuntimeError("native frontend library unavailable")
        elif backend == "native":
            raise ValueError(
                "option combination not implemented by the native frontend "
                "(see fac_via_ppg_torch.native.supports); use "
                "backend='numpy'")
    elif backend != "numpy":
        raise ValueError(f"unknown MFCC backend {backend!r}")

    idx = frame_indices(len(wav), fo)
    frames = wav[idx]  # (T, window_size)

    if fo.dither != 0.0:
        rng = np.random.RandomState(seed)
        frames = frames + rng.randn(*frames.shape) * fo.dither
    if fo.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)

    if opts.use_energy and opts.raw_energy:
        log_energy = np.log(
            np.maximum((frames**2).sum(axis=1), np.finfo(np.float64).tiny)
        )

    if fo.preemph_coeff != 0.0:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - fo.preemph_coeff * shifted

    frames = frames * feature_window(fo)[None, :]

    if opts.use_energy and not opts.raw_energy:
        log_energy = np.log(
            np.maximum((frames**2).sum(axis=1), np.finfo(np.float64).tiny)
        )

    spec = np.fft.rfft(frames, n=fo.padded_window_size, axis=1)
    power = (spec.real**2 + spec.imag**2)[:, : fo.padded_window_size // 2]

    banks = mel_banks(opts.mel_opts, fo)
    mel_energies = power @ banks.T
    mel_energies = np.maximum(mel_energies, np.finfo(np.float32).eps)
    log_mel = np.log(mel_energies)

    dct = dct_matrix(opts.num_ceps, opts.mel_opts.num_bins)
    feats = log_mel @ dct.T
    if opts.cepstral_lifter != 0.0:
        feats = feats * lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)[None, :]
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = np.maximum(log_energy, np.log(opts.energy_floor))
        feats[:, 0] = log_energy
    return feats.astype(np.float32)


# --------------------------------------------------------------------------
# torch implementation (device path)
# --------------------------------------------------------------------------

class MfccTorch:
    """Whole-utterance MFCC on `device` (None means the CUDA card), the
    port of fac_via_ppg_tpu/frontend/mfcc.py::MfccJax.

    Gather frames -> dither -> DC removal -> raw log-energy ->
    pre-emphasis -> Povey window -> rFFT -> power spectrum without the
    Nyquist bin -> mel banks -> eps floor -> log -> DCT with the lifter
    folded in -> energy column, in float64 (see the module doc).  The
    constants are built once, here.
    """

    def __init__(self, opts: Optional[MfccOptions] = None, device=None):
        self.opts = opts or MfccOptions()
        self.device = resolve_device(device)
        fo = self.opts.frame_opts
        dct = dct_matrix(self.opts.num_ceps, self.opts.mel_opts.num_bins)
        if self.opts.cepstral_lifter != 0.0:
            dct = dct * lifter_coeffs(self.opts.num_ceps,
                                      self.opts.cepstral_lifter)[:, None]

        def const(x):
            return torch.as_tensor(x, dtype=torch.float64,
                                   device=self.device)

        self.window = const(feature_window(fo))
        self.banks = const(mel_banks(self.opts.mel_opts, fo))
        self.dct = const(dct)

    def compute(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """(..., n_frames, window_size) frames on the device ->
        (..., n_frames, num_ceps) float32, computed in the constants'
        dtype (float64).  Dither draws from `generator` (on the device)
        where the options ask for it; without one, no dither."""
        opts, fo = self.opts, self.opts.frame_opts
        frames = frames.to(self.window.dtype)
        if fo.dither != 0.0 and generator is not None:
            frames = frames + torch.randn(
                frames.shape, generator=generator, dtype=frames.dtype,
                device=frames.device) * fo.dither
        if fo.remove_dc_offset:
            frames = frames - frames.mean(dim=-1, keepdim=True)

        def log_energy_of(x):
            return torch.log(torch.clamp((x * x).sum(dim=-1),
                                         min=float(np.finfo(np.float64).tiny)))

        if opts.use_energy and opts.raw_energy:
            log_energy = log_energy_of(frames)
        if fo.preemph_coeff != 0.0:
            shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
            frames = frames - fo.preemph_coeff * shifted
        frames = frames * self.window
        if opts.use_energy and not opts.raw_energy:
            log_energy = log_energy_of(frames)

        spec = torch.fft.rfft(frames, n=fo.padded_window_size, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2)[
            ..., : fo.padded_window_size // 2]
        mel = torch.clamp(torch.matmul(power, self.banks.T),
                          min=float(np.finfo(np.float32).eps))
        feats = torch.matmul(torch.log(mel), self.dct.T)
        if opts.use_energy:
            if opts.energy_floor > 0.0:
                log_energy = torch.clamp(log_energy,
                                         min=float(np.log(opts.energy_floor)))
            feats = torch.cat([log_energy[..., None], feats[..., 1:]], dim=-1)
        return feats.float()

    def __call__(self, wav, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """(S,) waveform at the options' rate (numpy or tensor, int16
        scale) -> (n_frames, num_ceps) float32 on the device."""
        wav = torch.as_tensor(wav, device=self.device).to(torch.float64)
        idx = torch.as_tensor(
            frame_indices(wav.shape[0], self.opts.frame_opts),
            device=self.device)
        return self.compute(wav[idx], generator)
