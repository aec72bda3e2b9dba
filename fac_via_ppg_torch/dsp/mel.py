"""Slaney-style mel filterbank, numerically matching librosa 0.6's
`librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)` with its defaults
(htk=False, norm=1), which is what the reference uses to build
`TacotronSTFT.mel_basis` (reference src/common/layers.py:82-84).

librosa is not a dependency here; the filterbank is computed once on the
host with numpy (a copy of fac_via_ppg_tpu/dsp/mel.py) and then lives on
the device as a constant (80, n_fft//2+1) matrix: the mel projection is
one matmul (dsp/stft.TacotronSTFT).
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0          # Slaney linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size above 1 kHz


def hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, dtype=np.float64)
    mels = freqs / _F_SP
    log_region = freqs >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freqs, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sampling_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank with Slaney area-normalization.

    Returns:
        (n_mels, 1 + n_fft // 2) float32 weight matrix.
    """
    if fmax is None:
        fmax = float(sampling_rate) / 2.0

    fftfreqs = np.linspace(0.0, float(sampling_rate) / 2.0, 1 + n_fft // 2)

    # n_mels + 2 band-edge frequencies, uniformly spaced in mel.
    min_mel = hz_to_mel_slaney(np.array([fmin]))[0]
    max_mel = hz_to_mel_slaney(np.array([fmax]))[0]
    mel_f = mel_to_hz_slaney(np.linspace(min_mel, max_mel, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style (norm=1) area normalization.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm.reshape(-1, 1)

    return weights.astype(np.float32)
