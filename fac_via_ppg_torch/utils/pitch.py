"""F0 estimation for the `is_append_f0` data path (the port's copy of
fac_via_ppg_tpu/utils/pitch.py, numpy only).

The reference obtains F0 from WORLD vocoder analysis stored in the
DataUtterance proto (utterance.py:664-670; the analysis itself happens
outside the repo).  WORLD is unavailable here, so this provides a
self-contained YIN pitch tracker (de Cheveigne & Kawahara 2002: cumulative
mean normalized difference + absolute threshold + parabolic refinement)
with the same contract: per-frame F0 in Hz, 0 for unvoiced frames, default
search range matching utterance.py:33-36 (48-400 Hz).

YIN rather than raw autocorrelation: the normalized difference function's
absolute-threshold rule picks the FIRST sufficiently deep dip, which is
what makes the tracker robust to the octave-down errors a global
autocorrelation argmax commits on harmonic-rich voices.
"""

from __future__ import annotations

import numpy as np


def _difference_function(frame: np.ndarray, w: int, lag_max: int) -> np.ndarray:
    """YIN eq. (6): d(tau) = sum_{n<w} (x[n] - x[n+tau])^2 for tau 0..lag_max,
    via one FFT cross-correlation + cumulative energies."""
    x = frame
    # cross term r(tau) = sum_n x[n] x[n+tau]
    n_fft = 1
    while n_fft < len(x) + lag_max + 1:
        n_fft *= 2
    spec = np.fft.rfft(x, n_fft)
    corr = np.fft.irfft(spec * np.conj(spec))[: lag_max + 1]
    sq = x * x
    csum = np.concatenate([[0.0], np.cumsum(sq)])
    e0 = csum[w]                                  # sum x[n]^2, n < w
    taus = np.arange(lag_max + 1)
    e_tau = csum[taus + w] - csum[taus]           # sum x[n+tau]^2, n < w
    # corr computed over the full frame; restrict to the first w lags'
    # overlap by recomputing the cross term exactly:
    #   r_w(tau) = sum_{n<w} x[n] x[n+tau]
    # full-frame corr differs by the tail sum_{n>=w} x[n] x[n+tau]; compute
    # that tail with a second correlation on the tail segment.
    # full-frame corr includes the unwanted tail pairs (n >= w), which all
    # live inside x[w:]; subtract the tail's own autocorrelation.
    tail = x[w:]
    if tail.size:
        spec_t = np.fft.rfft(tail, n_fft)
        corr_tail = np.fft.irfft(spec_t * np.conj(spec_t))[: lag_max + 1]
        corr_w = corr - corr_tail
    else:
        corr_w = corr
    return e0 + e_tau - 2.0 * corr_w


def _cmndf(d: np.ndarray) -> np.ndarray:
    """YIN eq. (8): cumulative-mean-normalized difference, d'(0) = 1."""
    out = np.ones_like(d)
    run = np.cumsum(d[1:])
    taus = np.arange(1, len(d))
    with np.errstate(divide="ignore", invalid="ignore"):
        out[1:] = np.where(run > 0, d[1:] * taus / run, 1.0)
    return out


def estimate_f0(
    wav: np.ndarray,
    fs: float,
    frame_shift_ms: float = 5.0,
    frame_length_ms: float = 40.0,
    f0_floor: float = 48.0,
    f0_ceil: float = 400.0,
    voicing_threshold: float = 0.15,
) -> np.ndarray:
    """YIN F0 track.

    Returns (num_frames,) float64, 0.0 at unvoiced frames;
    num_frames = floor(len(wav) / shift) + 1 like WORLD's harvest.
    `voicing_threshold` is YIN's absolute CMNDF threshold (lower = stricter
    voicing; 0.1-0.2 is the published operating range).
    """
    wav = np.asarray(wav, dtype=np.float64)
    if wav.ndim > 1:
        wav = wav[:, 0]
    shift = int(fs * frame_shift_ms / 1000.0)
    size = int(fs * frame_length_ms / 1000.0)
    lag_min = max(2, int(fs / f0_ceil))
    lag_max = min(int(np.ceil(fs / f0_floor)), size - 1)
    n_frames = len(wav) // shift + 1

    f0 = np.zeros(n_frames)
    energy_floor = 1e-9 + 0.01 * np.sqrt(np.mean(wav**2))
    half = size // 2
    padded = np.pad(wav, (half, size + lag_max))
    for i in range(n_frames):
        frame = padded[i * shift : i * shift + size + lag_max]
        frame = frame - frame.mean()
        if np.sqrt(np.mean(frame[:size] ** 2)) < energy_floor:
            continue
        d = _difference_function(frame, size, lag_max)
        nd = _cmndf(d)

        # absolute threshold: first dip below the threshold, descended to
        # its local minimum (YIN step 4)
        below = np.nonzero(nd[lag_min : lag_max + 1] < voicing_threshold)[0]
        if below.size:
            tau = lag_min + int(below[0])
            while tau + 1 <= lag_max and nd[tau + 1] < nd[tau]:
                tau += 1
        else:
            continue  # unvoiced

        # parabolic interpolation on the normalized difference (step 5)
        lag = float(tau)
        if lag_min < tau < lag_max:
            y0, y1, y2 = nd[tau - 1], nd[tau], nd[tau + 1]
            denom = y0 - 2.0 * y1 + y2
            if abs(denom) > 1e-12:
                lag += 0.5 * (y0 - y2) / denom
        f0[i] = fs / lag

    # kill single-frame flips (isolated octave/voicing glitches)
    if n_frames >= 3:
        v = f0 > 0
        for i in range(1, n_frames - 1):
            if v[i - 1] and v[i + 1] and v[i]:
                lo, hi = sorted((f0[i - 1], f0[i + 1]))
                if hi > 0 and (f0[i] < 0.6 * lo or f0[i] > 1.6 * hi):
                    f0[i] = 0.5 * (f0[i - 1] + f0[i + 1])
    return f0
