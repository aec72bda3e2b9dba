"""Feature plumbing around the MFCC front-end (numpy, host side; a copy of
fac_via_ppg_tpu/frontend/feat.py): wav ingestion, cepstral mean
normalization, context splicing and LDA/fMLLR affine transforms.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Read a wav keeping only the first channel (reference feat.py:29-71)."""
    fs, wav = wavfile.read(path, mmap=False)
    if wav.ndim >= 2:
        wav = wav[:, 0]
    return int(fs), wav


def first_channel(wav: np.ndarray) -> np.ndarray:
    if wav.ndim >= 2:
        return wav[:, 0]
    return wav


def apply_cepstral_mean_norm(feats: np.ndarray) -> np.ndarray:
    """Per-utterance mean subtraction, no variance norm (feat.py:101-118)."""
    return feats - feats.mean(axis=0, keepdims=True)


def splice_frames(
    feats: np.ndarray, left_context: int, right_context: int
) -> np.ndarray:
    """Concatenate +-context frames, clamping at utterance edges.

    Matches kaldi's splice-frames (reference compute_ppg.py:130): frame t
    becomes [x_{t-L}, ..., x_t, ..., x_{t+R}] with out-of-range indices
    clamped to the first/last frame.  (T, D) -> (T, (L+1+R)*D).
    """
    T = feats.shape[0]
    offsets = np.arange(-left_context, right_context + 1)
    idx = np.clip(np.arange(T)[:, None] + offsets[None, :], 0, T - 1)
    return feats[idx].reshape(T, -1)


def apply_feat_transform(feats: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """LDA/fMLLR affine transform F -> F T' (reference feat.py:121-156).

    Handles both a pure-linear (D', D) transform and an affine (D', D+1)
    transform whose last column is the offset.
    """
    feat_dim = feats.shape[1]
    t_rows, t_cols = transform.shape
    if t_cols == feat_dim:
        return feats @ transform.T
    if t_cols == feat_dim + 1:
        linear = transform[:, :feat_dim]
        offset = transform[:, feat_dim]
        return feats @ linear.T + offset[None, :]
    raise ValueError(
        "Transform matrix has bad dimension %dx%d versus feat dim %d"
        % (t_rows, t_cols, feat_dim)
    )
