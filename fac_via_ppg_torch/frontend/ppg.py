"""Phonetic posteriorgram (PPG) extraction, the port of
fac_via_ppg_tpu/frontend/ppg.py.

wav -> MFCC -> CMN -> splice(+-3) -> LDA on the host (numpy), then the
batched TDNN forward (torch) -> 5816-dim posteriors.

The reference's acoustic model `data/am/final.raw` is a missing large blob;
`DependenciesPPG` therefore points at this repo's `data/` directory, where
a structurally identical substitute TDNN is generated on first use
(`fac_via_ppg_torch.scripts.make_substitute_am`, the same draws as the JAX
package's generator).  Point `nnet_path` at a real model, the reference's
binary `final.raw` or its text form, for production use.

The TDNN forward runs on `device` (None means the CUDA card, and raises
without one); tests pass device="cpu".
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.frontend import kaldi_io
from fac_via_ppg_torch.frontend import nnet3 as nnet3_mod
from fac_via_ppg_torch.frontend.mfcc import (
    FrameExtractionOptions,
    MelBanksOptions,
    MfccOptions,
    compute_mfcc,
)
from fac_via_ppg_torch.utils.device import resolve_device

# Static resources (reference compute_ppg.py:33-39).
DATA_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "data"
)
NNET_PATH = os.path.join(DATA_DIR, "am", "final.raw.txt")
LDA_PATH = os.path.join(DATA_DIR, "feats", "final.mat")
REDUCE_DIM_PATH = os.path.join(DATA_DIR, "feats", "reduce_dim.mat")
SPLICE_OPTS_PATH = os.path.join(DATA_DIR, "feats", "splice_opts")


def compute_feat_for_nnet_internal(
    wav: np.ndarray,
    fs: float,
    lda: np.ndarray,
    is_use_energy: bool = False,
    is_downsample: bool = True,
    frame_shift: float = 10,
    is_snip_edges: bool = False,
    left_context: int = 3,
    right_context: int = 3,
    dither: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """wav -> LDA-projected AM input features (reference compute_ppg.py:98-136).

    MFCC -> per-utterance CMN -> splice(+-3) -> LDA.  Returns (T, lda_rows).
    """
    opts = MfccOptions(
        frame_opts=FrameExtractionOptions(
            frame_shift_ms=frame_shift,
            snip_edges=is_snip_edges,
            allow_downsample=is_downsample,
            dither=dither,
        ),
        mel_opts=MelBanksOptions(),
        use_energy=is_use_energy,
    )
    mfccs = compute_mfcc(wav, fs, opts, seed=seed)
    mfccs = feat_mod.apply_cepstral_mean_norm(mfccs)
    spliced = feat_mod.splice_frames(mfccs, left_context, right_context)
    return feat_mod.apply_feat_transform(spliced, lda)


def compute_full_ppg(nnet: nnet3_mod.Nnet3, feats: np.ndarray,
                     pad_to: int = 64,
                     device: Optional[torch.device] = None) -> np.ndarray:
    """AM input features -> (T, n_senones) posteriors, computed on
    `device` (None means the CUDA card; raises without one).

    Frames are padded to a `pad_to` bucket by replicating the last frame;
    replication preserves the TDNN's edge-clamping semantics exactly
    (offsets at the true last frame read the same values either way), and
    padded outputs are sliced off.
    """
    device = resolve_device(device)
    t = feats.shape[0]
    feats = np.asarray(feats, dtype=np.float32)
    if pad_to > 1 and t % pad_to:
        t_pad = ((t + pad_to - 1) // pad_to) * pad_to
        feats = np.concatenate(
            [feats, np.repeat(feats[-1:], t_pad - t, axis=0)], axis=0
        )
    with torch.no_grad():
        out = nnet.to(device).forward(torch.as_tensor(feats, device=device))
    return out.cpu().numpy()[:t]


def reduce_ppg_dim(ppgs: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Full (T, D) PPGs -> monophone (T, d) via a dense matmul
    (reference compute_ppg.py:73-95 densifies the sparse map the same way)."""
    return ppgs @ transform.T


def compute_monophone_ppg(
    wav: np.ndarray,
    fs: float,
    nnet: nnet3_mod.Nnet3,
    lda: np.ndarray,
    transform: np.ndarray,
    shift: float = 10,
    dither: float = 1.0,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """One-stop monophone-PPG interface (reference compute_ppg.py:165-183)."""
    feats = compute_feat_for_nnet_internal(
        wav, fs, lda, frame_shift=shift, dither=dither, seed=seed
    )
    raw = compute_full_ppg(nnet, feats, device=device)
    return reduce_ppg_dim(raw, transform)


def compute_full_ppg_wrapper(
    wav: np.ndarray,
    fs: float,
    nnet: nnet3_mod.Nnet3,
    lda: np.ndarray,
    shift: float = 10,
    dither: float = 1.0,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """One-stop full-PPG interface (reference compute_ppg.py:186-202)."""
    feats = compute_feat_for_nnet_internal(
        wav, fs, lda, frame_shift=shift, dither=dither, seed=seed
    )
    return compute_full_ppg(nnet, feats, device=device)


class DependenciesPPG:
    """Loads the AM / LDA / monophone-map / splice-opts resource bundle
    (reference compute_ppg.py:205-257)."""

    def __init__(
        self,
        nnet_path: str = NNET_PATH,
        lda_path: str = LDA_PATH,
        reduce_dim_path: str = REDUCE_DIM_PATH,
        splice_opts_path: str = SPLICE_OPTS_PATH,
    ):
        defaults = (NNET_PATH, LDA_PATH, REDUCE_DIM_PATH, SPLICE_OPTS_PATH)
        missing = [
            p
            for p in (nnet_path, lda_path, reduce_dim_path, splice_opts_path)
            if not os.path.isfile(p)
        ]
        if missing and all(p in defaults for p in missing):
            # Default bundle not materialized yet (the substitute AM is a
            # generated artifact, not checked in) -- build it now.
            from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle

            # only generate the MISSING defaults -- never clobber artifacts
            # the user may have replaced with real ones
            make_bundle(os.path.abspath(DATA_DIR), overwrite=False)
        elif missing:
            raise FileNotFoundError(
                f"PPG resources do not exist: {missing}. Run "
                "`python -m fac_via_ppg_torch.scripts.make_substitute_am` "
                "to generate a substitute bundle."
            )
        self.nnet_path = nnet_path
        self.lda_path = lda_path
        self.reduce_dim_path = reduce_dim_path
        self.splice_opts_path = splice_opts_path

        self.nnet = nnet3_mod.load_nnet3(nnet_path)
        self.lda = kaldi_io.read_matrix(lda_path)
        self.monophone_trans = kaldi_io.read_sparse_matrix(reduce_dim_path)
        with open(splice_opts_path) as reader:
            self.splice_opts = reader.readline()
        context = re.match(
            r"--left-context=(\d+) --right-context=(\d+)", self.splice_opts
        )
        if context:
            self.left_context, self.right_context = context.groups()
        else:
            self.left_context = self.right_context = None


def get_ppg(wav_path: str, deps: DependenciesPPG, dither: float = 1.0,
            seed: int = 0,
            device: Optional[torch.device] = None) -> np.ndarray:
    """wav file -> full PPG (reference data_utils.py:55-59)."""
    fs, wav = feat_mod.read_wav(wav_path)
    return compute_full_ppg_wrapper(
        wav, fs, deps.nnet, deps.lda, 10, dither=dither, seed=seed,
        device=device,
    )
