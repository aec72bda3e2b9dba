"""Phonetic posteriorgram (PPG) extraction, the port of
fac_via_ppg_tpu/frontend/ppg.py.

wav -> MFCC -> CMN -> splice(+-3) -> LDA on the host (numpy), then the
batched TDNN forward (torch) -> 5816-dim posteriors.  `DeviceFeaturizer`
runs the whole chain on the device for a batch of utterances (the
training preload's `featurize_device`).

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
from typing import List, Optional

import numpy as np
import torch

from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.frontend import kaldi_io
from fac_via_ppg_torch.frontend import nnet3 as nnet3_mod
from fac_via_ppg_torch.frontend.mfcc import (
    FrameExtractionOptions,
    MelBanksOptions,
    MfccOptions,
    MfccTorch,
    compute_mfcc,
    frame_indices,
    num_frames,
    resample_waveform,
)
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.numeric import round_up

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


class DeviceFeaturizer:
    """Batched wav -> full-PPG pipeline on `device` (None means the CUDA
    card), the port of fac_via_ppg_tpu/frontend/ppg.py::DeviceFeaturizer.

    MFCC -> CMN -> splice -> LDA -> TDNN for a chunk of up to `max_batch`
    utterances at once, one program per (S, T) bucket: T padded to a
    multiple of `frame_bucket`, S to a multiple of window_shift *
    frame_bucket.  Frame gather indices are built on the host per
    utterance with its own Kaldi edge reflection, padded by repeating the
    last valid row; the CMN mean masks the padding; the splice clamps to
    the valid range; the last valid LDA row is replicated into the padding
    before the TDNN (compute_full_ppg's replicate-pad), so each output,
    sliced to its true frame count, is the host path's.  MFCC and LDA
    run in float64 (MfccTorch's module doc says why), the TDNN in float32,
    as on the host path.

    Dither draws from a `torch.Generator` on the device seeded with
    `seed + lo` per chunk starting at utterance `lo` (the JAX package
    splits `PRNGKey(seed + lo)`: the same distribution, other draws); pass
    dither=0.0 for deterministic parity with the host path.
    """

    def __init__(self, deps: "DependenciesPPG", frame_shift: float = 10.0,
                 dither: float = 1.0, left_context: int = 3,
                 right_context: int = 3, frame_bucket: int = 128,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device)
        self.opts = MfccOptions(
            frame_opts=FrameExtractionOptions(
                frame_shift_ms=frame_shift, snip_edges=False,
                allow_downsample=True, dither=dither,
            ),
            mel_opts=MelBanksOptions(),
            use_energy=False,
        )
        self._mfcc = MfccTorch(self.opts, device=self.device)
        # float64, as MfccTorch: no TF32 setting reads the product
        self.lda = torch.as_tensor(deps.lda, dtype=torch.float64,
                                   device=self.device)
        self.nnet = deps.nnet.to(self.device)
        self.left, self.right = left_context, right_context
        self.frame_bucket = frame_bucket

    def _run(self, wavs: torch.Tensor, idx: torch.Tensor,
             n_valid: torch.Tensor, generator: torch.Generator
             ) -> torch.Tensor:
        """(B, S) wavs, (B, T, win) gather indices, (B,) valid frame
        counts -> (B, T, n_senones)."""
        B, T, _ = idx.shape
        rows = torch.arange(B, device=self.device)[:, None, None]
        feats = self._mfcc.compute(wavs[rows, idx], generator)

        # masked per-utterance CMN: the padding frames replicate the last
        # valid frame and must not bias the mean
        fidx = torch.arange(T, device=self.device)[None, :]
        valid = (fidx < n_valid[:, None]).to(feats.dtype)
        mean = (feats * valid[:, :, None]).sum(dim=1) / \
            n_valid.to(feats.dtype)[:, None]
        feats = feats - mean[:, None, :]

        # splice, clamped at the valid range (kaldi splice-frames)
        offs = torch.arange(-self.left, self.right + 1, device=self.device)
        last = (n_valid - 1)[:, None, None]
        six = torch.minimum(torch.clamp(fidx[:, :, None] + offs, min=0),
                            last)
        sp = feats[rows, six].reshape(B, T, -1).double()

        feat_dim = sp.shape[-1]
        if self.lda.shape[1] == feat_dim:
            proj = torch.matmul(sp, self.lda.T)
        elif self.lda.shape[1] == feat_dim + 1:
            proj = torch.matmul(sp, self.lda[:, :feat_dim].T) + \
                self.lda[:, feat_dim]
        else:
            raise ValueError(
                f"LDA shape {tuple(self.lda.shape)} vs feat dim {feat_dim}")

        # the last valid row replicated into the padding, so the TDNN's
        # clamped offsets see the true last frame
        rix = torch.minimum(fidx.expand(B, T), last[:, :, 0])
        proj = proj.float()[rows[:, :, 0], rix]
        return self.nnet.forward(proj)

    def __call__(self, wavs, fs: float, seed: int = 0,
                 max_batch: int = 16) -> List[np.ndarray]:
        """List of (S_i,) int16-scale waveforms -> list of
        (n_frames_i, n_senones) float32 PPGs."""
        fo = self.opts.frame_opts
        prepped = []
        for w in wavs:
            w = np.asarray(w)
            if w.ndim >= 2:
                w = w[:, 0]
            w = w.astype(np.float64)
            if fs != fo.samp_freq:
                if not fo.allow_downsample or fs < fo.samp_freq:
                    raise ValueError(
                        f"Sample rate {fs} != {fo.samp_freq} and "
                        "allow_downsample is off")
                w = resample_waveform(w, fs, fo.samp_freq)
            prepped.append(w)

        out = []
        s_bucket = fo.window_shift * self.frame_bucket
        for lo in range(0, len(prepped), max_batch):
            chunk = prepped[lo:lo + max_batch]
            n_valid = np.array([num_frames(len(w), fo) for w in chunk])
            t_pad = round_up(int(n_valid.max()), self.frame_bucket)
            s_pad = round_up(max(len(w) for w in chunk), s_bucket)
            idx = np.zeros((len(chunk), t_pad, fo.window_size), np.int64)
            wav_mat = np.zeros((len(chunk), s_pad), np.float64)
            for i, w in enumerate(chunk):
                ix = frame_indices(len(w), fo)  # its own edge reflection
                idx[i, :len(ix)] = ix
                idx[i, len(ix):] = ix[-1]  # replicate the last valid frame
                wav_mat[i, :len(w)] = w
            gen = torch.Generator(self.device).manual_seed(seed + lo)
            with torch.no_grad():
                ppg = self._run(
                    torch.as_tensor(wav_mat, device=self.device),
                    torch.as_tensor(idx, device=self.device),
                    torch.as_tensor(n_valid, device=self.device), gen)
            ppg = ppg.cpu().numpy()
            out += [ppg[i, :n_valid[i]] for i in range(len(chunk))]
        return out


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
