"""PPG -> mel dataset (the port of fac_via_ppg_tpu/data/
ppg_mel_dataset.py; reference src/common/data_utils.py:163-356).

As the reference's PPGMelLoader: every utterance is featurized when the
dataset is made (data_utils.py:204-209), with its pickle cache
(load_feats_from_disk / is_cache_feats / feats_cache_path); the file list
is shuffled by the seed (data_utils.py:192-193); `ppg_subsampling_factor`
subsamples rows on access; the collate sorts by PPG length, descending,
and zero-pads, with gate targets 1 from the last valid frame on
(data_utils.py:281-334).  `pad_to` rounds the padded lengths up to a
bucket, so that a step sees a bounded number of shapes.

The PPG runs the AM on `device` (frontend/ppg.py), the mel the port's
TacotronSTFT on it too.  With `featurize_device`, the whole front end
(MFCC -> CMN -> splice -> LDA -> TDNN) runs on `device` too, over padded
utterance buckets (frontend/ppg.py::DeviceFeaturizer), instead of the
host MFCC per utterance."""

from __future__ import annotations

import pickle
import random
from typing import List, Optional, Sequence

import numpy as np
import torch

from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.frontend.ppg import (
    DependenciesPPG,
    DeviceFeaturizer,
    get_ppg,
    reduce_ppg_dim,
)
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.numeric import round_up

# First order, dx(t) = 0.5(x(t + 1) - x(t - 1))
DELTA_WIN = [0, -0.5, 0.0, 0.5, 0]
# Second order
ACC_WIN = [0.25, 0, -0.5, 0, 0.25]


def load_filepaths(filename: str) -> List[str]:
    with open(filename) as f:
        return [line.strip() for line in f]


def compute_dynamic_matrix(data: np.ndarray,
                           win: Sequence[float]) -> np.ndarray:
    """(T, D) -> (T, D) dynamic features with edge-replicated padding
    (reference data_utils.py:62-114, vectorized)."""
    T = data.shape[0]
    half = len(win) // 2
    padded = np.concatenate([np.repeat(data[:1], half, axis=0), data,
                             np.repeat(data[-1:], half, axis=0)], axis=0)
    out = np.zeros_like(data, dtype=np.float64)
    for w, coeff in enumerate(win):
        if coeff != 0.0:
            out += coeff * padded[w:w + T]
    return out


def compute_delta_acc_feat(matrix: np.ndarray, is_delta=False, is_acc=False):
    """Append delta / delta-delta features (reference
    data_utils.py:117-139)."""
    if not is_delta and is_acc:
        raise ValueError(
            "To use delta-delta feats you have to also use delta feats.")
    parts = [matrix]
    if is_delta:
        parts.append(compute_dynamic_matrix(matrix, DELTA_WIN))
    if is_acc:
        parts.append(compute_dynamic_matrix(matrix, ACC_WIN))
    return np.concatenate(parts, axis=1)


def append_ppg(feats: np.ndarray, f0: np.ndarray) -> np.ndarray:
    """Append log-F0 + delta + acc (reference data_utils.py:142-160)."""
    n = min(feats.shape[0], f0.shape[0])
    feats = feats[:n]
    lf0 = np.log(f0[:n] + np.finfo(float).eps).reshape(-1, 1)
    lf0 = compute_delta_acc_feat(lf0, True, True)
    return np.concatenate((feats, lf0), axis=1)


class PPGMelDataset:
    """[ppg, mel] pairs, featurized when made (reference PPGMelLoader)."""

    def __init__(self, data_utterance_paths: str, hparams,
                 deps: Optional[DependenciesPPG] = None, device=None):
        self.data_utterance_paths = load_filepaths(data_utterance_paths)
        self.max_wav_value = hparams.max_wav_value
        self.is_full_ppg = hparams.is_full_ppg
        self.is_append_f0 = hparams.is_append_f0
        self.is_cache_feats = hparams.is_cache_feats
        self.load_feats_from_disk = hparams.load_feats_from_disk
        self.feats_cache_path = hparams.feats_cache_path
        self.ppg_subsampling_factor = hparams.ppg_subsampling_factor
        if self.is_cache_feats and self.load_feats_from_disk:
            raise ValueError("If you are loading feats from the disk, do "
                             "not rewrite them back!")
        self.device = resolve_device(device)
        self.stft = TacotronSTFT(
            hparams.filter_length, hparams.hop_length, hparams.win_length,
            hparams.n_acoustic_feat_dims, hparams.sampling_rate,
            hparams.mel_fmin, hparams.mel_fmax)
        random.Random(hparams.seed).shuffle(self.data_utterance_paths)

        self.ppg_sequences: List[np.ndarray] = []
        self.acoustic_sequences: List[np.ndarray] = []
        if self.load_feats_from_disk:
            print("Loading data from %s." % self.feats_cache_path)
            with open(self.feats_cache_path, "rb") as f:
                self.ppg_sequences, self.acoustic_sequences = pickle.load(f)
        else:
            self.ppg_deps = deps if deps is not None else DependenciesPPG()
            ppg_cache = None
            if getattr(hparams, "featurize_device", False):
                ppg_cache = self.featurize_on_device()
            for i, path in enumerate(self.data_utterance_paths):
                ppg_feat, acoustic = self.extract_utterance_feats(
                    path, self.is_full_ppg,
                    precomputed_ppg=(None if ppg_cache is None
                                     else ppg_cache[i]))
                self.ppg_sequences.append(ppg_feat.astype(np.float32))
                self.acoustic_sequences.append(acoustic)
        if self.is_cache_feats:
            print("Caching data to %s." % self.feats_cache_path)
            with open(self.feats_cache_path, "wb") as f:
                pickle.dump([self.ppg_sequences, self.acoustic_sequences], f)

    def featurize_on_device(self) -> List[np.ndarray]:
        """Every utterance's full PPG from one DeviceFeaturizer on the
        dataset's device, in file-list order."""
        wavs, rates = [], set()
        for path in self.data_utterance_paths:
            fs, wav = feat_mod.read_wav(path)
            rates.add(fs)
            wavs.append(wav)
        if len(rates) > 1:
            raise ValueError(f"mixed corpus sample rates {sorted(rates)}")
        featurizer = DeviceFeaturizer(self.ppg_deps, device=self.device)
        return featurizer(wavs, rates.pop())

    def extract_utterance_feats(self, path: str, is_full_ppg=False,
                                precomputed_ppg=None):
        """wav file -> (PPG (T, D), mel (T, n_mel)) (reference
        data_utils.py:215-258); `precomputed_ppg` (the device front end's)
        takes the place of the host featurization."""
        fs, wav = feat_mod.read_wav(path)
        if fs != self.stft.sampling_rate:
            raise ValueError("{} SR doesn't match target {} SR".format(
                fs, self.stft.sampling_rate))
        ppg = (precomputed_ppg if precomputed_ppg is not None
               else get_ppg(path, self.ppg_deps, device=self.device))
        audio_norm = torch.as_tensor(
            np.asarray(wav, dtype=np.float32) / self.max_wav_value,
            device=self.device)[None, :]
        mel = self.stft.mel_spectrogram(audio_norm)[0].T.cpu().numpy()
        if not is_full_ppg:
            # monophone training: the 40-dim senone -> phone reduction
            # (reference data_utils.py:253-258)
            ppg = reduce_ppg_dim(ppg, self.ppg_deps.monophone_trans)
        if self.is_append_f0:
            from fac_via_ppg_torch.utils.pitch import estimate_f0

            f0 = estimate_f0(np.asarray(wav, np.float64), fs,
                             frame_shift_ms=10.0)
            return append_ppg(ppg, f0), mel
        return ppg, mel

    def __getitem__(self, index: int):
        ppg = self.ppg_sequences[index]
        if self.ppg_subsampling_factor != 1:
            ppg = ppg[0::self.ppg_subsampling_factor, :]
        return ppg, self.acoustic_sequences[index]

    def __len__(self):
        return len(self.ppg_sequences)


def ppg_acoustics_collate(batch, pad_to: int = 1):
    """Zero-pad a list of (ppg (T1, D1), mel (T2, D2)) pairs.

    Returns (ppg_padded (B, D1, T1max), input_lengths, acoustic_padded
    (B, D2, T2max), gate_padded (B, T2max), output_lengths), sorted by
    input length, descending (reference data_utils.py:281-334); `pad_to`
    rounds both padded lengths up to a multiple."""
    input_lengths = np.array([x[0].shape[0] for x in batch], dtype=np.int64)
    order = np.argsort(-input_lengths)
    input_lengths = input_lengths[order]
    max_input_len = round_up(int(input_lengths[0]), pad_to)
    B = len(batch)
    ppg_padded = np.zeros((B, max_input_len, batch[0][0].shape[1]),
                          np.float32)
    for i, j in enumerate(order):
        ppg = batch[j][0]
        ppg_padded[i, :ppg.shape[0]] = ppg
    max_target_len = round_up(max(x[1].shape[0] for x in batch), pad_to)
    acoustic_padded = np.zeros((B, max_target_len, batch[0][1].shape[1]),
                               np.float32)
    gate_padded = np.zeros((B, max_target_len), np.float32)
    output_lengths = np.zeros(B, np.int64)
    for i, j in enumerate(order):
        acoustic = batch[j][1]
        acoustic_padded[i, :acoustic.shape[0]] = acoustic
        gate_padded[i, acoustic.shape[0] - 1:] = 1
        output_lengths[i] = acoustic.shape[0]
    return (ppg_padded.transpose(0, 2, 1), input_lengths,
            acoustic_padded.transpose(0, 2, 1), gate_padded, output_lengths)


def utt_to_sequence(ppg: np.ndarray) -> np.ndarray:
    """(T, D) PPG -> (1, D, T) model input (reference
    data_utils.py:337-356)."""
    return ppg.T[None, :, :].astype(np.float32)


class EpochBatcher:
    """Shuffled fixed-size batches, one process (torch DataLoader's
    role): the order is a pure function of (seed, epoch), the JAX
    package's, which also shards it across hosts (ROADMAP queue 1 item 6
    for the port)."""

    def __init__(self, dataset, batch_size: int, seed: int, collate_fn,
                 drop_last: bool = True, pad_to: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.pad_to = pad_to
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = list(range(len(self.dataset)))
        random.Random(self.seed + self.epoch).shuffle(order)
        B = self.batch_size
        for step in range(len(self)):
            idx = order[step * B:(step + 1) * B]
            yield self.collate_fn([self.dataset[j] for j in idx],
                                  pad_to=self.pad_to)
        self.epoch += 1
