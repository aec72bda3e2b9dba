"""Synthetic 16 kHz speech-like corpus generator (a copy of
fac_via_ppg_tpu/scripts/make_corpus.py: the same arguments and seed write
byte-identical wavs and filelists).

The environment has no L2-ARCTIC data (the reference trains on it,
reference src/common/hparams.py:69-74 filelists), so training studies and
the trained-checkpoint parity loop run on a generated corpus with the
acoustic structure the models actually have to learn:

  * voiced segments: glottal pulse train with a per-utterance f0 contour
    (declination + slow random walk) through a cascade of 3 formant
    resonators that move piecewise every 80-250 ms ("phones"),
  * unvoiced segments: formant-filtered noise bursts (fricative-like),
  * syllabic amplitude modulation and short intra-utterance pauses,
  * leading/trailing silence so the gate head has a real stop to learn,
  * durations drawn from [min_seconds, max_seconds] so batches exercise
    the length-bucketing path.

Writes out_dir/wavs/utt####.wav plus filelists/training-set.txt and
filelists/validation-set.txt (one absolute wav path per line, the format
hparams.training_files expects — reference src/common/utils.py:92).

Two difficulty styles:

  * --style formant (default): the full random phone-sequence corpus
    above.  Realistic segmental structure, but the PPG→mel mapping has
    irreducible content unpredictability.
  * --style vowel: sustained vowel-like utterances (one fixed formant
    set and near-constant f0 per utterance) — a near-deterministic
    mapping that lets gate/duration-convergence studies isolate
    stop-token learning from content unpredictability.

Usage:
  python -m fac_via_ppg_torch.scripts.make_corpus OUT_DIR \
      [--n_train 24] [--n_val 4] [--seed 16807] \
      [--min_seconds 2.0] [--max_seconds 4.5] [--style formant|vowel]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter

SR = 16000


def _resonator(freq: float, bw: float, sr: int = SR):
    """Second-order all-pole resonator (b, a) at `freq` Hz, bandwidth `bw`."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = np.array([1.0, -2 * r * np.cos(theta), r * r])
    return np.array([1.0 - r]), a


def _segment(rng: np.random.RandomState, n: int, f0: np.ndarray,
             voiced: bool) -> np.ndarray:
    """One phone-like segment: excitation through 3 formant resonators."""
    if voiced:
        # impulse train by phase accumulation over the local f0 contour
        phase = np.cumsum(f0 / SR)
        exc = (np.floor(phase) - np.floor(np.concatenate([[0.0], phase[:-1]])))
        exc = exc.astype(np.float64)
        exc += 0.02 * rng.randn(n)  # aspiration noise
        formants = rng.uniform([300, 900, 2200], [900, 2300, 3400])
        bws = rng.uniform([60, 90, 120], [120, 160, 220])
    else:
        exc = rng.randn(n) * 0.5
        formants = rng.uniform([1500, 3000, 5000], [2500, 4500, 6500])
        bws = rng.uniform([200, 300, 400], [400, 600, 800])
    y = exc
    for f, bw in zip(formants, bws):
        b, a = _resonator(float(f), float(bw))
        y = lfilter(b, a, y)
    return y


def make_utterance(rng: np.random.RandomState, seconds: float) -> np.ndarray:
    """One speech-like utterance, float64 in [-1, 1]."""
    n = int(seconds * SR)
    lead = int(rng.uniform(0.08, 0.2) * SR)
    tail = int(rng.uniform(0.15, 0.3) * SR)
    n_speech = max(n - lead - tail, SR // 2)

    # per-utterance f0 contour: base pitch, declination, slow vibrato-ish walk
    base = rng.uniform(95, 220)
    t = np.arange(n_speech) / SR
    walk = np.cumsum(rng.randn(n_speech)) * 0.003
    walk -= np.linspace(0, walk[-1], n_speech)  # detrend the walk
    f0 = base * (1.0 - 0.12 * t / t[-1]) * np.exp(walk)

    sig = np.zeros(n_speech)
    pos = 0
    while pos < n_speech:
        seg_len = int(rng.uniform(0.08, 0.25) * SR)
        seg_len = min(seg_len, n_speech - pos)
        kind = rng.rand()
        if kind < 0.12 and pos > 0:  # short intra-utterance pause
            seg = np.zeros(seg_len)
        else:
            voiced = kind < 0.72
            seg = _segment(rng, seg_len, f0[pos : pos + seg_len], voiced)
            # syllabic envelope: raised-cosine attack/decay
            env = np.ones(seg_len)
            edge = max(min(seg_len // 4, int(0.02 * SR)), 1)
            ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, edge))
            env[:edge] *= ramp
            env[-edge:] *= ramp[::-1]
            seg = seg * env * rng.uniform(0.5, 1.0)
        sig[pos : pos + seg_len] = seg
        pos += seg_len

    sig = sig / (np.max(np.abs(sig)) + 1e-9) * 0.55
    return np.concatenate([np.zeros(lead), sig, np.zeros(tail)])


def make_vowel_utterance(rng: np.random.RandomState,
                         seconds: float) -> np.ndarray:
    """One sustained vowel-like utterance (--style vowel): a single
    voiced segment with fixed formants and near-constant f0 (5 Hz
    vibrato), 30 ms raised-cosine edges, 0.1 s lead / 0.2 s tail
    silence."""
    n = int(seconds * SR)
    lead = int(0.1 * SR)
    tail = int(0.2 * SR)
    ns = max(n - lead - tail, SR // 2)
    f0 = rng.uniform(100, 200)
    t = np.arange(ns) / SR
    phase = np.cumsum((f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR)
    exc = np.floor(phase) - np.floor(np.concatenate([[0.0], phase[:-1]]))
    exc += 0.01 * rng.randn(ns)
    formants = rng.uniform([350, 1000, 2300], [800, 2200, 3200])
    y = exc
    for f in formants:
        b, a = _resonator(float(f), 90.0)
        y = lfilter(b, a, y)
    edge = int(0.03 * SR)
    env = np.ones(ns)
    ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, edge))
    env[:edge] *= ramp
    env[-edge:] *= ramp[::-1]
    y = y * env
    y = y / (np.max(np.abs(y)) + 1e-9) * 0.55
    return np.concatenate([np.zeros(lead), y, np.zeros(tail)])


def make_corpus(out_dir: str, n_train: int = 24, n_val: int = 4,
                seed: int = 16807, min_seconds: float = 2.0,
                max_seconds: float = 4.5, style: str = "formant") -> dict:
    wav_dir = os.path.join(out_dir, "wavs")
    fl_dir = os.path.join(out_dir, "filelists")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(fl_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    if style not in ("formant", "vowel"):
        raise ValueError(f"unknown corpus style {style!r}")
    gen = make_utterance if style == "formant" else make_vowel_utterance
    for i in range(n_train + n_val):
        seconds = rng.uniform(min_seconds, max_seconds)
        wav = gen(rng, seconds)
        path = os.path.join(wav_dir, f"utt{i:04d}.wav")
        wavfile.write(path, SR, (wav * 32767 * 0.9).astype(np.int16))
        paths.append(path)
    train_list = os.path.join(fl_dir, "training-set.txt")
    val_list = os.path.join(fl_dir, "validation-set.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(paths[:n_train]) + "\n")
    with open(val_list, "w") as f:
        f.write("\n".join(paths[n_train:]) + "\n")
    return {"training_files": train_list, "validation_files": val_list,
            "wavs": paths}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("--n_train", type=int, default=24)
    parser.add_argument("--n_val", type=int, default=4)
    parser.add_argument("--seed", type=int, default=16807)
    parser.add_argument("--min_seconds", type=float, default=2.0)
    parser.add_argument("--max_seconds", type=float, default=4.5)
    parser.add_argument("--style", default="formant",
                        choices=("formant", "vowel"))
    args = parser.parse_args()
    out = make_corpus(args.out_dir, args.n_train, args.n_val, args.seed,
                      args.min_seconds, args.max_seconds, args.style)
    print(out["training_files"])
    print(out["validation_files"])
