"""WaveGlow data (the port of fac_via_ppg_tpu/data/mel2samp.py; reference
src/waveglow/mel2samp.py:42-147).

Random fixed-length crops -> (mel, audio) pairs: the file list shuffled by
the seed, an in-process wav cache, `segment_length` crops at offsets from
one seeded random.Random (drawn in the JAX package's order), short files
zero-padded, the mel from the port's TacotronSTFT on the CPU."""

from __future__ import annotations

import random
from typing import List

import numpy as np
import torch

from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.frontend import feat as feat_mod

MAX_WAV_VALUE = 32768.0


def files_to_list(filename: str) -> List[str]:
    with open(filename, encoding="utf-8") as f:
        return [line.rstrip() for line in f.readlines()]


class Mel2Samp:
    def __init__(self, training_files, segment_length, filter_length,
                 hop_length, win_length, sampling_rate, mel_fmin, mel_fmax,
                 n_mel_channels: int = 80, seed: int = 1234):
        self.audio_files = files_to_list(training_files)
        self._rng = random.Random(seed)
        self._rng.shuffle(self.audio_files)
        self.stft = TacotronSTFT(
            filter_length=filter_length, hop_length=hop_length,
            win_length=win_length, n_mel_channels=n_mel_channels,
            sampling_rate=sampling_rate, mel_fmin=mel_fmin,
            mel_fmax=mel_fmax)
        self.segment_length = segment_length
        self.sampling_rate = sampling_rate
        self.wav_cache = {}

    def get_mel(self, audio: np.ndarray) -> np.ndarray:
        audio_norm = torch.as_tensor(
            audio.astype(np.float32) / MAX_WAV_VALUE)[None, :]
        return self.stft.mel_spectrogram(audio_norm)[0].numpy()  # (n_mel, T)

    def __getitem__(self, index: int):
        filename = self.audio_files[index]
        if filename in self.wav_cache:
            audio, fs = self.wav_cache[filename]
        else:
            fs, audio = feat_mod.read_wav(filename)
            audio = audio.astype(np.float32)
            self.wav_cache[filename] = (audio, fs)
        if fs != self.sampling_rate:
            raise ValueError("{} SR doesn't match target {} SR".format(
                fs, self.sampling_rate))
        if len(audio) >= self.segment_length:
            start = self._rng.randint(0, len(audio) - self.segment_length)
            audio = audio[start:start + self.segment_length]
        else:
            audio = np.pad(audio, (0, self.segment_length - len(audio)))
        return self.get_mel(audio), audio / MAX_WAV_VALUE

    def __len__(self):
        return len(self.audio_files)


def mel2samp_collate(batch, pad_to: int = 1):
    """Stack fixed-size (mel, audio) pairs."""
    mels = np.stack([b[0] for b in batch]).astype(np.float32)
    audios = np.stack([b[1] for b in batch]).astype(np.float32)
    return mels, audios
