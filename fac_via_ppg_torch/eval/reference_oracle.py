"""The reference implementation, read-only from its mount, as a CPU oracle
for eval/parity.py (the port's own copy of what the JAX package's
tests/torch_oracle.py does for it).

The reference's modules are imported as they are from REFERENCE_SRC, its
`src/` directory wherever it is mounted (the FACPPG_REFERENCE_SRC
environment variable).  Its absent dependencies are stubbed: librosa's
three helpers by the port's own (dsp/mel.py, dsp/stft.py), pykaldi /
textgrid / tensorboardX by modules whose attributes are mocks, its
generated protobuf module by the port's wire-compatible one (io/proto/),
imported only here; its CUDA-only mask helpers are replaced by CPU ones.
Without the sources, ReferenceUnavailable.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

import numpy as np

REFERENCE_SRC = os.environ.get("FACPPG_REFERENCE_SRC", "")
_loaded = {}


class ReferenceUnavailable(FileNotFoundError):
    """The reference's sources are not mounted."""


def _stub_librosa():
    if "librosa" in sys.modules:
        return
    from fac_via_ppg_torch.dsp.mel import mel_filterbank
    from fac_via_ppg_torch.dsp.stft import pad_center

    librosa = types.ModuleType("librosa")
    util = types.ModuleType("librosa.util")
    filters = types.ModuleType("librosa.filters")
    util.pad_center = lambda data, size, **kw: pad_center(np.asarray(data),
                                                          size)
    util.tiny = lambda x: np.finfo(np.asarray(x).dtype).tiny

    def normalize(S, norm=None, **kwargs):
        if norm is None:
            return S
        raise NotImplementedError

    util.normalize = normalize
    filters.mel = lambda sr, n_fft, n_mels=128, fmin=0.0, fmax=None, **kw: \
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    librosa.util, librosa.filters = util, filters
    sys.modules.update({"librosa": librosa, "librosa.util": util,
                        "librosa.filters": filters})


def _stub_absent_packages():
    from unittest.mock import MagicMock

    for name in ("kaldi", "kaldi.feat", "kaldi.feat.mfcc", "kaldi.feat.wave",
                 "kaldi.feat.functions", "kaldi.matrix",
                 "kaldi.matrix.common", "kaldi.matrix.sparse", "kaldi.util",
                 "kaldi.util.io", "kaldi.nnet3", "textgrid", "tensorboardX"):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__getattr__ = lambda attr: MagicMock(name=attr)
            sys.modules[name] = mod
    if "common.data_utterance_pb2" not in sys.modules:
        from fac_via_ppg_torch.io.proto import data_utterance_pb2

        sys.modules["common.data_utterance_pb2"] = data_utterance_pb2


def load_reference_module(name: str):
    """Import e.g. 'common.model' from the mount."""
    if name in _loaded:
        return _loaded[name]
    if not REFERENCE_SRC or not os.path.isdir(REFERENCE_SRC):
        raise ReferenceUnavailable(
            f"the reference's sources are not mounted (FACPPG_REFERENCE_SRC"
            f"={REFERENCE_SRC!r})")
    _stub_librosa()
    _stub_absent_packages()
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    _loaded[name] = importlib.import_module(name)
    return _loaded[name]


def reference_tacotron2_module():
    """The reference's `common.model`, its CUDA-only mask helpers replaced
    by CPU ones."""
    import torch

    model = load_reference_module("common.model")

    def get_mask_from_lengths(lengths):
        ids = torch.arange(0, int(torch.max(lengths).item()),
                           dtype=torch.long)
        return ids < lengths.unsqueeze(1)

    def get_mask_window(lengths, attention_window_size, time_step):
        mask = torch.ones(len(lengths), int(torch.max(lengths).item()),
                          dtype=torch.bool)
        for ii in range(len(lengths)):
            max_idx = int(lengths[ii]) - 1
            start = min(max(0, time_step - attention_window_size), max_idx)
            end = min(time_step + attention_window_size, max_idx)
            if start <= end:
                mask[ii, start:end + 1] = 0
        return mask

    model.get_mask_from_lengths = get_mask_from_lengths
    model.get_mask_from_lengths_window_and_time_step = get_mask_window
    return model


class on_cpu:
    """Context manager for running the reference's inference code on the
    CPU: its legacy `torch.cuda.*Tensor` constructors (glow.py:261-268,
    284-289; model.py:598) point at their CPU twins, `.cuda()` is a no-op
    (denoiser.py:42-64) and torch.nn.functional.dropout is off (the
    reference's prenet hardcodes training=True, model.py:134).  Everything
    is restored on exit, so that the port's own CUDA code runs beside it."""

    _NAMES = ("FloatTensor", "HalfTensor", "LongTensor")

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        self._saved = ({n: getattr(torch.cuda, n) for n in self._NAMES},
                       torch.Tensor.cuda, torch.nn.Module.cuda, F.dropout)
        for n in self._NAMES:
            setattr(torch.cuda, n, getattr(torch, n))
        torch.Tensor.cuda = lambda self, *a, **k: self
        torch.nn.Module.cuda = lambda self, *a, **k: self
        F.dropout = lambda x, p=0.5, training=False, inplace=False: x
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F

        ctors, torch.Tensor.cuda, torch.nn.Module.cuda, F.dropout = \
            self._saved
        for n, c in ctors.items():
            setattr(torch.cuda, n, c)
        return False
