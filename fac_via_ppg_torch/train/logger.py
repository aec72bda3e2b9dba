"""TensorBoard loggers (the port of fac_via_ppg_tpu/train/logger.py;
reference src/common/logger.py:41-94), with the JAX package's tags.

torch's SummaryWriter needs the `tensorboard` package and the images need
matplotlib; both are imported when a logger is made.  Where one is
missing the logger says so once on stderr and skips what needs it: the
trainers' stdout lines and the device work are unaffected."""

from __future__ import annotations

import sys

import numpy as np
import torch


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Logger:
    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"logger: TensorBoard logging is off ({e})",
                  file=sys.stderr)
            self.writer = None
        else:
            self.writer = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class Tacotron2Logger(_Logger):
    def __init__(self, logdir: str):
        super().__init__(logdir)
        self._images = True

    def log_training(self, reduced_loss, grad_norm, learning_rate, duration,
                     iteration):
        self.add_scalar("training.loss", reduced_loss, iteration)
        self.add_scalar("grad.norm", grad_norm, iteration)
        self.add_scalar("learning.rate", learning_rate, iteration)
        self.add_scalar("duration", duration, iteration)

    def log_validation(self, reduced_loss, params, y, y_pred, iteration):
        self.add_scalar("validation.loss", reduced_loss, iteration)
        if self.writer is None:
            return
        # per-parameter value histograms (reference logger.py:59-61); the
        # tags are the leaves' paths in the tree
        for tag, value in _paths(params):
            self.writer.add_histogram(tag, _np(value), iteration)
        if not self._images:
            return
        from fac_via_ppg_torch.train import plotting

        mel_outputs, mel_outputs_postnet, gate_outputs, alignments = y_pred
        mel_targets, gate_targets = y
        idx = np.random.randint(0, alignments.shape[0])
        try:
            images = {
                "alignment": plotting.plot_alignment_to_numpy(
                    _np(alignments[idx]).T),
                "mel_target": plotting.plot_spectrogram_to_numpy(
                    _np(mel_targets[idx])),
                "mel_predicted": plotting.plot_spectrogram_to_numpy(
                    _np(mel_outputs_postnet[idx])),
                "mel_predicted_no_postnet":
                    plotting.plot_spectrogram_to_numpy(
                        _np(mel_outputs[idx])),
                "gate": plotting.plot_gate_outputs_to_numpy(
                    _np(gate_targets[idx]),
                    _sigmoid(_np(gate_outputs[idx]))),
            }
        except ImportError as e:
            print(f"logger: validation images are off ({e})",
                  file=sys.stderr)
            self._images = False
            return
        for tag, img in images.items():
            self.writer.add_image(tag, img, iteration, dataformats="HWC")


class WaveglowLogger(_Logger):
    def log_training(self, reduced_loss, iteration):
        self.add_scalar("training.loss", reduced_loss, iteration)


def _paths(tree, prefix=""):
    """(path, leaf) pairs, the path as the JAX package's keystr without
    quotes and brackets, e.g. `encoder][convolutions][0][bn][weight`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}][{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}][{i}" if prefix else str(i))
    else:
        yield prefix, tree
