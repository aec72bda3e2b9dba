"""Matplotlib Agg rasterizers for TensorBoard images (the port of
fac_via_ppg_tpu/train/plotting.py; reference src/common/
plotting_utils.py:46-108).  matplotlib is imported when a plot is drawn,
not with this module."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pylab as plt

    return plt


def _fig_to_numpy(plt, fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return data.copy()


def plot_alignment_to_numpy(alignment: np.ndarray, info=None) -> np.ndarray:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    plt.xlabel(xlabel)
    plt.ylabel("Encoder timestep")
    plt.tight_layout()
    return _fig_to_numpy(plt, fig)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    return _fig_to_numpy(plt, fig)


def plot_ppg_to_numpy(ppg: np.ndarray) -> np.ndarray:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(ppg, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("PPG index")
    plt.tight_layout()
    return _fig_to_numpy(plt, fig)


def plot_gate_outputs_to_numpy(gate_targets, gate_outputs) -> np.ndarray:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.scatter(range(len(gate_targets)), gate_targets, alpha=0.5,
               color="green", marker="+", s=1, label="target")
    ax.scatter(range(len(gate_outputs)), gate_outputs, alpha=0.5,
               color="red", marker=".", s=1, label="predicted")
    plt.xlabel("Frames (Green target, Red predicted)")
    plt.ylabel("Gate State")
    plt.tight_layout()
    return _fig_to_numpy(plt, fig)
