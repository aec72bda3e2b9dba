"""Bridge from the JAX package's parameter pytrees to the port.

The JAX pytrees are nested dicts / lists whose leaves are already in torch
layout (Linear (out, in), Conv1d (out, in, k), ConvTranspose1d (in, out, k),
LSTM gates i,f,g,o), so conversion is a leaf-by-leaf copy with no renaming.
Leaves may be numpy arrays or JAX arrays (read through `np.asarray`; this
module does not import JAX).

WaveGlow comes in either of its JAX forms: the train form, whose weight-norm
(g, v) pairs are folded here exactly as the JAX package's
`_weight_norm_fold` does (f32 norm), or the `remove_weightnorm` form,
whose `convinv[k].weight_inverse` is kept.  `fold_waveglow` folds a tree
that is already torch (the reference checkpoint's, train/import_torch.py);
`fold_wn` folds one coupling net, inside the training forward's graph.
`waveglow_train_from_jax` keeps the train form as it is: g, v and the
biases, the trainable parameters of the weight-norm convs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_torch(tree, device: Optional[torch.device] = None):
    """Nested dicts/lists of arrays -> the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def move(tree, device: torch.device):
    """The same structure with every tensor on `device`."""
    if isinstance(tree, dict):
        return {k: move(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [move(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def tacotron2_from_jax(params, state, device: Optional[torch.device] = None):
    """JAX Tacotron2 (params, BN state) -> the port's (params, state)."""
    return to_torch(params, device), to_torch(state, device)


def _weight_norm_fold(p: dict) -> dict:
    """(g, v, bias) -> (weight, bias): w = g * v / ||v|| per output
    channel, the norm in f32 (fac_via_ppg_tpu models/waveglow.py:80-87)."""
    v = p["v"]
    vf = v.float()
    norm = torch.sqrt(torch.sum(vf ** 2, dim=(1, 2), keepdim=True))
    w = p["g"].float()[:, None, None] * vf / norm
    return {"weight": w.to(v.dtype), "bias": p["bias"]}


def fold_wn(wn: dict) -> dict:
    """One coupling net's params, (g, v) or folded -> folded."""
    def fold(p):
        return _weight_norm_fold(p) if "v" in p else p

    return {
        "start": fold(wn["start"]),
        "end": fold(wn["end"]),
        "in_layers": [fold(p) for p in wn["in_layers"]],
        "cond_layers": [fold(p) for p in wn["cond_layers"]],
        "res_skip_layers": [fold(p) for p in wn["res_skip_layers"]],
    }


def fold_waveglow(params):
    """WaveGlow params of tensors, train (g, v) or folded form -> the
    port's folded form (a `weight_inverse` already there is kept)."""
    return {"upsample": params["upsample"], "convinv": params["convinv"],
            "wn": [fold_wn(wn) for wn in params["wn"]]}


def waveglow_from_jax(params, device: Optional[torch.device] = None):
    """JAX WaveGlow params (train or remove_weightnorm form) -> the port's
    folded form."""
    return fold_waveglow(to_torch(params, device))


def waveglow_train_from_jax(params, device: Optional[torch.device] = None):
    """JAX WaveGlow params in the train form -> the same tree of tensors,
    weight norm kept unfolded (models/waveglow.py::waveglow_forward)."""
    return to_torch(params, device)
