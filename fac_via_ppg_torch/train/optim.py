"""The optimizer and learning-rate schedules (the port of
fac_via_ppg_tpu/train/optim.py).

The reference trains with torch.optim.Adam(lr, weight_decay) and
clip_grad_norm_ before the step (train_ppg2mel.py:201-255,
train_waveglow.py:83), which is the JAX package's chain:

  g <- clip_by_global_norm(g, thresh)     (clip_grad_norm_)
  g <- g + weight_decay * p               (L2, not decoupled AdamW)
  Adam (0.9, 0.999), eps 1e-8, then the learning rate

The learning rate is rewritten in the Adam's param_groups every iteration
(train_ppg2mel.py:234-235; `set_learning_rate`)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from fac_via_ppg_torch.utils.tree import tree_leaves


class Optimizer:
    """What `make_optimizer` returns: Adam's settings and the clip
    threshold.  `init(params)` binds a torch.optim.Adam (the optimizer
    state) to the leaves of a parameter tree; `apply` steps it in place."""

    def __init__(self, learning_rate: float, weight_decay: float = 0.0,
                 grad_clip_thresh: Optional[float] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_thresh = grad_clip_thresh

    def init(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(tree_leaves(params), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)

    def apply(self, opt_state: torch.optim.Adam, grads) -> torch.Tensor:
        """One update of the bound leaves from `grads` (in leaf order):
        clip, then Adam with L2 weight decay.  Returns the gradients'
        global norm before clipping.  The clip scales `grads` in place."""
        leaves = [p for g in opt_state.param_groups for p in g["params"]]
        for p, g in zip(leaves, grads, strict=True):
            p.grad = g
        if self.grad_clip_thresh is not None and self.grad_clip_thresh > 0:
            gnorm = torch.nn.utils.clip_grad_norm_(leaves,
                                                   self.grad_clip_thresh)
        else:
            gnorm = global_norm(grads)
        opt_state.step()
        for p in leaves:
            p.grad = None
        return gnorm


def make_optimizer(learning_rate: float, weight_decay: float = 0.0,
                   grad_clip_thresh: Optional[float] = None) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, grad_clip_thresh)


def set_learning_rate(opt_state: torch.optim.Adam, lr: float) -> None:
    for group in opt_state.param_groups:
        group["lr"] = lr


def make_lr_schedule(base_lr: float, schedule: str = "constant",
                     warmup_steps: int = 0, decay_steps: int = 0,
                     decay_rate: float = 1.0, min_factor: float = 0.0):
    """Step -> learning rate, optax's formulas in plain Python.

    schedule: 'constant' | 'exponential' (base * decay_rate^(t /
    decay_steps)) | 'cosine' (to min_factor * base over decay_steps).  A
    linear warmup from 0 over `warmup_steps` precedes any of them, which
    then starts at step 0 again (optax.join_schedules).  The trainers
    evaluate it per iteration, so resume recomputes the learning rate from
    the restored iteration."""
    if schedule == "constant":
        def main(t):
            return base_lr
    elif schedule == "exponential":
        if decay_steps <= 0:
            raise ValueError("exponential schedule needs decay_steps > 0")

        def main(t):
            return base_lr if t <= 0 else \
                base_lr * decay_rate ** (t / decay_steps)
    elif schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs decay_steps > 0")

        def main(t):
            t = min(t, decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
            return base_lr * ((1 - min_factor) * cos + min_factor)
    else:
        raise ValueError(f"unknown lr schedule {schedule!r}; "
                         f"choose constant/exponential/cosine")

    def evaluate(step: int) -> float:
        if step < warmup_steps:
            return base_lr * max(step, 0) / warmup_steps
        return float(main(step - warmup_steps))

    return evaluate


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in tree_leaves(tree)))
