"""The optimizer and learning-rate schedules (the port of
fac_via_ppg_tpu/train/optim.py).

The reference trains with torch.optim.Adam(lr, weight_decay) and
clip_grad_norm_ before the step (train_ppg2mel.py:201-255,
train_waveglow.py:83), which is the JAX package's chain:

  g <- clip_by_global_norm(g, thresh)     (clip_grad_norm_)
  g <- g + weight_decay * p               (L2, not decoupled AdamW)
  Adam (0.9, 0.999), eps 1e-8, then the learning rate

The learning rate is rewritten in the Adam's param_groups every iteration
(train_ppg2mel.py:234-235; `set_learning_rate`).

ZeRO-1 (`init(params, mesh=, zero=True)`, JAX
`parallel/sharding.py::optimizer_state_shardings`): each rank of the data
group keeps the Adam moments of its slice of every leaf only, updates
that slice of the param from the (already averaged) full gradient, and
all-gathers the params.  Adam is elementwise, so the params equal the
unsharded step's bit for bit.  Its state_dict is the unsharded Adam's,
moments gathered, whatever the world size.

Tensor parallelism (`init(params, mesh=, tp=)`, parallel/tp.py): the
leaves are this rank's slices of the split params and the whole
replicated ones.  The clip's global norm sums the split leaves' squares
over the model group and counts each replicated leaf once, so it is the
one-process norm on every rank; ZeRO-1 composes (JAX
`optimizer_state_shardings(param_spec_fn=...)`): a moment keeps its
param's model split and adds a data split on another dim, the updated
slice all-gathered over the data group only.  The state_dict gathers the
moments over both axes."""

from __future__ import annotations

import math
from typing import Optional

import torch

from fac_via_ppg_torch.parallel.mesh import all_reduce
from fac_via_ppg_torch.parallel.sharding import (
    gather_leaf,
    optimizer_state_shardings,
    shard_leaf,
    tree_leaves_specs,
)
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

    def _adam(self, leaves) -> torch.optim.Adam:
        return torch.optim.Adam(leaves, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)

    def init(self, params, mesh=None, zero: bool = False, tp=None):
        """A torch.optim.Adam bound to the leaves of `params`; with
        `zero` and a mesh whose data axis is above 1 (ZeRO-1), or with a
        tensor-parallel layout `tp` (`params` this rank's slices), a
        `ZeroAdam` instead.  A data axis of 1 makes `zero` a no-op, as in
        JAX."""
        zero = zero and mesh is not None and mesh.shape["data"] > 1
        if zero or tp is not None:
            return ZeroAdam(self, params, mesh, tp, zero)
        return self._adam(tree_leaves(params))

    def _clip(self, leaves, grads, tp=None) -> torch.Tensor:
        """Bind `grads` to `leaves` and clip them in place; the global
        norm before clipping (over the model group under `tp`)."""
        for p, g in zip(leaves, grads, strict=True):
            p.grad = g
        if tp is not None:
            total = global_norm(grads, tp)
            if self.grad_clip_thresh is not None \
                    and self.grad_clip_thresh > 0:
                # torch.nn.utils.clip_grad_norm_'s coefficient
                coef = torch.clamp(self.grad_clip_thresh / (total + 1e-6),
                                   max=1.0)
                torch._foreach_mul_(list(grads), coef)
            return total
        if self.grad_clip_thresh is not None and self.grad_clip_thresh > 0:
            return torch.nn.utils.clip_grad_norm_(leaves,
                                                  self.grad_clip_thresh)
        return global_norm(grads)

    def apply(self, opt_state, grads) -> torch.Tensor:
        """One update of the bound leaves from `grads` (in leaf order):
        clip, then Adam with L2 weight decay.  Returns the gradients'
        global norm before clipping.  The clip scales `grads` in place."""
        if isinstance(opt_state, ZeroAdam):
            return opt_state.apply(grads)
        leaves = [p for g in opt_state.param_groups for p in g["params"]]
        gnorm = self._clip(leaves, grads)
        opt_state.step()
        for p in leaves:
            p.grad = None
        return gnorm


def _data_only(spec) -> tuple:
    """A split record's "data" entries alone: how a rank's ZeRO-1 slice
    is cut from its tensor-parallel slice of a leaf."""
    return tuple(e if e == "data" else None for e in spec)


class ZeroAdam:
    """The optimizer state over a mesh: a torch.optim.Adam over this
    rank's slices of the param leaves.  `specs` are the moments' split
    records relative to the whole leaves (parallel/sharding.py::
    optimizer_state_shardings: over the data axis with `zero` (ZeRO-1),
    the tensor-parallel layout `tp`'s model splits first).  The leaves
    are already this rank's model slices, so a rank cuts only the "data"
    entries off them, updates that slice from the same slice of the
    (averaged, clipped) gradients and all-gathers it over the data group.
    Leaves with no data split are updated whole.  `param_groups`,
    `state_dict` and `load_state_dict` read as the unsharded Adam's."""

    def __init__(self, optimizer: Optimizer, params, mesh, tp=None,
                 zero: bool = True):
        self._opt, self._mesh, self.tp = optimizer, mesh, tp
        self.leaves = tree_leaves(params)
        if tp is None:
            whole, spec_fn = params, None
        else:
            whole, spec_fn = tp.whole_shapes(params), tp.spec_fn(params)
        if zero:
            self.specs = tree_leaves_specs(optimizer_state_shardings(
                mesh, whole, param_spec_fn=spec_fn))
        else:
            self.specs = list(tp.leaf_specs)
        self.zero_specs = [_data_only(s) for s in self.specs]
        self._index = {"data": mesh.data_rank, "model": mesh.model_rank}
        self.local = [self._slice(p, z).clone() if any(z) else p
                      for p, z in zip(self.leaves, self.zero_specs)]
        self.adam = optimizer._adam(self.local)

    def _slice(self, x, spec):
        return shard_leaf(x, spec, self._index, self._mesh.shape)

    @property
    def param_groups(self):
        return self.adam.param_groups

    def apply(self, grads) -> torch.Tensor:
        gnorm = self._opt._clip(self.leaves, grads, self.tp)
        for p, loc, z in zip(self.leaves, self.local, self.zero_specs):
            if any(z):
                loc.grad = self._slice(p.grad, z).contiguous()
        self.adam.step()
        with torch.no_grad():
            for p, loc, z in zip(self.leaves, self.local, self.zero_specs):
                p.grad = None
                if any(z):
                    loc.grad = None
                    p.copy_(gather_leaf(loc, z, self._mesh))
        return gnorm

    def state_dict(self) -> dict:
        """The unsharded Adam's state_dict: every moment gathered whole,
        over both axes (a collective: every rank calls it)."""
        sd = self.adam.state_dict()
        for i, s in enumerate(self.specs):
            st = sd["state"].get(i)
            if st is None or not any(s):
                continue
            sd["state"][i] = {k: gather_leaf(v, s, self._mesh)
                              if k.startswith("exp_avg") else v
                              for k, v in st.items()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """An unsharded Adam's state_dict (any mesh's): this rank keeps
        its slices of the moments, model and data."""
        sd = {"state": {i: {k: self._slice(v, self.specs[i]).clone()
                            if k.startswith("exp_avg") and any(
                                self.specs[i]) else v
                            for k, v in st.items()}
                        for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        self.adam.load_state_dict(sd)


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


def global_norm(tree, tp=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  Under a
    tensor-parallel layout `tp` (`tree` in its leaf order, this rank's
    slices) the split leaves' squares are summed over the model group
    and the replicated leaves counted once: every rank gets the norm of
    the whole tree."""
    leaves = tree_leaves(tree)
    if tp is None:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    norms = [torch.linalg.vector_norm(g.float()) for g in leaves]
    split = [n for n, s in zip(norms, tp.sharded) if s]
    whole = [n for n, s in zip(norms, tp.sharded) if not s]
    zero = norms[0].new_zeros(())
    sq = torch.stack([torch.sum(torch.stack(split) ** 2) if split else zero,
                      torch.sum(torch.stack(whole) ** 2) if whole else zero])
    total = all_reduce(sq[:1].clone(), tp.group) + sq[1:]
    return torch.sqrt(total[0])
