"""Tensor parallelism over the mesh's model axis: the differentiable
collectives and a model's layout of split params.

Megatron's f / g operators, each a torch.autograd.Function over the model
group (parallel/mesh.py), the identity with no group:

  copy_to_model       identity forward; the gradient all-reduced (sum)
                      backward.  Goes on a replicated input that a rank
                      consumes through its slice of a weight, so that the
                      input's gradient sums every rank's part.
  reduce_from_model   all-reduce (sum) forward; identity backward.  Sums
                      the partial products of a contraction split.
  gather_from_model   all-gather along `dim` forward; this rank's slice of
                      the gradient backward.  Assembles an output split.

Each counts in `mesh.collectives` where it is issued and sends contiguous
tensors (NCCL refuses strided ones).  Under `torch.no_grad` (serving) only
the forward runs, so `copy_to_model` issues nothing.

`TensorParallel` is one model's layout on a mesh: the split record of every
param leaf (parallel/sharding.py's rules, evaluated on the whole params),
with which it cuts a rank's slices (`shard`), puts the whole params back
together (`gather`), makes the replicated leaves' gradients model rank
0's (`sync_replicated`), and tells the layers how a rank holds each
weight (`annotate`: a `Split` under the key "tp" of every layer dict
holding a split leaf; ops/layers.py reads it).  The JAX package partitions one
program with GSPMD instead (JAX parallel/sharding.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fac_via_ppg_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce,
    broadcast,
)
from fac_via_ppg_torch.parallel.sharding import (
    gather_leaf,
    shard_leaf,
    tree_leaves_specs,
    tree_paths,
)
from fac_via_ppg_torch.utils.tree import tree_leaves, tree_unflatten


# ------------------------------------------------------------- collectives

def _owned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of `t`'s values that no one else holds (the
    collectives write in place)."""
    c = t.contiguous()
    return c.clone() if c is t else c


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_owned(g), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(_owned(x), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return all_gather_cat(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, the gradient summed over `group` backward."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x` over `group` forward, identity
    backward."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    """Every rank's `x` of `group` concatenated along `dim` in rank order
    forward, this rank's slice of the gradient backward."""
    if group is None:
        return x
    import torch.distributed as dist

    dim = dim % x.dim()
    return _GatherFromModel.apply(x, group, dim, dist.get_rank(group))


# ------------------------------------------------------------------ layout

class Split(NamedTuple):
    """How this rank holds one layer's weights: `dims` maps a leaf's name
    to "out" (its dim 0 split: a rank computes its block of the output
    features) or "in" (its dim 1 split: a rank contracts its block of the
    input features); `group` is the model group, `rank` this rank's index
    in it."""
    group: object
    rank: int
    dims: dict


def _axis(entry):
    return entry[0] if isinstance(entry, tuple) else entry


def _is_model(spec) -> bool:
    return any(_axis(e) == "model" for e in spec)


class TensorParallel:
    """One model's tensor-parallel layout on `mesh`: `specs`, the split
    records of its params (a tree mirroring them, e.g.
    `tacotron2_param_shardings(mesh, whole_params)`), whose "model"
    entries this rank's slices follow.  `sharded[i]` says whether leaf i
    is split; `group` is the model group."""

    def __init__(self, mesh: Mesh, specs):
        self.mesh = mesh
        self.leaf_specs = [tuple(s) for s in tree_leaves_specs(specs)]
        self.sharded = [_is_model(s) for s in self.leaf_specs]
        self.group = mesh.model_group
        self.size = mesh.shape["model"]
        self.rank = mesh.model_rank

    def shard(self, params):
        """This rank's slice of every leaf of the whole `params`, each its
        own contiguous memory (the optimizer updates it in place)."""
        index = {"data": 0, "model": self.rank}
        sizes = {"data": 1, "model": self.size}
        return tree_unflatten(params, [
            shard_leaf(x, s, index, sizes).contiguous().clone() if split
            else x
            for x, s, split in zip(tree_leaves(params), self.leaf_specs,
                                   self.sharded)])

    def gather(self, params):
        """The whole params from every model rank's slices (a collective
        over the model group: every rank calls it)."""
        return tree_unflatten(params, [
            gather_leaf(x.detach(), s, self.mesh) if split else x
            for x, s, split in zip(tree_leaves(params), self.leaf_specs,
                                   self.sharded)])

    def sync_replicated(self, grads: list) -> list:
        """`grads` (in leaf order) with the replicated leaves' made model
        rank 0's on every rank of the model group: one broadcast of them
        flattened.  Every model rank computes those gradients from the
        same values, but a card's nondeterministic kernels (atomic
        scatter-adds, cuDNN's weight gradients) may round them apart, and
        replicated params must stay equal bit for bit."""
        idx = [i for i, split in enumerate(self.sharded) if not split]
        if not idx or self.group is None:
            return grads
        flat = broadcast(torch.cat([grads[i].reshape(-1).float()
                                    for i in idx]), self.group)
        out, at = list(grads), 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[at: at + n].view(grads[i].shape).to(grads[i].dtype)
            at += n
        return out

    def whole_shapes(self, params):
        """`params`' structure with a meta tensor of each leaf's whole
        shape (for code that reads shapes only)."""
        def whole(x, spec):
            shape = list(x.shape)
            for d, e in enumerate(spec):
                if _axis(e) == "model":
                    shape[d] *= self.size
            return torch.empty(shape, dtype=x.dtype, device="meta")

        return tree_unflatten(params, [whole(x, s) for x, s in zip(
            tree_leaves(params), self.leaf_specs)])

    def spec_fn(self, params):
        """(path, leaf) -> this layout's split record, for
        `optimizer_state_shardings(param_spec_fn=)` over a tree of
        `params`' structure (paths in `tree_paths`' form)."""
        by_path = dict(zip(tree_paths(params), self.leaf_specs))
        return lambda path, leaf: by_path[path]

    def annotate(self, params):
        """`params` with a `Split` under "tp" in every dict that holds a
        split leaf directly (the layer dicts); shallow copies, the leaves
        themselves untouched.  A leaf split on dim 0 is "out", on dim 1
        "in"."""
        it = iter(self.leaf_specs)

        def walk(t):
            if isinstance(t, dict):
                out, dims = {}, {}
                for k, v in t.items():
                    if isinstance(v, (dict, list)):
                        out[k] = walk(v)
                        continue
                    spec = next(it)
                    out[k] = v
                    if _is_model(spec):
                        dims[k] = "out" if _axis(spec[0]) == "model" \
                            else "in"
                if dims:
                    out["tp"] = Split(self.group, self.rank, dims)
                return out
            if isinstance(t, list):
                return [walk(v) for v in t]
            next(it)
            return t

        return walk(params)
