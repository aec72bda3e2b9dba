"""Parameter and optimizer-state placement rules over a mesh (TP over the
'model' axis; ZeRO-1 over the 'data' axis).

The port of fac_via_ppg_tpu/parallel/sharding.py.  A JAX PartitionSpec
becomes a split record: a tuple with one entry per dim of the leaf, None
where the dim is whole, the axis name ("data" / "model") where it is split
into contiguous blocks over that axis, or (axis, groups) where the dim is
`groups` equal blocks each split over the axis (the paired split below).
`apply_shardings` cuts this rank's slice of every leaf; `gather_shards`
puts the full tensors back together (for checkpoints).

Tacotron2: the JAX rules and thresholds, leaf for leaf (the encoder
prenet's PPG-facing matrix split on its 5816-wide contraction dim; the
other big matrices and the conv stacks on their output dim), executed
by the tensor-parallel train step (parallel/tp.py, ops/layers.py).

WaveGlow: the port's own rule, Megatron's pairing.  JAX splits
`in_layers` dim 0 contiguously, so the tanh half and the sigmoid half of
the gate land on different shards and GSPMD reshards before the gate.
Here model rank m takes channels [m C/p, (m+1) C/p) of both gate halves of
every `in_layers` and `cond_layers` conv (split (model, 2) on dim 0), so
the gate is local; `res_skip_layers` is split on its input channel
(row-parallel), so its output is a partial sum: one all-reduce of the C
residual channels per layer, and the skip sum all-reduced once before
`end` (models/waveglow.py::wn_apply(model_group=)).  start, end, convinv
and the upsampler stay whole.  In the train form (g, v, bias) the
res_skip v splits on its input channel and its g and bias stay whole, so
its weight norm sums the ranks' squares (models/waveglow.py::fold_wn_tp).
The int8 cond pack, every layer's 2C rows stacked, splits each layer's
two gate halves the same way ((model, 2L)); the WN int8 packs follow
their dense convs (`wn_int8_shardings`).
"""

from __future__ import annotations

from typing import Callable

import torch

from fac_via_ppg_torch.parallel.mesh import Mesh, all_gather_cat
from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten


def tree_paths(tree, prefix: str = "") -> list:
    """Every leaf's path in JAX's `keystr` form ("['encoder']['prenet']
    ['layers'][0]['weight']"), in leaf order, so that the path rules read
    as the JAX package's."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _map_with_path(fn: Callable, tree):
    return tree_unflatten(tree, [fn(p, leaf) for p, leaf in
                                 zip(tree_paths(tree), tree_leaves(tree))])


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def replicated(leaf) -> tuple:
    return (None,) * _ndim(leaf)


# ---------------------------------------------------------------- Tacotron2

def _tacotron2_spec(model_axis: int, wide_threshold: int,
                    big_threshold: int, path: str, leaf) -> tuple:
    """The JAX rule for one Tacotron2 leaf (JAX sharding.py:40-67)."""
    shape = tuple(leaf.shape)
    size = 1
    for s in shape:
        size *= s
    if model_axis <= 1:
        return replicated(leaf)
    if "encoder" in path and "prenet" in path and "layers'][0" in path \
            and len(shape) == 2 and shape[1] % model_axis == 0 \
            and shape[1] >= wide_threshold:
        return (None, "model")
    if len(shape) == 2 and shape[0] % model_axis == 0 \
            and shape[0] * shape[1] >= big_threshold:
        return ("model", None)
    if len(shape) == 3 and shape[0] % model_axis == 0 \
            and size >= big_threshold:
        return ("model", None, None)
    return replicated(leaf)


def tacotron2_param_shardings(mesh, params, wide_threshold: int = 1024,
                              big_threshold: int = 256 * 256):
    """Split records for Tacotron2's params (`mesh` needs `.shape` only).
    The thresholds gate which matrices are worth splitting."""
    m = mesh.shape.get("model", 1)
    return _map_with_path(lambda p, x: _tacotron2_spec(
        m, wide_threshold, big_threshold, p, x), params)


def tacotron2_spec_fn(mesh, wide_threshold: int = 1024,
                      big_threshold: int = 256 * 256):
    """(path, leaf) -> split record, for `optimizer_state_shardings`."""
    m = mesh.shape.get("model", 1)
    return lambda path, leaf: _tacotron2_spec(m, wide_threshold,
                                              big_threshold, path, leaf)


# ----------------------------------------------------------------- WaveGlow

def _waveglow_spec(model_axis: int, path: str, leaf) -> tuple:
    """The paired rule for one WaveGlow leaf (see the module doc), in the
    folded form (weight, bias) and the train form (g, v, bias)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if model_axis <= 1 or "['wn']" not in path or not shape:
        return replicated(leaf)
    if "['in_layers']" in path or "['cond_layers']" in path:
        if shape[0] % (2 * model_axis) == 0:
            return (("model", 2),) + (None,) * (len(shape) - 1)
        return replicated(leaf)
    if "['res_skip_layers']" in path and len(shape) == 3 \
            and shape[1] % model_axis == 0:
        return (None, "model", None)   # v / weight; bias and g whole
    return replicated(leaf)


def waveglow_param_shardings(mesh, params):
    """Split records for WaveGlow's params: the paired WN rule.  Leaves
    whose channels do not divide the model axis stay whole."""
    m = mesh.shape.get("model", 1)
    return _map_with_path(lambda p, x: _waveglow_spec(m, p, x), params)


def waveglow_spec_fn(mesh):
    """(path, leaf) -> split record, for `optimizer_state_shardings`."""
    m = mesh.shape.get("model", 1)
    return lambda path, leaf: _waveglow_spec(m, path, leaf)


def int8cond_shardings(mesh, packed, n_layers: int):
    """Split records for `pack_waveglow_int8cond`'s output under TP: each
    flow's stacked (L*2C, n_mel*n_group) int8 weights, their scales and
    biases split on the stacked dim as L*2 blocks of C, each over the
    model axis, so that a rank's rows are the dense cond_layers' paired
    rows, layer by layer.  (JAX splits the flat L*2C dim contiguously and
    reshards before each layer's add, JAX sharding.py:138-165.)"""
    m = mesh.shape.get("model", 1)
    groups = 2 * n_layers

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if m <= 1 or not shape or shape[0] % (groups * m):
            return replicated(leaf)
        return (("model", groups),) + (None,) * (len(shape) - 1)

    return tree_map(spec, packed)


def wn_int8_shardings(mesh, packed):
    """Split records for `pack_waveglow_wn_int8`'s output under TP, the
    paired rule of the dense convs they stand for: the in conv's codes
    `wq` (3, 2C, C) and `wq_stacked` (2C, 3C), its per-output-channel
    `w_scale` and `bias` on their 2C dim as (model, 2); the res_skip codes
    `rs_wq` (O, C) on their input channel; `rs_w_scale` and `rs_bias` (per
    output channel) whole."""
    m = mesh.shape.get("model", 1)
    paired = ("model", 2)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if m <= 1:
            return replicated(leaf)
        name = path.rsplit("['", 1)[1][:-2]
        if name == "wq" and shape[1] % (2 * m) == 0:
            return (None, paired, None)
        if name in ("wq_stacked", "w_scale", "bias") \
                and shape[0] % (2 * m) == 0:
            return (paired,) + (None,) * (len(shape) - 1)
        if name == "rs_wq" and shape[1] % m == 0:
            return (None, "model")
        return replicated(leaf)

    return _map_with_path(spec, packed)


# ------------------------------------------------------------------- ZeRO-1

def optimizer_state_shardings(mesh, opt_state, axis: str = "data",
                              param_spec_fn=None):
    """ZeRO-1: split records for the Adam moments (a tree that mirrors the
    params, so the param rules' paths apply), over the data axis.

    Each leaf splits its first dim that is not already split and is
    divisible by (and at least) the axis size; scalars and indivisible
    leaves stay whole.  `param_spec_fn` (tacotron2_spec_fn /
    waveglow_spec_fn) places the TP split first, so that a moment is never
    laid out unlike its param (JAX sharding.py:167-211)."""
    n = mesh.shape.get(axis, 1)

    def spec(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        base = (tuple(param_spec_fn(path, leaf)) if param_spec_fn
                else replicated(leaf))
        entries = list(base) + [None] * (len(shape) - len(base))
        if n <= 1 or not shape:
            return tuple(entries)
        for d, s in enumerate(shape):
            if entries[d] is None and s >= n and s % n == 0:
                entries[d] = axis
                break
        return tuple(entries)

    return _map_with_path(spec, opt_state)


# ------------------------------------------------------------ apply / gather

def _split(entry):
    return (entry, 1) if isinstance(entry, str) else entry


def shard_leaf(x: torch.Tensor, spec: tuple, index: dict,
               sizes: dict) -> torch.Tensor:
    """The slice of `x` at mesh coordinates `index` ({"data": i, "model":
    j}) under `spec`; a view where the split is one block."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axis, groups = _split(entry)
        p = sizes[axis]
        if p <= 1:
            continue
        s = x.shape[d]
        part = s // (groups * p)
        x = x.unflatten(d, (groups, s // groups)).narrow(
            d + 1, index[axis] * part, part).flatten(d, d + 1)
    return x


def apply_shardings(tree, specs, mesh: Mesh):
    """This rank's slices of every leaf of `tree` under `specs` (JAX
    `apply_shardings` places the same slices on the mesh's devices)."""
    index = {"data": mesh.data_rank, "model": mesh.model_rank}
    return tree_unflatten(tree, [
        shard_leaf(x, s, index, mesh.shape) if isinstance(x, torch.Tensor)
        else x
        for x, s in zip(tree_leaves(tree), tree_leaves_specs(specs))])


def tree_leaves_specs(specs) -> list:
    """The split records of a spec tree, in leaf order (a record is a
    tuple, so the generic walk would descend into it)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(specs)
    return out


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's slice (`shard_leaf`), through one
    all-gather per split axis."""
    for d, entry in reversed(list(enumerate(spec))):
        if entry is None:
            continue
        axis, groups = _split(entry)
        p = mesh.shape[axis]
        if p <= 1:
            continue
        parts = all_gather_cat(x.unsqueeze(0), mesh.group(axis), dim=0)
        # (p, ..., groups*part, ...) -> (..., groups, p, part, ...)
        parts = parts.unflatten(d + 1, (groups, x.shape[d] // groups))
        x = parts.movedim(0, d + 1).flatten(d, d + 2)
    return x


def gather_shards(tree, specs, mesh: Mesh):
    """Full tensors from every rank's slices: the inverse of
    `apply_shardings`, on every rank (for checkpoints)."""
    return tree_unflatten(tree, [
        gather_leaf(x, s, mesh) if isinstance(x, torch.Tensor) else x
        for x, s in zip(tree_leaves(tree), tree_leaves_specs(specs))])
