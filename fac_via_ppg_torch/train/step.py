"""Training steps (the port of fac_via_ppg_tpu/train/step.py), one device.

A step closes over its static configuration and the optimizer and takes
the parameter tree, the model state, the optimizer state and a batch.
The gradients come from torch.autograd over the tree's leaves; the
optimizer updates those leaves in place (train/optim.py), so the
returned tree is the one passed in.

`compute_dtype=torch.bfloat16` is the JAX package's policy, not autocast:
the float params and inputs are cast to bf16 inside the differentiated
function, so the gradients arrive in f32 through the casts, and the
optimizer state, batch-norm statistics and loss reductions stay f32.

`grad_accum` > 1 splits the batch into that many micro-batches, strided
(micro-batch i takes samples i, i + grad_accum, ...), evaluated one after
the other with the batch-norm state threaded through; the loss and the
gradients are their means, and one optimizer update follows.

`mesh` (parallel/mesh.py) makes the step data-parallel: each rank takes
its own rows of the global batch (the batch passed is this rank's), the
gradients are averaged over the data group after the micro-batches
accumulate and before the optimizer, so the clip sees the global norm,
and the loss returned is the all-reduced mean of the ranks' losses.
Tacotron2's training batch norm takes its statistics over the global
batch, its loss divides by the global batch's longest target, and its
dropout masks are drawn for the global batch, each rank taking its rows,
so a data-parallel step equals one process's step on the concatenated
batch.

`tp` (parallel/tp.py::TensorParallel, on a mesh whose model axis is above
1) makes it tensor-parallel as well: `params` are this rank's slices of
the split leaves and the whole replicated ones, the forward runs on them
through the model group's collectives (ops/layers.py, models/
waveglow.py), every rank of a model group computes the same loss, and the
gradients (each rank's slices and the replicated leaves' whole ones)
average over the data group only, then the replicated leaves' are made
model rank 0's (one broadcast: a card may round them apart), so those
leaves stay equal on every model rank; the optimizer takes the global
norm over the model group (train/optim.py).
The batch-norm statistics, the longest target and the dropout masks stay
the data group's business: a model group's ranks hold the same rows."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.models.tacotron2 import (
    tacotron2_forward,
    training_masks,
)
from fac_via_ppg_torch.models.waveglow import waveglow_forward
from fac_via_ppg_torch.parallel.mesh import all_reduce, rank_rows
from fac_via_ppg_torch.train.losses import tacotron2_loss, waveglow_loss
from fac_via_ppg_torch.train.optim import Optimizer
from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class StepOut(NamedTuple):
    params: object
    model_state: object
    opt_state: object
    loss: torch.Tensor
    grad_norm: torch.Tensor


def cast_floats(tree, dtype: torch.dtype):
    """Every floating-point leaf cast to `dtype` (differentiable)."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def value_and_grad(loss_fn: Callable, params, *args):
    """`loss_fn(params, *args) -> (loss, aux)` and the gradient of the
    loss with respect to every leaf of `params`, in leaf order (zeros for
    a leaf the loss does not reach).  The leaves are detached views of
    the caller's, so the caller's tensors never join a graph."""
    leaves = tree_leaves(params)
    inputs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, inputs), *args)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(inputs, grads)]
    return (loss.detach(), aux), grads


def _split_micro(batch, grad_accum: int) -> list:
    """(B, ...) batch tuple -> grad_accum micro-batches, strided: micro-
    batch i takes samples i, i + grad_accum, ... (JAX `_split_micro`)."""
    b = batch[0].shape[0]
    if b % grad_accum != 0:
        raise ValueError(
            f"grad_accum={grad_accum} must divide the batch size, got "
            f"batch dimension {b} (adjust batch_size or grad_accum_steps)")
    return [tuple(x[i::grad_accum] for x in batch)
            for i in range(grad_accum)]


def _accumulate_micro(vg_fn: Callable, params, model_state, micro: list,
                      grad_accum: int):
    """`vg_fn(params, state, micro_batch) -> ((loss, new_state), grads)`
    over the micro-batches in order, the state threaded through.  Returns
    (new_state, mean loss, mean gradients)."""
    state, loss_sum, grad_sum = model_state, None, None
    for mb in micro:
        (loss, state), grads = vg_fn(params, state, mb)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        grad_sum = grads if grad_sum is None else [
            a + g for a, g in zip(grad_sum, grads)]
    inv = 1.0 / grad_accum
    return state, loss_sum * inv, [g * inv for g in grad_sum]


def _data_group(mesh, tp):
    """The group the gradients average over; raises on a mesh whose model
    axis is split without the layout of the split params."""
    if mesh is not None and mesh.shape["model"] > 1 and tp is None:
        raise ValueError(
            f"a mesh of {mesh.shape['model']} model ranks needs the params' "
            "tensor-parallel layout: pass tp=TensorParallel(mesh, specs) "
            "(parallel/tp.py)")
    return None if mesh is None else mesh.data_group


def average_over(group, loss: torch.Tensor, grads: list):
    """(mean loss, mean gradients) over a data-parallel group: one
    all-reduce of every gradient flattened into one buffer, one of the
    loss.  The arguments themselves with no group."""
    if group is None:
        return loss, grads
    n = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce(flat, group)
    flat /= n
    out, at = [], 0
    for g in grads:
        out.append(flat[at: at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    loss = all_reduce(loss.float().clone(), group) / n
    return loss, out


def _global_max(t: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(t.max().clone(), group, op=dist.ReduceOp.MAX)


def _detached(tree):
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, tree)


def make_tacotron2_train_step(cfg: Tacotron2Config, optimizer: Optimizer,
                              mel_weight: float = 1.0,
                              gate_weight: float = 0.005,
                              compute_dtype: Optional[torch.dtype] = None,
                              grad_accum: int = 1, remat: bool = False,
                              mesh=None, tp=None):
    """Returns step(params, model_state, opt_state, batch, generator=None,
    masks=None) -> StepOut.

    batch = (ppg_padded, input_lengths, acoustic_padded, gate_padded,
    output_lengths), the collate's layout (data_utils.py:281-334).  The
    dropout keep-masks are drawn from `generator`, or taken from `masks`
    (an iterable in the JAX package's call order, micro-batch after
    micro-batch).  `remat` recomputes each decoder step in the backward
    pass (models/tacotron2.py::tacotron2_forward).

    With a `mesh` the batch is this rank's rows and injected `masks` are
    the global batch's (micro-batch after micro-batch, every rank's rows),
    of which each rank takes its own.  With `tp` the params are this
    rank's slices (`tp.shard`); the masks keep the whole widths."""
    group = _data_group(mesh, tp)

    def loss_fn(params, model_state, batch, generator, masks):
        ppg, in_len, mel, gate, out_len = batch
        mel_in = mel
        if compute_dtype is not None:
            params = cast_floats(params, compute_dtype)
            ppg = ppg.to(compute_dtype)
            mel_in = mel.to(compute_dtype)
        shapes = params
        if tp is not None:
            shapes = tp.whole_shapes(params)
            params = tp.annotate(params)
        if group is not None:
            rows = rank_rows(mesh, ppg.shape[0] * mesh.shape["data"])
            if masks is None:
                masks = iter(training_masks(
                    cfg, shapes, ppg.shape[0] * mesh.shape["data"],
                    ppg.shape[2], mel.shape[2], ppg.device, generator))
            masks = (m[rows] for m in masks)
            # the loss divides by the global batch's longest target
            out_len_ref = _global_max(out_len, group).reshape(1)
        else:
            out_len_ref = out_len
        out, new_state = tacotron2_forward(
            cfg, params, model_state, ppg, in_len, mel_in, out_len,
            generator=generator, masks=masks, training=True, remat=remat,
            bn_group=group)
        loss = tacotron2_loss(out, (mel, gate), mel_weight, gate_weight,
                              output_lengths=out_len_ref)
        return loss, _detached(new_state)

    def step(params, model_state, opt_state, batch,
             generator: Optional[torch.Generator] = None,
             masks=None) -> StepOut:
        masks = None if masks is None else iter(masks)

        def vg_fn(p, state, mb):
            return value_and_grad(loss_fn, p, state, mb, generator, masks)

        if grad_accum == 1:
            (loss, new_state), grads = vg_fn(params, model_state, batch)
        else:
            new_state, loss, grads = _accumulate_micro(
                vg_fn, params, model_state, _split_micro(batch, grad_accum),
                grad_accum)
        loss, grads = average_over(group, loss, grads)
        if tp is not None:
            grads = tp.sync_replicated(grads)
        gnorm = optimizer.apply(opt_state, grads)
        return StepOut(params, new_state, opt_state, loss, gnorm)

    return step


def make_tacotron2_eval_step(cfg: Tacotron2Config, mel_weight: float = 1.0,
                             gate_weight: float = 0.005):
    """step(params, model_state, batch, generator) -> (loss, outputs): the
    validation loss, eval-mode batch norm, the prenet's dropout on."""

    def step(params, model_state, batch,
             generator: Optional[torch.Generator] = None):
        ppg, in_len, mel, gate, out_len = batch
        with torch.no_grad():
            out, _ = tacotron2_forward(
                cfg, params, model_state, ppg, in_len, mel, out_len,
                generator=generator, training=False)
            loss = tacotron2_loss(out, (mel, gate), mel_weight, gate_weight,
                                  output_lengths=out_len)
        return loss, out

    return step


def make_waveglow_train_step(cfg: WaveGlowConfig, optimizer: Optimizer,
                             sigma: float,
                             compute_dtype: Optional[torch.dtype] = None,
                             grad_accum: int = 1, remat: bool = False,
                             mesh=None, tp=None):
    """Returns step(params, opt_state, batch) -> StepOut (model_state None).

    batch = (mel (B, 80, F), audio (B, T)); `params` is the train form,
    weight norm unfolded (models/waveglow.py::waveglow_forward).  bf16
    keeps the 1x1 convs' log-determinants and the loss in f32; `remat`
    recomputes each flow in the backward pass.  The step draws nothing at
    random, so `grad_accum` micro-batches give the full batch's update up
    to the order of the sums.  With a `mesh` the batch is this rank's rows
    and the gradients and loss are averaged over the data group.  With
    `tp` the params are this rank's WN channels (the paired rule,
    parallel/sharding.py::waveglow_param_shardings, on the train form)."""
    group = _data_group(mesh, tp)
    model_group = None if tp is None else tp.group

    def loss_fn(params, batch):
        mel, audio = batch
        if compute_dtype is not None:
            params = cast_floats(params, compute_dtype)
            mel = mel.to(compute_dtype)
            audio = audio.to(compute_dtype)
        out = waveglow_forward(cfg, params, mel, audio, remat=remat,
                               model_group=model_group)
        return waveglow_loss(out, sigma=sigma), None

    def step(params, opt_state, batch) -> StepOut:
        def vg_fn(p, state, mb):
            return value_and_grad(loss_fn, p, mb)

        if grad_accum == 1:
            (loss, _), grads = vg_fn(params, None, batch)
        else:
            _, loss, grads = _accumulate_micro(
                vg_fn, params, None, _split_micro(batch, grad_accum),
                grad_accum)
        loss, grads = average_over(group, loss, grads)
        if tp is not None:
            grads = tp.sync_replicated(grads)
        gnorm = optimizer.apply(opt_state, grads)
        return StepOut(params, None, opt_state, loss, gnorm)

    return step
