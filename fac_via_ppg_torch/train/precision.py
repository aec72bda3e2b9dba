"""Mixed-precision policy and loss scaling (the port of
fac_via_ppg_tpu/train/precision.py).

The reference ships an fp16 apparatus (FP16_Optimizer with flat fp32
master weights, fp16_optimizer.py:83-413, and static / dynamic loss
scalers, loss_scaler.py:34-160) that its own README declares broken
(README.md:53).  bf16 shares f32's exponent range, so its gradients do not
underflow as fp16's do, and params and optimizer state stay f32 either
way.  What takes its place, as in the JAX package:

  * `Policy`: cast-to-compute / keep-params-f32 dtype casts over the
    port's parameter trees (nested dicts and lists of tensors);
  * `DynamicLossScaler`: init scale 2**32, x2 after `scale_window` clean
    steps, /2 and skip the step on non-finite gradients
    (loss_scaler.py:63-160); `StaticLossScaler`: a constant scale.

The scalers are plain functions on tensors with the JAX package's
`LossScalerState` fields.  No trainer uses them by default.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map


def _cast(tree, dtype: torch.dtype):
    return tree_map(
        lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
        and x.is_floating_point() else x, tree)


class Policy(NamedTuple):
    """Dtype policy: params stay param_dtype; activations cast to
    compute_dtype; outputs to output_dtype.  Non-float leaves are left
    as they are."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        return _cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast(tree, self.output_dtype)


def get_policy(compute_dtype: str = "bfloat16") -> Policy:
    return Policy(param_dtype=torch.float32,
                  compute_dtype=getattr(torch, compute_dtype),
                  output_dtype=torch.float32)


class LossScalerState(NamedTuple):
    scale: torch.Tensor         # current loss scale, f32 scalar
    good_steps: torch.Tensor    # consecutive overflow-free steps, int32


def has_overflow(grads) -> torch.Tensor:
    """True (a bool scalar tensor) where any gradient leaf holds an inf or
    a nan."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.tensor(False)
    device = leaves[0].device
    return ~torch.stack([torch.isfinite(g).all().to(device)
                         for g in leaves]).all()


def _unscaled(grads, scale: torch.Tensor, overflow: torch.Tensor):
    """grads / scale; zeros times the grads on overflow, as the JAX
    package does (so an inf leaf becomes nan, the finite ones 0)."""
    inv = torch.where(overflow, torch.zeros_like(scale), 1.0 / scale)
    return tree_map(lambda g: g * inv.to(g.device, g.dtype), grads)


class DynamicLossScaler:
    """Dynamic loss scaling (reference loss_scaler.py:63-160).

    usage:
        state = scaler.init()
        scaled_loss = loss * state.scale
        grads = autograd of scaled_loss
        grads, state, ok = scaler.unscale(grads, state)
        # apply the step only where ok
    """

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def init(self) -> LossScalerState:
        return LossScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32),
            good_steps=torch.tensor(0, dtype=torch.int32))

    has_overflow = staticmethod(has_overflow)

    def unscale(self, grads, state: LossScalerState
                ) -> Tuple[object, LossScalerState, torch.Tensor]:
        """Returns (unscaled_grads, new_state, step_ok)."""
        overflow = has_overflow(grads).to(state.scale.device)
        grads = _unscaled(grads, state.scale, overflow)
        grown = state.good_steps + 1 >= self.scale_window
        new_scale = torch.where(
            overflow, state.scale / self.scale_factor,
            torch.where(grown, state.scale * self.scale_factor,
                        state.scale))
        new_good = torch.where(overflow | grown,
                               torch.zeros_like(state.good_steps),
                               state.good_steps + 1)
        return grads, LossScalerState(new_scale, new_good), ~overflow


class StaticLossScaler:
    """Constant loss scale (reference loss_scaler.py:34-60)."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def init(self) -> LossScalerState:
        return LossScalerState(
            scale=torch.tensor(self.scale, dtype=torch.float32),
            good_steps=torch.tensor(0, dtype=torch.int32))

    has_overflow = staticmethod(has_overflow)

    def unscale(self, grads, state: LossScalerState):
        overflow = has_overflow(grads).to(state.scale.device)
        return _unscaled(grads, state.scale, overflow), state, ~overflow
