"""Layer functions on parameter dictionaries, with torch layouts.

The port of fac_via_ppg_tpu/ops/initializers.py (apply side; the init side
is `init_params`' helpers below).  Layouts are torch's: Linear weight
(out, in); Conv1d weight (out, in, k); LSTM gates packed (i, f, g, o)
along dim 0.  JAX parameter pytrees already use them, so `weights.py`
converts leaves and renames nothing.

Tensor parallelism: a layer dict that holds a split weight carries a
`parallel/tp.py::Split` under "tp" (`TensorParallel.annotate`), and
`linear`, `conv1d` and `lstm_cell` then compute on this rank's slice:
an output split takes `copy_to_model` of the input, the local product and
`gather_from_model` of the output features; the contraction split its
block of the input features, the local product and `reduce_from_model`.
The bias, whole on every rank, is added after the collective.  A dict
without "tp" runs the one-device code.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from fac_via_ppg_torch.parallel.tp import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)

GAINS = {
    "linear": 1.0,
    "relu": math.sqrt(2.0),
    "tanh": 5.0 / 3.0,
    "sigmoid": 1.0,
}


def _tp_matmul(split, x: torch.Tensor, w: torch.Tensor, kind: str
               ) -> torch.Tensor:
    """x @ w.T of a weight this rank holds a slice of (`kind` "out" or
    "in"), the whole product on every rank, no bias."""
    if kind == "in":
        n = w.shape[1]
        return reduce_from_model(
            torch.matmul(x.narrow(-1, split.rank * n, n), w.T), split.group)
    return gather_from_model(
        torch.matmul(copy_to_model(x, split.group), w.T), split.group, -1)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ W.T + b.  A contraction split ("in") reads only this rank's
    block of x's features, so x's gradient is left partial: it is for
    inputs that need none (the PPG)."""
    split = p.get("tp")
    if split is not None and "weight" in split.dims:
        out = _tp_matmul(split, x, p["weight"], split.dims["weight"])
    else:
        out = torch.matmul(x, p["weight"].T)
    if "bias" in p:
        out = out + p["bias"]
    return out


def conv1d(p: dict, x: torch.Tensor, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, T'), torch Conv1d semantics; split on
    the out-channel under tensor parallelism."""
    split = p.get("tp")
    if split is not None and "weight" in split.dims:
        y = gather_from_model(F.conv1d(
            copy_to_model(x, split.group), p["weight"], None,
            padding=padding, dilation=dilation), split.group, 1)
        b = p.get("bias")
        return y if b is None else y + b[None, :, None]
    return F.conv1d(x, p["weight"], p.get("bias"), padding=padding,
                    dilation=dilation)


def _normalize(p: dict, mean: torch.Tensor, var: torch.Tensor,
               x: torch.Tensor, eps: float) -> torch.Tensor:
    inv = torch.rsqrt(var.float() + eps)
    scale = (inv * p["weight"].float())[None, :, None].to(x.dtype)
    y = (x - mean.to(x.dtype)[None, :, None]) * scale
    return (y + p["bias"][None, :, None]).to(x.dtype)


def batchnorm(p: dict, state: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm1d over (B, C, T) with running statistics."""
    return _normalize(p, state["running_mean"], state["running_var"], x,
                      eps)


def _global_mean(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """The mean over (B, T) of every rank's (B, C, T) `t` in `group`, n
    elements in all: the local sums all-reduced through autograd, so that
    the other ranks' terms reach the gradient."""
    from torch.distributed.nn.functional import all_reduce

    from fac_via_ppg_torch.parallel import mesh

    mesh.collectives["all_reduce"] += 1
    return all_reduce(t.sum(dim=(0, 2)), group=group) / n


def batchnorm_apply(p: dict, state: dict, x: torch.Tensor, training: bool,
                    momentum: float = 0.1, eps: float = 1e-5, group=None):
    """BatchNorm1d over (B, C, T), torch semantics (JAX
    `ops/initializers.py::batchnorm_apply`).  Returns (y, new_state).

    Training normalizes with the biased batch statistics, computed in f32
    whatever x's dtype, and updates the running statistics with momentum
    and the unbiased variance; the new state is detached (it is no
    function of the loss).  Eval mode is `batchnorm`.

    `group` (a data-parallel process group) takes the statistics over the
    global batch, every rank's rows, as the JAX package's sharded step
    does: the sum, then the sum of squared deviations from the global
    mean (the one-process two-pass formula), each all-reduced through
    autograd; the unbiased factor counts n = B_global * T."""
    if not training:
        return batchnorm(p, state, x, eps), state
    xf = x.float()
    if group is None:
        mean = xf.mean(dim=(0, 2))
        var = ((xf - mean[None, :, None]) ** 2).mean(dim=(0, 2))
        n = x.shape[0] * x.shape[2]
    else:
        import torch.distributed as dist

        n = x.shape[0] * x.shape[2] * dist.get_world_size(group)
        mean = _global_mean(xf, n, group)
        var = _global_mean((xf - mean[None, :, None]) ** 2, n, group)
    unbiased = (var * n / max(n - 1, 1)).detach()
    new_state = {
        "running_mean": (1 - momentum) * state["running_mean"]
        + momentum * mean.detach(),
        "running_var": (1 - momentum) * state["running_var"]
        + momentum * unbiased,
    }
    return _normalize(p, mean, var, x, eps), new_state


def _both_split(p: dict) -> bool:
    split = p.get("tp")
    return split is not None and split.dims.get("weight_ih") == "out" \
        and split.dims.get("weight_hh") == "out"


def lstm_input_proj(p: dict, xs: torch.Tensor) -> torch.Tensor:
    """Every step's input projection at once, as `lstm_cell`'s `x_proj`:
    x @ W_ih.T + b_ih; with both gate stacks split, this rank's block of
    x @ W_ih.T alone (the cell adds its block of h @ W_hh.T and gathers
    the sum once)."""
    split = p.get("tp")
    if _both_split(p):
        return torch.matmul(copy_to_model(xs, split.group),
                            p["weight_ih"].T)
    if split is not None and "weight_ih" in split.dims:
        return _tp_matmul(split, xs, p["weight_ih"], "out") + p["bias_ih"]
    return torch.matmul(xs, p["weight_ih"].T) + p["bias_ih"]


def lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              x_proj: Optional[torch.Tensor] = None):
    """One LSTMCell step, gate order (i, f, g, o): (B, ...) -> (h', c').

    `x_proj` is `lstm_input_proj`'s when the caller computed it for every
    step at once.  With both gate stacks split (contiguous on dim 0: at
    model 2 rank 0 holds gates i, f and rank 1 g, o), a rank sums its
    blocks of the ih and hh products and the cell gathers once, before any
    gate nonlinearity; [x, h] go through one `copy_to_model`."""
    split = p.get("tp")
    if _both_split(p):
        if x_proj is None:
            xh = copy_to_model(torch.cat([x, h], dim=-1), split.group)
            n = x.shape[-1]
            local = (torch.matmul(xh[..., :n], p["weight_ih"].T)
                     + torch.matmul(xh[..., n:], p["weight_hh"].T))
        else:
            local = x_proj + torch.matmul(copy_to_model(h, split.group),
                                          p["weight_hh"].T)
        gates = gather_from_model(local, split.group, -1) \
            + p["bias_ih"] + p["bias_hh"]
    else:
        if x_proj is None:
            x_proj = lstm_input_proj(p, x)
        if split is not None and "weight_hh" in split.dims:
            hh = _tp_matmul(split, h, p["weight_hh"], "out")
        else:
            hh = torch.matmul(h, p["weight_hh"].T)
        gates = x_proj + hh + p["bias_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def dropout(x: torch.Tensor, rate: float,
            keep_mask: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch F.dropout semantics (kept units scaled by 1/(1-rate)).

    `keep_mask` (bool, x's shape) injects the kept units, e.g. masks
    recorded from the JAX package; otherwise they are drawn from
    `generator`."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = torch.rand(x.shape, generator=generator,
                               device=x.device) < keep
    elif not isinstance(keep_mask, torch.Tensor):
        keep_mask = torch.tensor(keep_mask, device=x.device)
    return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


# ---------------------------------------------------------------- init
# Same distributions as the JAX package's initializers (reference
# src/common/layers.py:40-71), drawn from a torch.Generator.

def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def xavier_uniform(g: torch.Generator, shape, gain: float = 1.0):
    """torch.nn.init.xavier_uniform_ for (out, in[, k]) weight layouts."""
    receptive = shape[2] if len(shape) == 3 else 1
    fan_out, fan_in = shape[0] * receptive, shape[1] * receptive
    return _uniform(g, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def linear_params(g, in_dim: int, out_dim: int, bias: bool = True,
                  w_init_gain: str = "linear") -> dict:
    p = {"weight": xavier_uniform(g, (out_dim, in_dim), GAINS[w_init_gain])}
    if bias:
        p["bias"] = _uniform(g, (out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def conv1d_params(g, in_ch: int, out_ch: int, kernel_size: int,
                  bias: bool = True, w_init_gain: str = "linear") -> dict:
    p = {"weight": xavier_uniform(g, (out_ch, in_ch, kernel_size),
                                  GAINS[w_init_gain])}
    if bias:
        p["bias"] = _uniform(g, (out_ch,),
                             1.0 / math.sqrt(in_ch * kernel_size))
    return p


def batchnorm_params(dim: int) -> dict:
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


def batchnorm_state(dim: int) -> dict:
    return {"running_mean": torch.zeros(dim), "running_var": torch.ones(dim)}


def lstm_params(g, input_dim: int, hidden_dim: int) -> dict:
    """torch LSTMCell default init: U(-1/sqrt(H), 1/sqrt(H)) everywhere."""
    b = 1.0 / math.sqrt(hidden_dim)
    return {
        "weight_ih": _uniform(g, (4 * hidden_dim, input_dim), b),
        "weight_hh": _uniform(g, (4 * hidden_dim, hidden_dim), b),
        "bias_ih": _uniform(g, (4 * hidden_dim,), b),
        "bias_hh": _uniform(g, (4 * hidden_dim,), b),
    }
