"""Recurrent sequence ops with packed-sequence semantics by masks.

The port of fac_via_ppg_tpu/ops/rnn.py: each `lax.scan` becomes a Python
loop over time.  The input projection of every step is one matmul up
front; the recurrence runs step by step.  Under tensor parallelism
(ops/layers.py) a step's gates are gathered once over the model group.
"""

from __future__ import annotations

from typing import Optional

import torch

from fac_via_ppg_torch.ops.layers import lstm_cell, lstm_input_proj


def unidirectional_lstm(params: dict, xs: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, T, D) -> (B, T, H) LSTM outputs, zeroed past `lengths`.

    With `lengths` the carried state freezes at each sequence's end
    (pack_padded: padding never reaches the state) and outputs at padding
    positions are 0 (pad_packed)."""
    B, T, _ = xs.shape
    H = params["weight_hh"].shape[1]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    x_proj = lstm_input_proj(params, xs)
    if lengths is None:
        valid = torch.ones((T, B, 1), dtype=torch.bool, device=xs.device)
    else:
        valid = (torch.arange(T, device=xs.device)[:, None]
                 < lengths[None, :])[:, :, None]
    zero = xs.new_zeros(())
    outs = []
    for t in range(T):
        h_new, c_new = lstm_cell(params, None, h, c, x_proj=x_proj[:, t])
        m = valid[t]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        outs.append(torch.where(m, h_new, zero))
    return torch.stack(outs, dim=1)


def bidirectional_lstm(fwd_params: dict, bwd_params: dict, xs: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) with per-sequence-length-aware reversal.

    The backward direction runs on each sequence reversed within its own
    valid region (index len-1-t), exactly like packed sequences: the
    backward state starts fresh at each sequence's true end."""
    B, T, _ = xs.shape
    out_f = unidirectional_lstm(fwd_params, xs, lengths)
    if lengths is None:
        out_b = unidirectional_lstm(bwd_params, torch.flip(xs, [1]), None)
        out_b = torch.flip(out_b, [1])
    else:
        t_idx = torch.arange(T, device=xs.device)[None, :]
        rev_idx = torch.clamp(lengths[:, None] - 1 - t_idx, 0, T - 1)
        gather = rev_idx[:, :, None]
        rev = torch.gather(xs, 1, gather.expand(-1, -1, xs.shape[2]))
        out_rev = unidirectional_lstm(bwd_params, rev, lengths)
        # map back: position t (original) <- rev position len-1-t
        out_b = torch.gather(out_rev, 1,
                             gather.expand(-1, -1, out_rev.shape[2]))
        valid = (t_idx < lengths[:, None])[:, :, None]
        out_b = torch.where(valid, out_b, out_b.new_zeros(()))
    return torch.cat([out_f, out_b], dim=-1)
