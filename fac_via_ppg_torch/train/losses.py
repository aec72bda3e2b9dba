"""Loss functions (the port of fac_via_ppg_tpu/train/losses.py; reference
src/common/loss_function.py:36-53, src/waveglow/glow.py:43-59).  Every
reduction runs in f32, whatever the outputs' dtype."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE, torch BCEWithLogitsLoss
    semantics."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def tacotron2_loss(model_output, targets, mel_weight: float = 1.0,
                   gate_weight: float = 0.005,
                   output_lengths=None) -> torch.Tensor:
    """MSE(mel) + MSE(mel_postnet) + gate_weight * BCE(gate).

    The sums run over all elements, padding included (padded mel
    positions are zero in output and target, padded gate logits 1e3
    against target 1).  The denominator is B * D * max(output_lengths),
    not the padded size, so bucket padding does not scale the loss
    (the reference divides by its batch's own max length)."""
    mel_target, gate_target = (t.float() for t in targets)
    mel_out, mel_post, gate_out = (x.float() for x in model_output[:3])
    B, D, T_pad = mel_target.shape
    t_ref = (T_pad if output_lengths is None
             else torch.clamp(output_lengths.max(), min=1))
    mel_loss = (torch.sum((mel_out - mel_target) ** 2)
                + torch.sum((mel_post - mel_target) ** 2)) / (B * D * t_ref)
    gate_loss = torch.sum(bce_with_logits(gate_out, gate_target)) / (B * t_ref)
    return mel_weight * mel_loss + gate_weight * gate_loss


def waveglow_loss(model_output, sigma: float = 1.0) -> torch.Tensor:
    """z^2 / (2 sigma^2) - sum(log_s) - sum(log_det_W), over z.numel()."""
    z, log_s_list, log_det_w_list = model_output
    zf = z.float()
    log_s_total = sum(torch.sum(log_s.float()) for log_s in log_s_list)
    log_det_total = sum(ld.float() for ld in log_det_w_list)
    loss = (torch.sum(zf * zf) / (2 * sigma * sigma) - log_s_total
            - log_det_total)
    return loss / z.numel()
