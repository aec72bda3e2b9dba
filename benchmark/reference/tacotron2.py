"""Tacotron2-PPG's training step, plain PyTorch in float32: the reference
of the training cells, written from the published model (guanlongzhao/
fac-via-ppg src/common/model.py:44-610, loss_function.py:36-53; NVIDIA's
Tacotron2) and importing nothing of the program.

One step: the teacher-forced forward in training mode (batch norms on
the batch's statistics, every dropout), the loss, the gradients by
autograd, the global-norm clip and Adam with L2 weight decay, as
torch.optim.Adam computes it.

The dropout keep-masks are drawn from the generator the program was
given, in the order and shapes in which a training forward draws them
(`draw_masks`): the encoder prenet's two, the encoder convs', the
decoder prenet's two over the whole sequence, the attention and decoder
LSTM states' (each (T_out, B, dim), before the loop), the postnet's."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def draw_masks(t2: dict, params: dict, B: int, T_in: int, T_out: int,
               gen: torch.Generator, device) -> dict:
    def keep(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate

    enc, dec = params["encoder"], params["decoder"]
    m = {"enc_prenet": [keep((B, T_in, l["weight"].shape[0]), 0.5)
                        for l in enc["prenet"]["layers"]],
         "enc_convs": [keep((B, c["conv"]["weight"].shape[0], T_in), 0.5)
                       for c in enc["convolutions"]],
         "dec_prenet": [keep((B, T_out, l["weight"].shape[0]), 0.5)
                        for l in dec["prenet"]["layers"]]}
    states = []
    for rate, dim in ((t2["p_attention_dropout"], t2["attention_rnn_dim"]),
                      (t2["p_attention_dropout"], t2["attention_rnn_dim"]),
                      (t2["p_decoder_dropout"], t2["decoder_rnn_dim"]),
                      (t2["p_decoder_dropout"], t2["decoder_rnn_dim"])):
        states.append(keep((T_out, B, dim), rate) if rate > 0 else None)
    m["states"] = states
    m["postnet"] = [keep((B, c["conv"]["weight"].shape[0], T_out), 0.5)
                    for c in params["postnet"]["convolutions"]]
    return m


def _dropout(x, keep_mask, rate):
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def _batchnorm(p, x, eps=1e-5):
    mean = x.mean(dim=(0, 2), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2), keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * p["weight"][None, :, None]
            + p["bias"][None, :, None])


def _cell(p, x, h, c):
    gates = (x @ p["weight_ih"].T + p["bias_ih"] + h @ p["weight_hh"].T
             + p["bias_hh"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm(p, xs, lengths):
    """(B, T, D) -> (B, T, H): the state stops at each row's length and
    the outputs past it are zero (packed sequences)."""
    B, T, _ = xs.shape
    H = p["weight_hh"].shape[1]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    outs = []
    for t in range(T):
        live = (t < lengths)[:, None]
        h2, c2 = _cell(p, xs[:, t], h, c)
        h = torch.where(live, h2, h)
        c = torch.where(live, c2, c)
        outs.append(torch.where(live, h2, torch.zeros_like(h2)))
    return torch.stack(outs, dim=1)


def _bilstm(pf, pb, xs, lengths):
    """Each row's backward direction runs over its own valid frames,
    reversed (packed sequences)."""
    B, T, D = xs.shape
    t = torch.arange(T, device=xs.device)[None, :]
    rev = (lengths[:, None] - 1 - t).clamp(min=0)          # (B, T)
    idx = rev[:, :, None].expand(B, T, D)
    back = _lstm(pb, torch.gather(xs, 1, idx), lengths)
    back = torch.gather(back, 1, rev[:, :, None].expand_as(back))
    back = torch.where((t < lengths[:, None])[:, :, None], back,
                       torch.zeros_like(back))
    return torch.cat([_lstm(pf, xs, lengths), back], dim=-1)


def forward(t2: dict, params: dict, ppg, in_len, mel, out_len,
            masks: dict):
    """(B, n_symbols, T_in) PPG, (B, D, T_out) teacher mel -> (mel_out,
    mel_post, gate_out), padding masked."""
    enc, dec = params["encoder"], params["decoder"]
    B, D, T_out = mel.shape
    T_in = ppg.shape[2]
    x = ppg.transpose(1, 2)
    for layer, m in zip(enc["prenet"]["layers"], masks["enc_prenet"]):
        x = _dropout(torch.relu(x @ layer["weight"].T), m, 0.5)
    x = x.transpose(1, 2)
    for conv, m in zip(enc["convolutions"], masks["enc_convs"]):
        k = conv["conv"]["weight"].shape[2]
        x = F.conv1d(x, conv["conv"]["weight"], conv["conv"]["bias"],
                     padding=(k - 1) // 2)
        x = _dropout(torch.relu(_batchnorm(conv["bn"], x)), m, 0.5)
    memory = _bilstm(enc["lstm_fwd"], enc["lstm_bwd"], x.transpose(1, 2),
                     in_len)
    att = dec["attention"]
    processed = memory @ att["memory"]["weight"].T
    frames = torch.cat([mel.new_zeros((B, 1, D)),
                        mel.transpose(1, 2)[:, :-1]], dim=1)
    for layer, m in zip(dec["prenet"]["layers"], masks["dec_prenet"]):
        frames = _dropout(torch.relu(frames @ layer["weight"].T), m, 0.5)
    A, R = t2["attention_rnn_dim"], t2["decoder_rnn_dim"]
    E = memory.shape[2]
    att_h, att_c = mel.new_zeros((B, A)), mel.new_zeros((B, A))
    dec_h, dec_c = mel.new_zeros((B, R)), mel.new_zeros((B, R))
    weights = mel.new_zeros((B, T_in))
    cum = mel.new_zeros((B, T_in))
    context = mel.new_zeros((B, E))
    ids = torch.arange(T_in, device=mel.device)[None, :]
    w = t2["attention_window_size"]
    pa, pd = t2["p_attention_dropout"], t2["p_decoder_dropout"]
    st = masks["states"]
    kf = att["location_conv"]["weight"].shape[2]
    mels, gates = [], []
    for t in range(T_out):
        att_h, att_c = _cell(dec["attention_rnn"],
                             torch.cat([frames[:, t], context], dim=-1),
                             att_h, att_c)
        att_h = _dropout(att_h, None if st[0] is None else st[0][t], pa)
        att_c = _dropout(att_c, None if st[1] is None else st[1][t], pa)
        # the +-w window, the last valid frame kept once it is passed
        # (utils.py:46-78)
        last = in_len[:, None] - 1
        allowed = ((ids >= last.clamp(max=max(t - w, 0)))
                   & (ids <= last.clamp(max=t + w)))
        loc = F.conv1d(torch.stack([weights, cum], dim=1),
                       att["location_conv"]["weight"],
                       padding=(kf - 1) // 2)
        loc = loc.transpose(1, 2) @ att["location_dense"]["weight"].T
        query = (att_h @ att["query"]["weight"].T)[:, None, :]
        energies = (torch.tanh(query + loc + processed)
                    @ att["v"]["weight"].T)[..., 0]
        energies = energies.masked_fill(~allowed, float("-inf"))
        weights = torch.softmax(energies, dim=1)
        cum = cum + weights
        context = torch.bmm(weights[:, None, :], memory)[:, 0]
        dec_h, dec_c = _cell(dec["decoder_rnn"],
                             torch.cat([att_h, context], dim=-1),
                             dec_h, dec_c)
        dec_h = _dropout(dec_h, None if st[2] is None else st[2][t], pd)
        dec_c = _dropout(dec_c, None if st[3] is None else st[3][t], pd)
        proj = torch.cat([dec_h, context], dim=-1)
        mels.append(proj @ dec["linear_projection"]["weight"].T
                    + dec["linear_projection"]["bias"])
        gates.append((proj @ dec["gate_layer"]["weight"].T
                      + dec["gate_layer"]["bias"])[:, 0])
    mel_out = torch.stack(mels, dim=2)
    gate_out = torch.stack(gates, dim=1)
    x = mel_out
    convs = params["postnet"]["convolutions"]
    for i, (conv, m) in enumerate(zip(convs, masks["postnet"])):
        k = conv["conv"]["weight"].shape[2]
        x = _batchnorm(conv["bn"], F.conv1d(
            x, conv["conv"]["weight"], conv["conv"]["bias"],
            padding=(k - 1) // 2))
        if i < len(convs) - 1:
            x = torch.tanh(x)
        x = _dropout(x, m, 0.5)
    mel_post = mel_out + x
    valid = (torch.arange(T_out, device=mel.device)[None, :]
             < out_len[:, None])
    mel_out = torch.where(valid[:, None], mel_out, torch.zeros_like(mel_out))
    mel_post = torch.where(valid[:, None], mel_post,
                           torch.zeros_like(mel_post))
    gate_out = torch.where(valid, gate_out, torch.full_like(gate_out, 1e3))
    return mel_out, mel_post, gate_out


def loss(outputs, mel, gate, out_len, mel_weight: float,
         gate_weight: float):
    """MSE of both mels and gate_weight x BCE of the gate, summed over
    every element and divided by B x D x the longest target."""
    mel_out, mel_post, gate_out = outputs
    B, D, _ = mel.shape
    t_ref = out_len.max().clamp(min=1)
    mse = (((mel_out - mel) ** 2).sum() + ((mel_post - mel) ** 2).sum()) \
        / (B * D * t_ref)
    bce = F.binary_cross_entropy_with_logits(gate_out, gate,
                                             reduction="sum") / (B * t_ref)
    return mel_weight * mse + gate_weight * bce


class Adam:
    """torch.optim.Adam's update with L2 weight decay, after the
    global-norm clip of clip_grad_norm_."""

    def __init__(self, lr, weight_decay, clip, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        """Updates `params` ({path: tensor}) in place; returns each leaf's
        gradient as Adam takes it (clipped, weight decay added)."""
        total = math.sqrt(sum(float((g.double() ** 2).sum())
                              for g in grads.values()))
        coef = min(self.clip / (total + 1e-6), 1.0)
        self.t += 1
        taken = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * coef + self.wd * p
                taken[k] = g
                m = self.m.get(k, torch.zeros_like(p))
                v = self.v.get(k, torch.zeros_like(p))
                m = self.b1 * m + (1 - self.b1) * g
                v = self.b2 * v + (1 - self.b2) * g * g
                self.m[k], self.v[k] = m, v
                mh = m / (1 - self.b1 ** self.t)
                vh = v / (1 - self.b2 ** self.t)
                p -= self.lr * mh / (torch.sqrt(vh) + self.eps)
        return taken
