"""Tacotron2-variant PPG->mel model, inference only (torch).

The port of fac_via_ppg_tpu/models/tacotron2.py (reference
src/common/model.py:44-610).  Parameters are the same nested dictionaries
as the JAX pytrees, with torch tensors for leaves (`weights.py` converts
them); layouts are torch's.

  * Encoder: prenet on the 5816-dim PPG, 3 x [conv1d(k=5) + BN + relu],
    then a BiLSTM with packed-sequence semantics by masks (ops/rnn.py).
  * Decoder: a Python loop over steps on the device, location-sensitive
    attention with the +-window mask, including the reference's
    end-of-sequence quirk (model.py:471-477, utils.py:46-78).
  * Prenet dropout is ALWAYS on (model.py:132-135): its keep-masks are
    drawn from a torch.Generator, or injected through `masks`, an
    iterator of bool arrays consumed in call order (the encoder prenet's
    2 layers first, then 2 per decode step).  Every other dropout is off
    at inference.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import torch

from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.ops.layers import (
    batchnorm,
    batchnorm_params,
    batchnorm_state,
    conv1d,
    conv1d_params,
    dropout,
    linear,
    linear_params,
    lstm_cell,
    lstm_params,
)
from fac_via_ppg_torch.ops.rnn import bidirectional_lstm

MASK_VALUE = -1e9  # finite stand-in for the reference's -inf score mask


# ==========================================================================
# init
# ==========================================================================

def init_tacotron2(cfg: Tacotron2Config, generator: torch.Generator):
    """Returns (params, state) with the JAX package's structure and
    initial distributions (not its values)."""
    g = generator
    E, D = cfg.encoder_embedding_dim, cfg.n_acoustic_feat_dims
    A, R, P = cfg.attention_rnn_dim, cfg.decoder_rnn_dim, cfg.prenet_dim
    params = {
        "encoder": {
            "prenet": {"layers": [
                linear_params(g, cfg.n_symbols, cfg.symbols_embedding_dim,
                              bias=False),
                linear_params(g, cfg.symbols_embedding_dim,
                              cfg.symbols_embedding_dim, bias=False),
            ]},
            "convolutions": [
                {"conv": conv1d_params(g, E, E, cfg.encoder_kernel_size,
                                       w_init_gain="relu"),
                 "bn": batchnorm_params(E)}
                for _ in range(cfg.encoder_n_convolutions)
            ],
            "lstm_fwd": lstm_params(g, E, E // 2),
            "lstm_bwd": lstm_params(g, E, E // 2),
        },
        "decoder": {
            "prenet": {"layers": [
                linear_params(g, D, P, bias=False),
                linear_params(g, P, P, bias=False),
            ]},
            "attention_rnn": lstm_params(g, P + E, A),
            "attention": {
                "query": linear_params(g, A, cfg.attention_dim, bias=False,
                                       w_init_gain="tanh"),
                "memory": linear_params(g, E, cfg.attention_dim, bias=False,
                                        w_init_gain="tanh"),
                "v": linear_params(g, cfg.attention_dim, 1, bias=False),
                "location_conv": conv1d_params(
                    g, 2, cfg.attention_location_n_filters,
                    cfg.attention_location_kernel_size, bias=False),
                "location_dense": linear_params(
                    g, cfg.attention_location_n_filters, cfg.attention_dim,
                    bias=False, w_init_gain="tanh"),
            },
            "decoder_rnn": lstm_params(g, A + E, R),
            "linear_projection": linear_params(g, R + E, D),
            "gate_layer": linear_params(g, R + E, 1, w_init_gain="sigmoid"),
        },
        "postnet": {"convolutions": []},
    }
    pk, pe, pn = (cfg.postnet_kernel_size, cfg.postnet_embedding_dim,
                  cfg.postnet_n_convolutions)
    chans = [D] + [pe] * (pn - 1) + [D]
    for i in range(pn):
        gain = "linear" if i == pn - 1 else "tanh"
        params["postnet"]["convolutions"].append({
            "conv": conv1d_params(g, chans[i], chans[i + 1], pk,
                                  w_init_gain=gain),
            "bn": batchnorm_params(chans[i + 1]),
        })
    state = {
        "encoder": {"convolutions": [
            batchnorm_state(E) for _ in range(cfg.encoder_n_convolutions)]},
        "postnet": {"convolutions": [batchnorm_state(c) for c in chans[1:]]},
    }
    return params, state


# ==========================================================================
# building blocks
# ==========================================================================

def prenet_apply(p: dict, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 masks: Optional[Iterator] = None) -> torch.Tensor:
    """relu+dropout(0.5) MLP; dropout always on (model.py:132-135)."""
    for layer in p["layers"]:
        x = dropout(torch.relu(linear(layer, x)), 0.5,
                    keep_mask=None if masks is None else next(masks),
                    generator=generator)
    return x


def encoder_apply(params, state, ppg, input_lengths,
                  generator: Optional[torch.Generator] = None,
                  masks: Optional[Iterator] = None,
                  mask_convs: bool = True) -> torch.Tensor:
    """(B, n_symbols, T_in) -> memory (B, T_in, E), inference mode.

    `mask_convs` zeroes activations beyond each sequence's length before
    every conv so a bucket-padded input reproduces the unpadded
    computation (conv biases otherwise leak across the boundary)."""
    p, s = params["encoder"], state["encoder"]
    x = prenet_apply(p["prenet"], ppg.transpose(1, 2), generator, masks)
    x = x.transpose(1, 2)  # (B, E, T)
    valid = None
    if mask_convs and input_lengths is not None:
        valid = (torch.arange(x.shape[2], device=x.device)[None, None, :]
                 < input_lengths[:, None, None])
    zero = x.new_zeros(())
    for conv_p, bn_s in zip(p["convolutions"], s["convolutions"]):
        if valid is not None:
            x = torch.where(valid, x, zero)
        k = conv_p["conv"]["weight"].shape[2]
        x = conv1d(conv_p["conv"], x, padding=(k - 1) // 2)
        x = torch.relu(batchnorm(conv_p["bn"], bn_s, x))
    return bidirectional_lstm(p["lstm_fwd"], p["lstm_bwd"], x.transpose(1, 2),
                              input_lengths)


def postnet_apply(params, state, mel, valid_mask=None) -> torch.Tensor:
    """(B, 80, T) -> residual (B, 80, T), inference mode.

    `valid_mask` (B, 1, T) zeroes each conv's input beyond the produced
    length, reproducing torch's zero padding at the shorter sequence."""
    p, s = params["postnet"], state["postnet"]
    x = mel
    n = len(p["convolutions"])
    zero = x.new_zeros(())
    for i, (conv_p, bn_s) in enumerate(zip(p["convolutions"],
                                           s["convolutions"])):
        if valid_mask is not None:
            x = torch.where(valid_mask, x, zero)
        k = conv_p["conv"]["weight"].shape[2]
        x = batchnorm(conv_p["bn"], bn_s,
                      conv1d(conv_p["conv"], x, padding=(k - 1) // 2))
        if i < n - 1:
            x = torch.tanh(x)
    return x


def windowed_attention_mask(lengths, window: int, t: int, T_in: int):
    """Reference utils.py:46-78 semantics, vectorized; True = allowed.

    start = min(max(0, t-w), len-1); end = min(t+w, len-1) -- including
    the quirk that keeps the last valid frame unmasked after the window
    passes the sequence end (documented at utils.py:65-69)."""
    max_idx = lengths - 1
    start = torch.clamp(max_idx, max=max(0, t - window))
    end = torch.clamp(max_idx, max=t + window)
    ids = torch.arange(T_in, device=lengths.device)[None, :]
    return (ids >= start[:, None]) & (ids <= end[:, None])


def attention_step(p, att_h, memory, processed_memory, att_weights,
                   att_weights_cum, allowed_mask):
    """Location-sensitive attention (model.py:63-121)."""
    att_cat = torch.stack([att_weights, att_weights_cum], dim=1)  # (B, 2, T)
    k = p["location_conv"]["weight"].shape[2]
    loc = conv1d(p["location_conv"], att_cat, padding=(k - 1) // 2)
    loc = linear(p["location_dense"], loc.transpose(1, 2))
    query = linear(p["query"], att_h)[:, None, :]
    energies = linear(p["v"], torch.tanh(query + loc + processed_memory))
    energies = energies[..., 0]  # (B, T_in)
    energies = torch.where(allowed_mask, energies,
                           energies.new_full((), MASK_VALUE))
    weights = torch.softmax(energies, dim=1)
    context = torch.bmm(weights[:, None, :], memory)[:, 0]
    return context, weights


class DecoderState(NamedTuple):
    att_h: torch.Tensor
    att_c: torch.Tensor
    dec_h: torch.Tensor
    dec_c: torch.Tensor
    att_weights: torch.Tensor
    att_weights_cum: torch.Tensor
    att_context: torch.Tensor


def init_decoder_state(cfg: Tacotron2Config, memory: torch.Tensor):
    B, T_in, _ = memory.shape
    z = memory.new_zeros
    return DecoderState(
        att_h=z((B, cfg.attention_rnn_dim)), att_c=z((B, cfg.attention_rnn_dim)),
        dec_h=z((B, cfg.decoder_rnn_dim)), dec_c=z((B, cfg.decoder_rnn_dim)),
        att_weights=z((B, T_in)), att_weights_cum=z((B, T_in)),
        att_context=z((B, cfg.encoder_embedding_dim)),
    )


def decode_step(cfg: Tacotron2Config, p_dec, ds: DecoderState, prenet_frame,
                memory, processed_memory, memory_lengths, t: int):
    """One decoder step at inference (model.py:387-442).
    Returns (state, mel, gate, attention weights)."""
    T_in = memory.shape[1]
    cell_in = torch.cat([prenet_frame, ds.att_context], dim=-1)
    att_h, att_c = lstm_cell(p_dec["attention_rnn"], cell_in, ds.att_h,
                             ds.att_c)
    if cfg.attention_window_size >= 0:
        allowed = windowed_attention_mask(
            memory_lengths, cfg.attention_window_size, t, T_in)
    else:
        allowed = (torch.arange(T_in, device=memory.device)[None, :]
                   < memory_lengths[:, None])
    context, weights = attention_step(
        p_dec["attention"], att_h, memory, processed_memory,
        ds.att_weights, ds.att_weights_cum, allowed)
    weights_cum = ds.att_weights_cum + weights
    dec_h, dec_c = lstm_cell(p_dec["decoder_rnn"],
                             torch.cat([att_h, context], dim=-1),
                             ds.dec_h, ds.dec_c)
    proj_in = torch.cat([dec_h, context], dim=-1)
    mel_frame = linear(p_dec["linear_projection"], proj_in)
    gate = linear(p_dec["gate_layer"], proj_in)[:, 0]
    new_state = DecoderState(att_h, att_c, dec_h, dec_c, weights,
                             weights_cum, context)
    return new_state, mel_frame, gate, weights


# ==========================================================================
# autoregressive inference
# ==========================================================================

def _encode(cfg, params, state, ppg, input_lengths, generator, masks):
    memory = encoder_apply(params, state, ppg, input_lengths, generator,
                           masks, mask_convs=True)
    processed = linear(params["decoder"]["attention"]["memory"], memory)
    return memory, processed


def tacotron2_inference(cfg: Tacotron2Config, params, state,
                        ppg: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        input_lengths: Optional[torch.Tensor] = None,
                        masks: Optional[Iterator] = None):
    """Autoregressive decode of one sequence (model.py:597-610, 489-535).

    Gate > threshold on sequence 0 stops decoding; hard cap at
    max_decoder_steps.  Returns (mel_out, mel_out_postnet, gate_out,
    alignments, n_steps)."""
    B, _, T_in = ppg.shape
    if B != 1:
        raise ValueError(
            f"tacotron2_inference stops on sequence 0's gate only (the "
            f"reference's batch-1 semantics, model.py:524); got B={B}. "
            f"Use tacotron2_inference_batched for per-sequence stopping.")
    dev = ppg.device
    if input_lengths is None:
        input_lengths = torch.full((B,), T_in, dtype=torch.int64, device=dev)
    memory, processed = _encode(cfg, params, state, ppg, input_lengths,
                                generator, masks)
    p_dec = params["decoder"]
    M, D = cfg.max_decoder_steps, cfg.n_acoustic_feat_dims
    ds = init_decoder_state(cfg, memory)
    mel_buf = memory.new_zeros((M, B, D))
    gate_buf = memory.new_full((M, B), 1e3)
    align_buf = memory.new_zeros((M, B, T_in))
    prev = memory.new_zeros((B, D))
    t = 0
    while t < M:
        frame = prenet_apply(p_dec["prenet"], prev, generator, masks)
        ds, prev, gate_f, att_w = decode_step(
            cfg, p_dec, ds, frame, memory, processed, input_lengths, t)
        mel_buf[t], gate_buf[t], align_buf[t] = prev, gate_f, att_w
        t += 1
        if bool(torch.sigmoid(gate_f[0]) > cfg.gate_threshold):
            break
    mel_out = mel_buf.permute(1, 2, 0)
    produced = (torch.arange(M, device=dev) < t)[None, None, :]
    residual = postnet_apply(params, state, mel_out, valid_mask=produced)
    mel_post = torch.where(produced, mel_out + residual,
                           mel_out.new_zeros(()))
    return (mel_out, mel_post, gate_buf.T, align_buf.permute(1, 0, 2), t)


def tacotron2_inference_batched(cfg: Tacotron2Config, params, state,
                                ppg: torch.Tensor,
                                input_lengths: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                masks: Optional[Iterator] = None):
    """Batched autoregressive decode with per-sequence gate stopping.

    Every sequence carries its own done flag; the loop ends when ALL have
    fired their gate (or at max_decoder_steps); frames produced after a
    sequence's own stop are zeroed.  Returns (mel_out, mel_out_postnet,
    gate_out, alignments, mel_lengths (B,))."""
    B, _, T_in = ppg.shape
    dev = ppg.device
    memory, processed = _encode(cfg, params, state, ppg, input_lengths,
                                generator, masks)
    p_dec = params["decoder"]
    M, D = cfg.max_decoder_steps, cfg.n_acoustic_feat_dims
    ds = init_decoder_state(cfg, memory)
    mel_buf = memory.new_zeros((M, B, D))
    gate_buf = memory.new_full((M, B), 1e3)
    align_buf = memory.new_zeros((M, B, T_in))
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.full((B,), M, dtype=torch.int64, device=dev)
    prev = memory.new_zeros((B, D))
    zero = memory.new_zeros(())
    t = 0
    while t < M:
        frame = prenet_apply(p_dec["prenet"], prev, generator, masks)
        ds, prev, gate_f, att_w = decode_step(
            cfg, p_dec, ds, frame, memory, processed, input_lengths, t)
        active = ~done
        mel_buf[t] = torch.where(active[:, None], prev, zero)
        gate_buf[t] = torch.where(active, gate_f, zero + 1e3)
        align_buf[t] = torch.where(active[:, None], att_w, zero)
        fired = torch.sigmoid(gate_f) > cfg.gate_threshold
        lengths = torch.where(active & fired, t + 1, lengths)
        done = done | fired
        t += 1
        if bool(done.all()):
            break
    lengths = torch.where(done, lengths, t)
    mel_out = mel_buf.permute(1, 2, 0)
    produced = (torch.arange(M, device=dev)[None, None, :]
                < lengths[:, None, None])
    residual = postnet_apply(params, state, mel_out, valid_mask=produced)
    mel_post = torch.where(produced, mel_out + residual, zero)
    return (mel_out, mel_post, gate_buf.T, align_buf.permute(1, 0, 2),
            lengths)
