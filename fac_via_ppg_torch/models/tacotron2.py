"""Tacotron2-variant PPG->mel model: inference and the teacher-forced
forward (torch).

The port of fac_via_ppg_tpu/models/tacotron2.py (reference
src/common/model.py:44-610).  Parameters are the same nested dictionaries
as the JAX pytrees, with torch tensors for leaves (`weights.py` converts
them); layouts are torch's.

  * Encoder: prenet on the 5816-dim PPG, 3 x [conv1d(k=5) + BN + relu],
    then a BiLSTM with packed-sequence semantics by masks (ops/rnn.py).
  * Decoder: location-sensitive attention with the +-window mask,
    including the reference's end-of-sequence quirk (model.py:471-477,
    utils.py:46-78).  The step takes `t` as a device tensor, and the
    autoregressive loop stays on the device as the JAX package's
    `lax.while_loop` does: `decode_chunk` runs k steps as one pure tensor
    function (the stop, lengths and end step kept on the device), on the
    card captured once as a CUDA graph and replayed (models/
    decode_graph.py); the host reads the stop once per chunk.
  * Prenet dropout is ALWAYS on (model.py:132-135): its keep-masks are
    drawn from a torch.Generator, or injected through `masks`, an
    iterator of bool arrays consumed in call order (the encoder prenet's
    2 layers first, then 2 per decode step).  The decoder's masks for
    every step are drawn before the loop, one (M, layers, B, prenet_dim)
    tensor, so a step consumes no randomness.  Every other dropout is off
    at inference.
  * Training: `tacotron2_forward`, the teacher-forced forward
    (model.py:580-595) with training-mode batch norm and every dropout of
    the JAX package's forward (encoder convs, prenet, the attention and
    decoder LSTM states, postnet), whose masks are injected in the JAX
    package's call order or drawn, the decoder steps' before the loop.
  * Tensor-parallel training runs the same forward on a rank's slices of
    the split params, annotated by parallel/tp.py::TensorParallel.annotate:
    ops/layers.py computes each split layer through the model group's
    collectives, and every activation between them is whole.
"""

from __future__ import annotations

import itertools
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.models import decode_graph
from fac_via_ppg_torch.ops.layers import (
    batchnorm_apply,
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
# Decode steps per chunk: the host reads the stop once per chunk, and a
# chunk is one CUDA graph replay on the card (PERF.md: the sweep).
DECODE_CHUNK = 8


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

def _next_mask(masks: Optional[Iterator]):
    return None if masks is None else next(masks)


def prenet_apply(p: dict, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 masks: Optional[Iterator] = None) -> torch.Tensor:
    """relu+dropout(0.5) MLP; dropout always on (model.py:132-135)."""
    for layer in p["layers"]:
        x = dropout(torch.relu(linear(layer, x)), 0.5,
                    keep_mask=_next_mask(masks),
                    generator=generator)
    return x


def encoder_forward(params, state, ppg, input_lengths, training: bool,
                    generator: Optional[torch.Generator] = None,
                    masks: Optional[Iterator] = None,
                    mask_convs: bool = False, bn_group=None):
    """(B, n_symbols, T_in) -> (memory (B, T_in, E), new encoder state).

    `training` runs batch norm on the batch's statistics and dropout(0.5)
    after each conv's relu.  `mask_convs` zeroes activations beyond each
    sequence's length before every conv, so that a bucket-padded input
    reproduces the unpadded computation (conv biases otherwise leak
    across the boundary); it stays off in training, as in the JAX package
    and the reference (model.py:215-235).  `bn_group` takes the training
    batch norm's statistics over a data-parallel group's global batch."""
    p, s = params["encoder"], state["encoder"]
    x = prenet_apply(p["prenet"], ppg.transpose(1, 2), generator, masks)
    x = x.transpose(1, 2)  # (B, E, T)
    valid = None
    if mask_convs and input_lengths is not None:
        valid = (torch.arange(x.shape[2], device=x.device)[None, None, :]
                 < input_lengths[:, None, None])
    zero = x.new_zeros(())
    new_bn = []
    for conv_p, bn_s in zip(p["convolutions"], s["convolutions"]):
        if valid is not None:
            x = torch.where(valid, x, zero)
        k = conv_p["conv"]["weight"].shape[2]
        x = conv1d(conv_p["conv"], x, padding=(k - 1) // 2)
        x, bn_new = batchnorm_apply(conv_p["bn"], bn_s, x, training,
                                    group=bn_group)
        new_bn.append(bn_new)
        x = torch.relu(x)
        if training:
            x = dropout(x, 0.5, keep_mask=_next_mask(masks),
                        generator=generator)
    memory = bidirectional_lstm(p["lstm_fwd"], p["lstm_bwd"],
                                x.transpose(1, 2), input_lengths)
    return memory, {"convolutions": new_bn}


def encoder_apply(params, state, ppg, input_lengths,
                  generator: Optional[torch.Generator] = None,
                  masks: Optional[Iterator] = None,
                  mask_convs: bool = True) -> torch.Tensor:
    """(B, n_symbols, T_in) -> memory (B, T_in, E), inference mode, the
    convs masked by default."""
    return encoder_forward(params, state, ppg, input_lengths, False,
                           generator, masks, mask_convs)[0]


def postnet_forward(params, state, mel, training: bool,
                    generator: Optional[torch.Generator] = None,
                    masks: Optional[Iterator] = None, valid_mask=None,
                    bn_group=None):
    """(B, 80, T) -> (residual (B, 80, T), new postnet state).

    `training` runs batch norm on the batch's statistics and dropout(0.5)
    after every conv.  `valid_mask` (B, 1, T) zeroes each conv's input
    beyond the produced length, reproducing torch's zero padding at the
    shorter sequence.  `bn_group` as `encoder_forward`'s."""
    p, s = params["postnet"], state["postnet"]
    x = mel
    n = len(p["convolutions"])
    zero = x.new_zeros(())
    new_bn = []
    for i, (conv_p, bn_s) in enumerate(zip(p["convolutions"],
                                           s["convolutions"])):
        if valid_mask is not None:
            x = torch.where(valid_mask, x, zero)
        k = conv_p["conv"]["weight"].shape[2]
        x, bn_new = batchnorm_apply(
            conv_p["bn"], bn_s,
            conv1d(conv_p["conv"], x, padding=(k - 1) // 2), training,
            group=bn_group)
        new_bn.append(bn_new)
        if i < n - 1:
            x = torch.tanh(x)
        if training:
            x = dropout(x, 0.5, keep_mask=_next_mask(masks),
                        generator=generator)
    return x, {"convolutions": new_bn}


def postnet_apply(params, state, mel, valid_mask=None) -> torch.Tensor:
    """(B, 80, T) -> residual (B, 80, T), inference mode."""
    return postnet_forward(params, state, mel, False,
                           valid_mask=valid_mask)[0]


def windowed_attention_mask(lengths, window: int, t: torch.Tensor,
                            T_in: int):
    """Reference utils.py:46-78 semantics, vectorized; True = allowed.
    `t` is the step, an int64 tensor of shape () on `lengths`' device.

    start = min(max(0, t-w), len-1); end = min(t+w, len-1) -- including
    the quirk that keeps the last valid frame unmasked after the window
    passes the sequence end (documented at utils.py:65-69)."""
    max_idx = lengths - 1
    start = torch.minimum(torch.clamp(t - window, min=0), max_idx)
    end = torch.minimum(t + window, max_idx)
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


def _drop(x: torch.Tensor, rate: float, keep_mask) -> torch.Tensor:
    return x if keep_mask is None else dropout(x, rate, keep_mask=keep_mask)


def decode_step(cfg: Tacotron2Config, p_dec, ds: DecoderState, prenet_frame,
                memory, processed_memory, memory_lengths, t: torch.Tensor,
                drop=None):
    """One decoder step (model.py:387-442), `t` an int64 tensor of shape
    ().  `drop` (training) holds the step's keep-masks of att_h, att_c,
    dec_h and dec_c, each None where its rate is 0.  Returns (state, mel,
    gate, attention weights)."""
    T_in = memory.shape[1]
    drop = drop or (None,) * 4
    cell_in = torch.cat([prenet_frame, ds.att_context], dim=-1)
    att_h, att_c = lstm_cell(p_dec["attention_rnn"], cell_in, ds.att_h,
                             ds.att_c)
    att_h = _drop(att_h, cfg.p_attention_dropout, drop[0])
    att_c = _drop(att_c, cfg.p_attention_dropout, drop[1])
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
    dec_h = _drop(dec_h, cfg.p_decoder_dropout, drop[2])
    dec_c = _drop(dec_c, cfg.p_decoder_dropout, drop[3])
    proj_in = torch.cat([dec_h, context], dim=-1)
    mel_frame = linear(p_dec["linear_projection"], proj_in)
    gate = linear(p_dec["gate_layer"], proj_in)[:, 0]
    new_state = DecoderState(att_h, att_c, dec_h, dec_c, weights,
                             weights_cum, context)
    return new_state, mel_frame, gate, weights


# ==========================================================================
# teacher-forced forward (training)
# ==========================================================================

def _as_mask(m, device) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device, torch.bool)
    return torch.tensor(np.asarray(m), dtype=torch.bool, device=device)


def decoder_state_masks(cfg: Tacotron2Config, B: int, T_out: int, device,
                        generator: Optional[torch.Generator] = None,
                        masks: Optional[Iterator] = None) -> list:
    """Every training step's keep-masks of att_h, att_c, dec_h and dec_c:
    four (T_out, B, dim) bool tensors (None where the rate is 0), drawn
    before the loop from `generator`, or taken from `masks` in the JAX
    package's call order (per step: att_h, att_c, dec_h, dec_c)."""
    specs = [(cfg.p_attention_dropout, cfg.attention_rnn_dim)] * 2 \
        + [(cfg.p_decoder_dropout, cfg.decoder_rnn_dim)] * 2
    live = [i for i, (rate, _) in enumerate(specs) if rate > 0]
    out = [None] * 4
    if masks is not None:
        rec = list(itertools.islice(masks, T_out * len(live)))
        if len(rec) != T_out * len(live):
            raise ValueError(f"{len(rec)} injected decoder-state masks for "
                             f"{T_out} steps of {len(live)}")
        for j, i in enumerate(live):
            out[i] = torch.stack([_as_mask(m, device)
                                  for m in rec[j::len(live)]])
        return out
    for i in live:
        rate, dim = specs[i]
        out[i] = torch.rand((T_out, B, dim), generator=generator,
                            device=device) < 1.0 - rate
    return out


def training_masks(cfg: Tacotron2Config, params, B: int, T_in: int,
                   T_out: int, device,
                   generator: Optional[torch.Generator] = None) -> list:
    """Every keep-mask of one training forward (`tacotron2_forward`,
    training=True) of a (B, T_in) -> (B, T_out) batch, drawn from
    `generator` in the order and shapes that forward draws them, and
    returned in its `masks=` call order: the encoder prenet's and convs',
    the decoder prenet's, per step the live LSTM-state masks, the
    postnet's.  Every mask has the batch on dim 0, so a data-parallel rank
    takes its rows of the global batch's draws and equals the one-process
    step on the concatenated batch."""
    def keep(shape, rate):
        return torch.rand(shape, generator=generator, device=device) \
            < 1.0 - rate

    out = [keep((B, T_in, layer["weight"].shape[0]), 0.5)
           for layer in params["encoder"]["prenet"]["layers"]]
    out += [keep((B, c["conv"]["weight"].shape[0], T_in), 0.5)
            for c in params["encoder"]["convolutions"]]
    out += [keep((B, T_out, layer["weight"].shape[0]), 0.5)
            for layer in params["decoder"]["prenet"]["layers"]]
    states = [m for m in decoder_state_masks(cfg, B, T_out, device,
                                             generator) if m is not None]
    out += [m[t] for t in range(T_out) for m in states]
    out += [keep((B, c["conv"]["weight"].shape[0], T_out), 0.5)
            for c in params["postnet"]["convolutions"]]
    return out


def inference_masks(cfg: Tacotron2Config, params, B: int, T_in: int,
                    device,
                    generator: Optional[torch.Generator] = None) -> list:
    """Every prenet keep-mask of one batched inference
    (`tacotron2_inference_batched`) of B sequences of T_in frames, drawn
    from `generator` as that decode draws them, in its `masks=` call
    order: the encoder prenet's (B, T_in, dim), then per decode step and
    layer (B, prenet_dim).  The batch is on dim 0 of each (see
    `training_masks`)."""
    out = [torch.rand((B, T_in, layer["weight"].shape[0]),
                      generator=generator, device=device) < 0.5
           for layer in params["encoder"]["prenet"]["layers"]]
    dec = decoder_prenet_masks(cfg, len(params["decoder"]["prenet"]
                                        ["layers"]), B, device, generator)
    return out + list(dec.flatten(0, 1).unbind(0))


def tacotron2_forward(cfg: Tacotron2Config, params, state,
                      ppg_padded: torch.Tensor,
                      input_lengths: torch.Tensor,
                      mel_targets: torch.Tensor,
                      output_lengths: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      masks: Optional[Iterator] = None,
                      training: bool = True, remat: bool = False,
                      bn_group=None):
    """Teacher-forced forward (model.py:580-595; JAX `models/
    tacotron2.py:318-404`): (B, n_symbols, T_in) PPG, (B, 80, T_out)
    teacher mel.  Returns ((mel_out, mel_out_postnet, gate_out,
    alignments), new_state), padding-masked as parse_output does
    (model.py:566-578).

    `training` runs batch norm on batch statistics and every dropout
    (encoder convs 0.5, the attention / decoder LSTM states, postnet 0.5);
    the prenet's is always on.  Keep-masks come from `masks` (an iterator
    in the JAX package's call order: encoder prenet 2, encoder convs,
    decoder prenet 2 over the whole sequence, 4 a step, postnet) or from
    `generator`; the steps' masks are all drawn before the loop, so that
    `remat=True` (each step under torch.utils.checkpoint, recomputed in
    the backward pass from its carry) replays the same step.  `bn_group`
    (a data-parallel process group) takes the training batch norms'
    statistics over the group's global batch."""
    B, D, T_out = mel_targets.shape
    dev = mel_targets.device
    memory, enc_state = encoder_forward(params, state, ppg_padded,
                                        input_lengths, training, generator,
                                        masks, mask_convs=False,
                                        bn_group=bn_group)
    p_dec = params["decoder"]
    processed = linear(p_dec["attention"]["memory"], memory)
    # go frame + teacher frames shifted right, the prenet applied to the
    # whole sequence up front (model.py:459-462)
    dec_in = torch.cat([mel_targets.new_zeros((B, 1, D)),
                        mel_targets.transpose(1, 2)[:, :-1]], dim=1)
    dec_in = prenet_apply(p_dec["prenet"], dec_in, generator, masks)
    drops = (decoder_state_masks(cfg, B, T_out, dev, generator, masks)
             if training else [None] * 4)
    ds = init_decoder_state(cfg, memory)
    ts = torch.arange(T_out, device=dev)
    mels, gates, aligns = [], [], []
    for t in range(T_out):
        drop_t = tuple(None if d is None else d[t] for d in drops)
        args = (cfg, p_dec, ds, dec_in[:, t], memory, processed,
                input_lengths, ts[t], drop_t)
        if remat:
            ds, mel_f, gate_f, att_w = checkpoint(
                decode_step, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            ds, mel_f, gate_f, att_w = decode_step(*args)
        mels.append(mel_f)
        gates.append(gate_f)
        aligns.append(att_w)
    mel_out = torch.stack(mels, dim=2)          # (B, 80, T_out)
    gate_out = torch.stack(gates, dim=1)        # (B, T_out)
    alignments = torch.stack(aligns, dim=1)     # (B, T_out, T_in)

    residual, post_state = postnet_forward(params, state, mel_out, training,
                                           generator, masks,
                                           bn_group=bn_group)
    mel_post = mel_out + residual
    if cfg.mask_padding:
        valid = ts[None, :] < output_lengths[:, None]
        zero = mel_out.new_zeros(())
        mel_out = torch.where(valid[:, None], mel_out, zero)
        mel_post = torch.where(valid[:, None], mel_post, zero)
        gate_out = torch.where(valid, gate_out, gate_out.new_full((), 1e3))
    new_state = {"encoder": enc_state, "postnet": post_state}
    return (mel_out, mel_post, gate_out, alignments), new_state


# ==========================================================================
# the decode loop, on the device
# ==========================================================================

class DecodeLoop(NamedTuple):
    """The loop's carry (JAX `models/tacotron2.py:457-470, 531-553`), all
    on the device.  The buffers have `n_chunks * k` rows, M rounded up to
    the chunk; rows past M are never part of an output."""
    ds: DecoderState
    prev: torch.Tensor      # (B, D) the last frame
    t: torch.Tensor         # () int64, steps run
    done: torch.Tensor      # (B,) bool
    lengths: torch.Tensor   # (B,) int64
    t_end: torch.Tensor     # () int64, the step count when the stop held
    mel: torch.Tensor       # (rows, B, D)
    gate: torch.Tensor      # (rows, B)
    align: torch.Tensor     # (rows, B, T_in)


def init_decode_loop(cfg: Tacotron2Config, memory: torch.Tensor,
                     rows: int) -> DecodeLoop:
    B, T_in, _ = memory.shape
    D, M = cfg.n_acoustic_feat_dims, cfg.max_decoder_steps
    i64 = dict(dtype=torch.int64, device=memory.device)
    return DecodeLoop(
        ds=init_decoder_state(cfg, memory), prev=memory.new_zeros((B, D)),
        t=torch.zeros((), **i64),
        done=torch.zeros((B,), dtype=torch.bool, device=memory.device),
        lengths=torch.full((B,), M, **i64), t_end=torch.zeros((), **i64),
        mel=memory.new_zeros((rows, B, D)),
        gate=memory.new_full((rows, B), 1e3),
        align=memory.new_zeros((rows, B, T_in)))


def _reset_decode_loop(loop: DecodeLoop, M: int) -> None:
    """`loop` back to `init_decode_loop`'s values, in place."""
    for x in (*loop.ds, loop.prev, loop.t, loop.done, loop.t_end,
              loop.mel, loop.align):
        x.zero_()
    loop.lengths.fill_(M)
    loop.gate.fill_(1e3)


def decoder_prenet_masks(cfg: Tacotron2Config, n_layers: int, B: int,
                         device, generator: Optional[torch.Generator] = None,
                         masks: Optional[Iterator] = None) -> torch.Tensor:
    """Every decode step's prenet keep-masks, (M, n_layers, B, prenet_dim)
    bool, drawn before the loop from `generator` (keep probability 0.5).

    Injected `masks` (the rest of the call-order iterator, `n_layers` a
    step, for the steps the JAX package ran) fill the first steps; steps
    it never ran keep every unit (their writes are masked, so the padding
    reaches no output)."""
    M, P = cfg.max_decoder_steps, cfg.prenet_dim
    if masks is None:
        return torch.rand((M, n_layers, B, P), generator=generator,
                          device=device) < 0.5
    rest = [_as_mask(m, device) for m in masks]
    n = len(rest) // n_layers
    if len(rest) % n_layers or n > M:
        raise ValueError(f"{len(rest)} injected decoder masks are not "
                         f"{n_layers} a step for at most {M} steps")
    out = torch.ones((M, n_layers, B, P), dtype=torch.bool, device=device)
    if n:
        out[:n] = torch.stack(rest).view(n, n_layers, B, P)
    return out


def decode_chunk(cfg: Tacotron2Config, p_dec, loop: DecodeLoop,
                 masks: torch.Tensor, memory, processed_memory,
                 memory_lengths, k: int, stop_on_first: bool) -> DecodeLoop:
    """k decode steps as one pure tensor function: no host read, no
    branch on a tensor's value.  Writes row t of the buffers in place and
    returns the new carry.

    A step is live while the JAX loop would still run it: not every
    sequence done, and t < M.  Batched (JAX :531-553): a done sequence
    writes 0 / 1e3 / 0, `lengths = where(active & fired, t+1, lengths)`,
    `done |= fired`.  `stop_on_first` (one sequence, JAX :457-470) stops
    on sequence 0's gate.  A step that is not live (past the stop, or
    t >= M) changes no output: it writes its row's initial values."""
    M = cfg.max_decoder_steps
    for _ in range(k):
        t = loop.t
        step_masks = masks.index_select(0, t.view(1))[0]
        frame = prenet_apply(p_dec["prenet"], loop.prev,
                             masks=iter(step_masks.unbind(0)))
        ds, mel_f, gate_f, att_w = decode_step(
            cfg, p_dec, loop.ds, frame, memory, processed_memory,
            memory_lengths, t)
        fired = torch.sigmoid(gate_f) > cfg.gate_threshold
        if stop_on_first:
            fired = fired[:1].expand_as(fired)
        live = ~loop.done.all() & (t < M)
        active = ~loop.done & live
        zero = mel_f.new_zeros(())
        row = t.view(1)
        loop.mel.index_copy_(0, row,
                             torch.where(active[:, None], mel_f, zero)[None])
        loop.gate.index_copy_(0, row, torch.where(
            active, gate_f, gate_f.new_full((), 1e3))[None])
        loop.align.index_copy_(0, row,
                               torch.where(active[:, None], att_w, zero)[None])
        loop = loop._replace(
            ds=ds, prev=mel_f, t=t + 1,
            done=loop.done | (fired & live),
            lengths=torch.where(active & fired, t + 1, loop.lengths),
            t_end=torch.where(live, t + 1, loop.t_end))
    return loop


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _decode_graph(cfg, p_dec, memory, processed_memory, masks, k,
                  stop_on_first) -> decode_graph.ChunkGraph:
    """The cached graph of one chunk for these shapes and weights."""
    B, T_in, _ = memory.shape
    leaves = list(_leaves(p_dec))
    key = (cfg, B, T_in, k, stop_on_first, memory.dtype, memory.device,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           tuple(x.data_ptr() for x in leaves))

    def make():
        static = dict(
            memory=torch.zeros_like(memory),
            processed=torch.zeros_like(processed_memory),
            lengths=torch.full((B,), T_in, dtype=torch.int64,
                               device=memory.device),
            masks=torch.ones_like(masks),
            loop=init_decode_loop(cfg, memory, masks.shape[0]),
            weights=leaves)

        def chunk():
            loop = static["loop"]
            out = decode_chunk(cfg, p_dec, loop, static["masks"],
                               static["memory"], static["processed"],
                               static["lengths"], k, stop_on_first)
            for dst, src in zip((*loop.ds, loop.prev, loop.t, loop.done,
                                 loop.lengths, loop.t_end),
                                (*out.ds, out.prev, out.t, out.done,
                                 out.lengths, out.t_end)):
                dst.copy_(src)

        return decode_graph.ChunkGraph(chunk, static)

    with torch.cuda.device(memory.device):
        return decode_graph.cached(key, make)


def decode(cfg: Tacotron2Config, p_dec, memory: torch.Tensor,
           processed_memory: torch.Tensor, memory_lengths: torch.Tensor,
           masks: torch.Tensor, stop_on_first: bool,
           k: Optional[int] = None, graph: Optional[bool] = None):
    """The autoregressive decode: chunks of k steps until the stop holds
    (the host reads it once per chunk) or M steps have run.

    `masks` is `decoder_prenet_masks`' (M, layers, B, P) tensor; `k`
    defaults to DECODE_CHUNK.  On a
    CUDA `memory` each chunk is a replay of one captured CUDA graph
    (`graph=None`); `graph=False` runs the same chunk function eagerly,
    the plain version the CPU always runs and that the card's checks hold
    the graphs against.

    Returns (mel (M, B, D), gate (M, B), alignments (M, B, T_in),
    lengths (B,), t_end ()): `t_end` the number of steps the JAX loop ran
    (the first step at which the stop held, plus one, or M), and a
    sequence whose gate never fired has length t_end (JAX :561)."""
    M = cfg.max_decoder_steps
    k = DECODE_CHUNK if k is None else k
    n_chunks = -(-M // k)
    rows = n_chunks * k
    if rows != M:
        masks = torch.cat([masks, masks.new_ones(
            (rows - M, *masks.shape[1:]))])
    if graph is None:
        graph = memory.is_cuda
    def outputs(loop):
        lengths = torch.where(loop.done, loop.lengths, loop.t_end)
        return loop.mel[:M], loop.gate[:M], loop.align[:M], lengths, \
            loop.t_end

    with torch.no_grad():
        if not graph:
            loop = init_decode_loop(cfg, memory, rows)
            for _ in range(n_chunks):
                loop = decode_chunk(cfg, p_dec, loop, masks, memory,
                                    processed_memory, memory_lengths, k,
                                    stop_on_first)
                if bool(loop.done.all()):
                    break
            return outputs(loop)
        if not memory.is_cuda:
            raise ValueError("CUDA graphs need the decode on the card")
        entry = _decode_graph(cfg, p_dec, memory, processed_memory, masks,
                              k, stop_on_first)
        with entry.lock:
            st = entry.static
            st["memory"].copy_(memory)
            st["processed"].copy_(processed_memory)
            st["lengths"].copy_(memory_lengths)
            st["masks"].copy_(masks)
            loop = st["loop"]
            _reset_decode_loop(loop, M)
            for _ in range(n_chunks):
                entry.replay()
                if bool(loop.done.all()):
                    break
            # the next decode overwrites the static buffers
            return tuple(x.clone() for x in outputs(loop))


# ==========================================================================
# autoregressive inference
# ==========================================================================

def _encode(cfg, params, state, ppg, input_lengths, generator, masks):
    memory = encoder_apply(params, state, ppg, input_lengths, generator,
                           masks, mask_convs=True)
    processed = linear(params["decoder"]["attention"]["memory"], memory)
    return memory, processed


def _decode_from_ppg(cfg, params, state, ppg, input_lengths, generator,
                     masks, stop_on_first):
    memory, processed = _encode(cfg, params, state, ppg, input_lengths,
                                generator, masks)
    p_dec = params["decoder"]
    dec_masks = decoder_prenet_masks(
        cfg, len(p_dec["prenet"]["layers"]), ppg.shape[0], ppg.device,
        generator, masks)
    return decode(cfg, p_dec, memory, processed, input_lengths, dec_masks,
                  stop_on_first)


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
    mel_buf, gate_buf, align_buf, _, t_end = _decode_from_ppg(
        cfg, params, state, ppg, input_lengths, generator, masks, True)
    mel_out = mel_buf.permute(1, 2, 0)
    produced = (torch.arange(cfg.max_decoder_steps, device=dev)
                < t_end)[None, None, :]
    residual = postnet_apply(params, state, mel_out, valid_mask=produced)
    mel_post = torch.where(produced, mel_out + residual,
                           mel_out.new_zeros(()))
    return (mel_out, mel_post, gate_buf.T, align_buf.permute(1, 0, 2),
            int(t_end))


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
    mel_buf, gate_buf, align_buf, lengths, _ = _decode_from_ppg(
        cfg, params, state, ppg, input_lengths, generator, masks, False)
    mel_out = mel_buf.permute(1, 2, 0)
    produced = (torch.arange(cfg.max_decoder_steps, device=ppg.device)
                [None, None, :] < lengths[:, None, None])
    residual = postnet_apply(params, state, mel_out, valid_mask=produced)
    mel_post = torch.where(produced, mel_out + residual,
                           mel_out.new_zeros(()))
    return (mel_out, mel_post, gate_buf.T, align_buf.permute(1, 0, 2),
            lengths)
