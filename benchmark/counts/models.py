"""Whole-model FLOP counts (multiply-adds count two) from a configuration
file's widths, for the `mfu` metrics.  Only the products are counted (the
convolutions, matmuls and LSTM gates); elementwise work is left out, so a
share is a floor of the true one.  Training counts the backward pass as
twice the forward."""

from __future__ import annotations


def waveglow_flow_channels(wg: dict) -> list:
    """Audio channels entering each flow (reference glow.py:199-206)."""
    chans, remaining = [], wg["n_group"]
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            remaining -= wg["n_early_size"]
        chans.append(remaining)
    return chans


def waveglow_infer_flops(wg: dict, hop: int, samples: int) -> float:
    """FLOPs of WaveGlow's inverse pass producing `samples` audio samples:
    the upsampler (a transposed conv: every output sample takes M x M x
    K/hop products), then per group of n_group samples each flow's 1x1
    inverse and its WN (start, L x (dilated in conv, cond, res_skip),
    end)."""
    M, ng = wg["n_mel_channels"], wg["n_group"]
    wn = wg["WN_config"]
    C, L, k = wn["n_channels"], wn["n_layers"], wn["kernel_size"]
    K = wg["upsample_kernel_size"]
    per_group = 0
    for c in waveglow_flow_channels(wg):
        n_half = c // 2
        per_group += 2 * c * c                           # 1x1 inverse
        per_group += 2 * n_half * C                      # start
        per_group += L * 2 * (2 * C) * C * k             # in layers
        per_group += L * 2 * (2 * C) * (M * ng)          # cond layers
        per_group += (L - 1) * 2 * (2 * C) * C + 2 * C * C  # res_skip
        per_group += 2 * C * 2 * n_half                  # end
    upsample = 2 * M * M * K / hop
    return samples / ng * per_group + samples * upsample


def _lstm(in_dim: int, hidden: int) -> int:
    return 2 * 4 * hidden * (in_dim + hidden)


def tacotron2_forward_flops(t2: dict, t_in: int, t_out: int) -> float:
    """FLOPs of one utterance's teacher-forced forward: the encoder
    (prenet, convs, BiLSTM) over t_in frames, the decoder's t_out steps
    (prenet, attention LSTM, location-sensitive attention over t_in,
    decoder LSTM, projections) and the postnet over t_out."""
    S, E = t2["n_symbols"], t2["encoder_embedding_dim"]
    P, A, R = t2["prenet_dim"], t2["attention_rnn_dim"], t2["decoder_rnn_dim"]
    D, Ad = t2["n_acoustic_feat_dims"], t2["attention_dim"]
    emb = t2["symbols_embedding_dim"]
    nf, kf = (t2["attention_location_n_filters"],
              t2["attention_location_kernel_size"])
    pe, pk, pn = (t2["postnet_embedding_dim"], t2["postnet_kernel_size"],
                  t2["postnet_n_convolutions"])
    enc = 2 * t_in * (S * emb + emb * emb)
    enc += t2["encoder_n_convolutions"] * 2 * t_in * E * E \
        * t2["encoder_kernel_size"]
    enc += t_in * _lstm(E, E // 2) * 2
    enc += 2 * t_in * E * Ad                          # processed memory
    step = 2 * (D * P + P * P)                        # prenet
    step += _lstm(P + E, A)
    step += 2 * A * Ad                                # query
    step += t_in * (2 * 2 * nf * kf + 2 * nf * Ad + 2 * Ad + 2 * E)
    step += _lstm(A + E, R)
    step += 2 * (R + E) * (D + 1)                     # projection, gate
    chans = [D] + [pe] * (pn - 1) + [D]
    post = sum(2 * t_out * chans[i] * chans[i + 1] * pk for i in range(pn))
    return enc + t_out * step + post


def tacotron2_train_flops(t2: dict, lengths) -> float:
    """A training step's forward and backward FLOPs over a batch whose
    rows have the (t_in, t_out) `lengths`."""
    return 3 * sum(tacotron2_forward_flops(t2, a, b) for a, b in lengths)
