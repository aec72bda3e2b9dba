"""Seeded random weights, made on the device from `--seed` in a few large
draws, in the layouts of PyTorch's modules and the nested dictionaries the
program takes (and the references read).

Bounds are PyTorch's default initializations (1/sqrt(fan_in) for convs,
Xavier for Tacotron2's linears, 1/sqrt(H) for LSTMs).  One departure for
WaveGlow: its WN end convs are zero at initialization, which makes every
coupling the identity and the coupling nets' output unused; here they get
the bound `end_bound / sqrt(C)`, so that every flow's net shapes the
audio, as a trained model's does."""

from __future__ import annotations

import math

import torch

from benchmark.core.seeds import generator, uniform_leaves
from benchmark.counts.models import waveglow_flow_channels


def _assign(tree_spec, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree_spec)


def _spec_leaves(tree_spec) -> list:
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

    walk(tree_spec)
    return out


def _conv(out_ch, in_ch, k, bound=None):
    b = 1.0 / math.sqrt(in_ch * k) if bound is None else bound
    return {"weight": ((out_ch, in_ch, k), b), "bias": ((out_ch,), b)}


def waveglow(wg: dict, seed: int, device, end_bound: float) -> dict:
    """WaveGlow's weights in the folded inference form: upsample, convinv
    (orthonormal, det +1), wn (start, in_layers, cond_layers,
    res_skip_layers, end)."""
    M, ng = wg["n_mel_channels"], wg["n_group"]
    cfg = wg["WN_config"]
    C, L, k = cfg["n_channels"], cfg["n_layers"], cfg["kernel_size"]
    K = wg["upsample_kernel_size"]
    end_b = end_bound / math.sqrt(C)
    spec = {"upsample": {"weight": ((M, M, K), 1 / math.sqrt(M * K)),
                         "bias": ((M,), 1 / math.sqrt(M * K))},
            "wn": []}
    for c in waveglow_flow_channels(wg):
        n_half = c // 2
        spec["wn"].append({
            "start": _conv(C, n_half, 1),
            "in_layers": [_conv(2 * C, C, k) for _ in range(L)],
            "cond_layers": [_conv(2 * C, M * ng, 1) for _ in range(L)],
            "res_skip_layers": [_conv(2 * C if i < L - 1 else C, C, 1)
                                for i in range(L)],
            "end": _conv(2 * n_half, C, 1, bound=end_b),
        })
    specs = _spec_leaves(spec)
    g = generator(device, seed, "waveglow")
    leaves = uniform_leaves([s for s, _ in specs], [b for _, b in specs], g,
                            device)
    params = _assign(spec, leaves)
    convinv = []
    for c in waveglow_flow_channels(wg):
        q, _ = torch.linalg.qr(torch.randn((c, c), generator=g,
                                           device=device))
        if torch.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        convinv.append({"weight": q.contiguous()})
    params["convinv"] = convinv
    return {"upsample": params["upsample"], "convinv": convinv,
            "wn": params["wn"]}


def _xavier(out_dim, in_dim, k=1, gain=1.0):
    fan_in, fan_out = in_dim * k, out_dim * k
    return gain * math.sqrt(6.0 / (fan_in + fan_out))


def _linear(out_dim, in_dim, gain=1.0, bias=True):
    p = {"weight": ((out_dim, in_dim), _xavier(out_dim, in_dim, 1, gain))}
    if bias:
        p["bias"] = ((out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def _conv_x(out_ch, in_ch, k, gain=1.0, bias=True):
    p = {"weight": ((out_ch, in_ch, k), _xavier(out_ch, in_ch, k, gain))}
    if bias:
        p["bias"] = ((out_ch,), 1.0 / math.sqrt(in_ch * k))
    return p


def _lstm(in_dim, hidden):
    b = 1.0 / math.sqrt(hidden)
    return {"weight_ih": ((4 * hidden, in_dim), b),
            "weight_hh": ((4 * hidden, hidden), b),
            "bias_ih": ((4 * hidden,), b), "bias_hh": ((4 * hidden,), b)}


TANH, RELU = 5.0 / 3.0, math.sqrt(2.0)


def tacotron2(t2: dict, seed: int, device) -> tuple:
    """Tacotron2-PPG's (params, batch-norm state): PyTorch's default
    bounds (Xavier with the reference's gains for linears and convs,
    1/sqrt(H) for LSTMs), batch norms at weight 1, bias 0, running mean
    0, variance 1."""
    S, emb, E = (t2["n_symbols"], t2["symbols_embedding_dim"],
                 t2["encoder_embedding_dim"])
    D, P = t2["n_acoustic_feat_dims"], t2["prenet_dim"]
    A, R, Ad = (t2["attention_rnn_dim"], t2["decoder_rnn_dim"],
                t2["attention_dim"])
    nf, kf = (t2["attention_location_n_filters"],
              t2["attention_location_kernel_size"])
    pe, pk, pn = (t2["postnet_embedding_dim"], t2["postnet_kernel_size"],
                  t2["postnet_n_convolutions"])
    ke, ne = t2["encoder_kernel_size"], t2["encoder_n_convolutions"]
    chans = [D] + [pe] * (pn - 1) + [D]
    spec = {
        "encoder": {
            "prenet": {"layers": [_linear(emb, S, bias=False),
                                  _linear(emb, emb, bias=False)]},
            "convolutions": [{"conv": _conv_x(E, E, ke, RELU)}
                             for _ in range(ne)],
            "lstm_fwd": _lstm(E, E // 2),
            "lstm_bwd": _lstm(E, E // 2),
        },
        "decoder": {
            "prenet": {"layers": [_linear(P, D, bias=False),
                                  _linear(P, P, bias=False)]},
            "attention_rnn": _lstm(P + E, A),
            "attention": {
                "query": _linear(Ad, A, TANH, bias=False),
                "memory": _linear(Ad, E, TANH, bias=False),
                "v": _linear(1, Ad, bias=False),
                "location_conv": _conv_x(nf, 2, kf, bias=False),
                "location_dense": _linear(Ad, nf, TANH, bias=False),
            },
            "decoder_rnn": _lstm(A + E, R),
            "linear_projection": _linear(D, R + E),
            "gate_layer": _linear(1, R + E),
        },
        "postnet": {"convolutions": [
            {"conv": _conv_x(chans[i + 1], chans[i], pk,
                             1.0 if i == pn - 1 else TANH)}
            for i in range(pn)]},
    }
    specs = _spec_leaves(spec)
    leaves = uniform_leaves([s for s, _ in specs], [b for _, b in specs],
                            generator(device, seed, "tacotron2"), device)
    params = _assign(spec, leaves)

    def bn(c):
        return {"weight": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    def stats(c):
        return {"running_mean": torch.zeros(c, device=device),
                "running_var": torch.ones(c, device=device)}

    for conv in params["encoder"]["convolutions"]:
        conv["bn"] = bn(E)
    for i, conv in enumerate(params["postnet"]["convolutions"]):
        conv["bn"] = bn(chans[i + 1])
    state = {"encoder": {"convolutions": [stats(E) for _ in range(ne)]},
             "postnet": {"convolutions": [stats(c) for c in chans[1:]]}}
    return params, state


def flatten(tree, prefix: str = "") -> dict:
    """{"a.b.0.c": leaf} of a nested dict / list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out
