"""The port's device-resident Tacotron2 decode against the JAX package's
`lax.while_loop` on the CPU, at tiny widths.

The port runs the decode as chunks of k steps (models/tacotron2.py::
decode_chunk), the host reading the stop once per chunk; on the CPU the
chunks run eagerly, the plain version of the card's CUDA graphs.  The
prenet keep-masks are recorded from the JAX run
(tests/torch_port_helpers.record_prenet_masks) and injected.  Lengths and
end steps must be equal; mels within atol 1e-5 (f32, the same arithmetic
in another summation order).  M = 20 steps, a multiple of neither 3 nor 7;
the gate weights are negated so that the logits rise over the steps, and
the biases put every stop at least 3.6e-3 from the threshold.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import Tacotron2Config as TConfig
from fac_via_ppg_torch.models import tacotron2 as tt
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config
from fac_via_ppg_tpu.models import tacotron2 as jt
from tests.torch_port_helpers import TINY_T2, record_prenet_masks

M = 20
CHUNKS = [1, 3, 7, 64]
# gate bias -> the batched lengths it gives (the stop patterns)
BATCHED_GATES = {"all": (0.15, [12, 8, 9, 6]),
                 "some": (0.12, [20, 9, 10, 6]),
                 "none": (-30.0, [20, 20, 20, 20])}
# gate bias -> the single sequence's end step
SINGLE_GATES = {"mid": (0.11, 11), "cap": (0.0, 20)}
LENGTHS = np.array([13, 7, 10, 4], np.int32)


def _model(bias):
    kw = dict(TINY_T2, max_decoder_steps=M)
    cfg = Tacotron2Config(**kw)
    params, state = jax.jit(jt.init_tacotron2, static_argnums=1)(
        jax.random.PRNGKey(7), cfg)
    rng = np.random.RandomState(7)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.randn(*x.shape)) * 0.5 + 0.5,
                              jnp.float32), state)
    gate = params["decoder"]["gate_layer"]
    gate["weight"] = gate["weight"] * -20.0
    gate["bias"] = jnp.full_like(gate["bias"], bias)
    return cfg, TConfig(**kw), params, state


def _ppg(B, T):
    x = np.exp(np.random.RandomState(1).randn(B, 16, T))
    return (x / x.sum(1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def batched_runs():
    """One JAX batched decode per stop pattern, its masks recorded."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        for name, (bias, _) in BATCHED_GATES.items():
            cfg, tcfg, params, state = _model(bias)
            n0 = len(masks)
            ref = jax.jit(jt.tacotron2_inference_batched, static_argnums=0)(
                cfg, params, state, jnp.asarray(_ppg(4, 13)),
                jnp.asarray(LENGTHS), jax.random.PRNGKey(3))
            ref = [np.asarray(r) for r in ref]
            jax.effects_barrier()
            runs[name] = (tcfg, weights.tacotron2_from_jax(params, state),
                          ref, masks[n0:])
    return runs


@pytest.fixture(scope="module")
def single_runs():
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        for name, (bias, _) in SINGLE_GATES.items():
            cfg, tcfg, params, state = _model(bias)
            n0 = len(masks)
            ref = jax.jit(jt.tacotron2_inference, static_argnums=0)(
                cfg, params, state, jnp.asarray(_ppg(1, 9)),
                jax.random.PRNGKey(4))
            ref = [np.asarray(r) for r in ref]
            jax.effects_barrier()
            runs[name] = (tcfg, weights.tacotron2_from_jax(params, state),
                          ref, masks[n0:])
    return runs


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("stops", list(BATCHED_GATES))
def test_batched_decode_matches_jax(batched_runs, monkeypatch, stops, k):
    tcfg, (tp, ts), ref, masks = batched_runs[stops]
    monkeypatch.setattr(tt, "DECODE_CHUNK", k)
    out = tt.tacotron2_inference_batched(
        tcfg, tp, ts, torch.from_numpy(_ppg(4, 13)),
        torch.from_numpy(LENGTHS).long(), masks=iter(masks))
    np.testing.assert_array_equal(ref[4], BATCHED_GATES[stops][1])
    np.testing.assert_array_equal(out[4].numpy(), ref[4])
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("stops", list(SINGLE_GATES))
def test_single_decode_matches_jax(single_runs, monkeypatch, stops, k):
    tcfg, (tp, ts), ref, masks = single_runs[stops]
    monkeypatch.setattr(tt, "DECODE_CHUNK", k)
    out = tt.tacotron2_inference(tcfg, tp, ts, torch.from_numpy(_ppg(1, 9)),
                                 masks=iter(masks))
    assert out[4] == int(ref[4]) == SINGLE_GATES[stops][1]
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", [0, 5, 19, 20, 40])
def test_windowed_attention_mask_tensor_step(t):
    lengths = np.array([1, 3, 10, 25, 40], np.int32)
    ref = jt.windowed_attention_mask(jnp.asarray(lengths), 20, jnp.int32(t),
                                     40)
    step = torch.tensor(t)
    out = tt.windowed_attention_mask(torch.from_numpy(lengths).long(), 20,
                                     step, 40)
    assert step.dtype == torch.int64 and step.shape == ()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_short_mask_list_is_padded_with_ones(batched_runs):
    """The recorded list (only the steps JAX ran) gives the outputs of the
    same list padded to every step with keep-all masks."""
    tcfg, (tp, ts), _, masks = batched_runs["all"]
    steps = (len(masks) - 2) // 2
    assert steps == 12 < M
    ones = [np.ones_like(masks[-1])] * (2 * (M - steps))
    args = (tcfg, tp, ts, torch.from_numpy(_ppg(4, 13)),
            torch.from_numpy(LENGTHS).long())
    short = tt.tacotron2_inference_batched(*args, masks=iter(masks))
    padded = tt.tacotron2_inference_batched(*args, masks=iter(masks + ones))
    for a, b in zip(short, padded):
        assert torch.equal(a, b)
    dec = tt.decoder_prenet_masks(tcfg, 2, 4, "cpu",
                                  masks=iter(masks[2:]))
    assert dec.shape == (M, 2, 4, tcfg.prenet_dim)
    assert dec[steps:].all()
    with pytest.raises(ValueError, match="a step"):
        tt.decoder_prenet_masks(tcfg, 2, 4, "cpu", masks=iter(masks[3:]))


@pytest.mark.parametrize("stop_on_first", [False, True])
def test_decode_chunk_reads_nothing_on_the_host(batched_runs, monkeypatch,
                                                stop_on_first):
    """A chunk never reads a tensor's value on the host: `bool`, `.item`
    and `.tolist` raise while one runs, past the stop (t >= 12) too."""
    tcfg, (tp, ts), _, _ = batched_runs["all"]
    p_dec = tp["decoder"]
    g = torch.Generator().manual_seed(0)
    memory, processed = tt._encode(tcfg, tp, ts, torch.from_numpy(_ppg(4, 13)),
                                   torch.from_numpy(LENGTHS).long(), g, None)
    masks = tt.decoder_prenet_masks(tcfg, 2, 4, "cpu", g)
    masks = torch.cat([masks, masks.new_ones((1, 2, 4, tcfg.prenet_dim))])
    loop = tt.init_decode_loop(tcfg, memory, M + 1)

    def refuse(*a, **k):
        raise AssertionError("a decode chunk read a tensor on the host")

    with monkeypatch.context() as mp:
        for name in ("__bool__", "item", "tolist"):
            mp.setattr(torch.Tensor, name, refuse)
        out = tt.decode_chunk(tcfg, p_dec, loop, masks, memory, processed,
                              torch.from_numpy(LENGTHS).long(), M + 1,
                              stop_on_first)
    assert int(out.t) == M + 1
    assert int(out.t_end) <= M
