"""The port's Tacotron2 inference, recurrent ops, layers and Tacotron2
weight bridge against the JAX package on the CPU, at tiny widths.

The prenet dropout is always on; its JAX keep-masks are recorded at run
time (tests/torch_port_helpers.record_prenet_masks, a host callback) and injected into the
port in the same call order.  Tolerance: atol 1e-5 in f32 (same
arithmetic, other summation order); decode lengths must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import Tacotron2Config as TConfig
from fac_via_ppg_torch.models import tacotron2 as tt
from fac_via_ppg_torch.ops import layers as tl
from fac_via_ppg_torch.ops import rnn as trnn
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config
from fac_via_ppg_tpu.models import tacotron2 as jt
from fac_via_ppg_tpu.ops import initializers as ji
from fac_via_ppg_tpu.ops import rnn as jrnn
from tests.torch_port_helpers import TINY_T2, record_prenet_masks


def _model(seed=0, **over):
    kw = dict(TINY_T2, **over)
    cfg = Tacotron2Config(**kw)
    params, state = jax.jit(jt.init_tacotron2, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    # non-trivial BN statistics, so eval-mode BN is exercised
    rng = np.random.RandomState(seed)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.abs(rng.randn(*x.shape)) * 0.5 + 0.5,
                              jnp.float32), state)
    return cfg, TConfig(**kw), params, state


def _ppg(B, T, D, seed):
    rng = np.random.RandomState(seed)
    x = np.exp(rng.randn(B, D, T))
    return (x / x.sum(1, keepdims=True)).astype(np.float32)


def test_tacotron2_inference_batched_matches_jax(monkeypatch):
    """A gate scaled so the three sequences stop apart: after 7 and 8
    steps, and one at the cap of 10 (every logit at least 0.02 from the
    threshold, far above the two packages' 1e-6 difference)."""
    cfg, tcfg, params, state = _model(4, max_decoder_steps=10)
    gate = params["decoder"]["gate_layer"]
    gate["weight"] = gate["weight"] * 10.0
    gate["bias"] = jnp.full_like(gate["bias"], -1.4815483)
    B, T = 3, 11
    ppg = _ppg(B, T, cfg.n_symbols, 1)
    lengths = np.array([11, 7, 9], np.int32)
    masks = record_prenet_masks(monkeypatch)
    ref = jax.jit(jt.tacotron2_inference_batched, static_argnums=0)(
        cfg, params, state, jnp.asarray(ppg), jnp.asarray(lengths),
        jax.random.PRNGKey(3))
    jax.effects_barrier()
    tp, ts = weights.tacotron2_from_jax(params, state)
    it = iter(masks)
    out = tt.tacotron2_inference_batched(
        tcfg, tp, ts, torch.from_numpy(ppg),
        torch.from_numpy(lengths).long(), masks=it)
    assert next(it, None) is None, "the port consumed fewer masks"
    np.testing.assert_array_equal(np.asarray(ref[4]), [7, 10, 8])
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_tacotron2_inference_single_matches_jax(monkeypatch):
    cfg, tcfg, params, state = _model(1, max_decoder_steps=12)
    ppg = _ppg(1, 9, cfg.n_symbols, 2)
    masks = record_prenet_masks(monkeypatch)
    ref = jax.jit(jt.tacotron2_inference, static_argnums=0)(
        cfg, params, state, jnp.asarray(ppg), jax.random.PRNGKey(4))
    jax.effects_barrier()
    tp, ts = weights.tacotron2_from_jax(params, state)
    out = tt.tacotron2_inference(tcfg, tp, ts, torch.from_numpy(ppg),
                                 masks=iter(masks))
    assert out[4] == int(ref[4])
    for o, r in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0)


def test_tacotron2_inference_rejects_batches():
    _, tcfg, params, state = _model(0)
    tp, ts = weights.tacotron2_from_jax(params, state)
    with pytest.raises(ValueError, match="sequence 0"):
        tt.tacotron2_inference(tcfg, tp, ts, torch.zeros(2, 16, 5))


@pytest.mark.parametrize("t", [0, 5, 30])
def test_windowed_attention_mask_matches_jax(t):
    lengths = np.array([3, 10, 25, 40], np.int32)
    ref = jt.windowed_attention_mask(jnp.asarray(lengths), 20, t, 40)
    out = tt.windowed_attention_mask(torch.from_numpy(lengths).long(), 20,
                                     torch.tensor(t), 40)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bidirectional_lstm_matches_jax():
    rng = np.random.RandomState(5)
    fwd = ji.lstm_params(jax.random.PRNGKey(0), 6, 5)
    bwd = ji.lstm_params(jax.random.PRNGKey(1), 6, 5)
    xs = rng.randn(3, 8, 6).astype(np.float32)
    lengths = np.array([8, 3, 6], np.int32)
    ref = jrnn.bidirectional_lstm(fwd, bwd, jnp.asarray(xs),
                                  jnp.asarray(lengths))
    out = trnn.bidirectional_lstm(weights.to_torch(fwd), weights.to_torch(bwd),
                                  torch.from_numpy(xs),
                                  torch.from_numpy(lengths).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_layers_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 9).astype(np.float32)
    conv = ji.conv1d_params(jax.random.PRNGKey(0), 4, 3, 5)
    np.testing.assert_allclose(
        tl.conv1d(weights.to_torch(conv), torch.from_numpy(x), padding=2)
        .numpy(),
        np.asarray(ji.conv1d_apply(conv, jnp.asarray(x), padding=2)),
        atol=1e-5)
    lin = ji.linear_params(jax.random.PRNGKey(1), 9, 5)
    np.testing.assert_allclose(
        tl.linear(weights.to_torch(lin), torch.from_numpy(x)).numpy(),
        np.asarray(ji.linear_apply(lin, jnp.asarray(x))), atol=1e-5)
    bn_p = {"weight": jnp.asarray(rng.rand(4) + 0.5, jnp.float32),
            "bias": jnp.asarray(rng.randn(4), jnp.float32)}
    bn_s = {"running_mean": jnp.asarray(rng.randn(4), jnp.float32),
            "running_var": jnp.asarray(rng.rand(4) + 0.5, jnp.float32)}
    ref, _ = ji.batchnorm_apply(bn_p, bn_s, jnp.asarray(x), False)
    out = tl.batchnorm(weights.to_torch(bn_p), weights.to_torch(bn_s),
                       torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    cell = ji.lstm_params(jax.random.PRNGKey(2), 9, 5)
    h = rng.randn(2, 5).astype(np.float32)
    c = rng.randn(2, 5).astype(np.float32)
    xi = x[:, 0]
    ref = ji.lstm_cell(cell, jnp.asarray(xi), jnp.asarray(h), jnp.asarray(c))
    out = tl.lstm_cell(weights.to_torch(cell), torch.from_numpy(xi),
                       torch.from_numpy(h), torch.from_numpy(c))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_dropout_uses_injected_mask():
    x = torch.arange(1.0, 7.0).reshape(2, 3)
    keep = torch.tensor([[True, False, True], [False, False, True]])
    out = tl.dropout(x, 0.5, keep_mask=keep)
    assert torch.equal(out, torch.where(keep, 2 * x, torch.zeros(())))
    g = torch.Generator().manual_seed(0)
    drawn = tl.dropout(torch.ones(1000), 0.5, generator=g)
    assert set(drawn.unique().tolist()) <= {0.0, 2.0}
    assert 400 < int((drawn > 0).sum()) < 600


def test_tacotron2_bridge_and_init_structure():
    """JAX init_tacotron2 -> weights.py gives identical tensors, and the
    port's own init has the JAX package's structure and shapes."""
    cfg, tcfg, params, state = _model(2)
    tp, ts = weights.tacotron2_from_jax(params, state)
    for tree_j, tree_t in ((params, tp), (state, ts)):
        flat_j = jax.tree_util.tree_leaves_with_path(tree_j)
        flat_t = jax.tree_util.tree_leaves_with_path(tree_t)
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_j, flat_t):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ip, is_ = tt.init_tacotron2(tcfg, torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(x.shape), tree)
    assert shapes(ip) == shapes(params)
    assert shapes(is_) == shapes(state)
