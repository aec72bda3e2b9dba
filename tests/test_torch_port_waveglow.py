"""The port's WaveGlow inference, STFT, denoiser and WaveGlow weight bridge
against the JAX package on the CPU, at tiny widths.

Inputs and noise come from numpy with a seed and go through both packages.
Tolerances: atol 2e-5 on audio in f32 (same arithmetic in another
summation order through 2-5 flows); 1e-5 on single ops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWaveGlowConfig
from fac_via_ppg_torch.dsp import stft as t_stft
from fac_via_ppg_torch.models import denoiser as t_den
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig
from fac_via_ppg_tpu.dsp import stft as j_stft
from fac_via_ppg_tpu.models import denoiser as j_den
from fac_via_ppg_tpu.models import waveglow as jwg

# tests/test_wn_pallas.py's tiny config, and one with early outputs
CFGS = {
    "tiny": dict(n_mel_channels=16, hop_length=32, n_flows=2, n_group=8,
                 n_early_every=4, n_early_size=2, wn_n_layers=3,
                 wn_n_channels=32, wn_kernel_size=3,
                 upsample_kernel_size=256),
    "early": dict(n_mel_channels=16, hop_length=32, n_flows=5, n_group=8,
                  n_early_every=2, n_early_size=2, wn_n_layers=2,
                  wn_n_channels=16, wn_kernel_size=3,
                  upsample_kernel_size=256),
}


def _params(cfg_kw, seed=3):
    cfg = WaveGlowConfig(**cfg_kw)
    train = jwg.init_waveglow(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    # non-trivial couplings: the end layers are zero at init
    for wn in train["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*np.shape(wn["end"]["weight"])) * 0.1, jnp.float32)
        wn["end"]["bias"] = jnp.asarray(
            rng.randn(*np.shape(wn["end"]["bias"])) * 0.1, jnp.float32)
    return cfg, TWaveGlowConfig(**cfg_kw), train


def _noise(cfg, B, G, seed):
    """Unit draws in waveglow_infer's order: seed chunk, then k descending."""
    rng = np.random.RandomState(seed)
    chans = jwg.flow_channels(cfg)
    out = [rng.randn(B, chans[-1], G).astype(np.float32)]
    for k in reversed(range(cfg.n_flows)):
        if k % cfg.n_early_every == 0 and k > 0:
            out.append(rng.randn(B, cfg.n_early_size, G).astype(np.float32))
    return out


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("wn_impl", ["conv", "layer"])
def test_waveglow_infer_matches_jax(name, wn_impl):
    cfg, tcfg, train = _params(CFGS[name])
    params = jwg.remove_weightnorm(train)
    rng = np.random.RandomState(7)
    mel = rng.randn(2, cfg.n_mel_channels, 12).astype(np.float32)
    G = 12 * cfg.hop_length // cfg.n_group
    noise = _noise(cfg, 2, G, 11)
    ref = jwg.waveglow_infer(cfg, params, jnp.asarray(mel), 0.8, None,
                             noise=noise)
    out = twg.waveglow_infer(tcfg, weights.waveglow_from_jax(params),
                             torch.from_numpy(mel), 0.8, noise=noise,
                             wn_impl=wn_impl)
    assert out.shape == (2, 12 * cfg.hop_length)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)


def test_waveglow_infer_train_form_matches_jax():
    """The bridge folds weight norm as the JAX package does; inverses are
    then computed on the fly in both."""
    cfg, tcfg, train = _params(CFGS["early"], seed=5)
    mel = np.random.RandomState(1).randn(1, 16, 8).astype(np.float32)
    noise = _noise(cfg, 1, 8 * cfg.hop_length // cfg.n_group, 2)
    ref = jwg.waveglow_infer(cfg, train, jnp.asarray(mel), 0.6, None,
                             noise=noise)
    out = twg.waveglow_infer(tcfg, weights.waveglow_from_jax(train),
                             torch.from_numpy(mel), 0.6, noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)


def test_waveglow_infer_bf16_matches_jax():
    """bf16 flows with f32 inverses: agreement to bf16 rounding."""
    cfg, tcfg, train = _params(CFGS["tiny"])
    params = jwg.remove_weightnorm(train)
    mel = np.random.RandomState(4).randn(1, 16, 8).astype(np.float32)
    noise = _noise(cfg, 1, 8 * cfg.hop_length // cfg.n_group, 5)
    ref = jwg.waveglow_infer(cfg, params, jnp.asarray(mel), 0.5, None,
                             dtype=jnp.bfloat16, noise=noise)
    for impl in ("conv", "layer"):
        out = twg.waveglow_infer(tcfg, weights.waveglow_from_jax(params),
                                 torch.from_numpy(mel), 0.5,
                                 dtype=torch.bfloat16, noise=noise,
                                 wn_impl=impl)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=5e-2)


def test_upsample_group_ungroup_match_jax():
    cfg, tcfg, train = _params(CFGS["tiny"])
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 16, 9).astype(np.float32)
    up_j = jwg.upsample_phase_matmul(train["upsample"], jnp.asarray(mel),
                                     cfg.hop_length)
    up_t = twg.upsample_phase_matmul(weights.to_torch(train["upsample"]),
                                     torch.from_numpy(mel), cfg.hop_length)
    assert up_t.shape == (2, 16, 9 * cfg.hop_length)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=1e-5)
    g_j = jwg.group_spect(up_j, cfg.n_group)
    g_t = twg.group_spect(up_t, cfg.n_group)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)
    a = rng.randn(2, 8, 20).astype(np.float32)
    np.testing.assert_array_equal(
        twg.ungroup_audio(torch.from_numpy(a)).numpy(),
        np.asarray(jwg.ungroup_audio(jnp.asarray(a))))


@pytest.mark.parametrize("form", ["train", "remove_weightnorm"])
def test_waveglow_bridge_gives_identical_tensors(form):
    """JAX init_waveglow -> weights.py: every leaf equals the JAX package's
    own folded form, and the inverses are kept.  Leaves the bridge copies
    are bit-identical; a weight it folds from (g, v) is within 8 ulp, since
    XLA and torch sum the norm's squares in different orders."""
    cfg, _, train = _params(CFGS["early"])
    src = train if form == "train" else jwg.remove_weightnorm(train)
    folded = jwg.remove_weightnorm(train)
    out = weights.waveglow_from_jax(src)
    np.testing.assert_array_equal(out["upsample"]["weight"].numpy(),
                                  np.asarray(folded["upsample"]["weight"]))
    for k, (wn_t, wn_j) in enumerate(zip(out["wn"], folded["wn"])):
        np.testing.assert_array_max_ulp(wn_t["start"]["weight"].numpy(),
                                        np.asarray(wn_j["start"]["weight"]),
                                        0 if form != "train" else 8)
        for part, leaf in (("start", "bias"), ("end", "weight"),
                           ("end", "bias")):
            np.testing.assert_array_equal(wn_t[part][leaf].numpy(),
                                          np.asarray(wn_j[part][leaf]))
        for group in ("in_layers", "cond_layers", "res_skip_layers"):
            for pt, pj in zip(wn_t[group], wn_j[group]):
                assert set(pt) == {"weight", "bias"}
                if form == "train":
                    np.testing.assert_array_max_ulp(
                        pt["weight"].numpy(), np.asarray(pj["weight"]), 8)
                else:
                    np.testing.assert_array_equal(pt["weight"].numpy(),
                                                  np.asarray(pj["weight"]))
                np.testing.assert_array_equal(pt["bias"].numpy(),
                                              np.asarray(pj["bias"]))
        inv = out["convinv"][k].get("weight_inverse")
        if form == "train":
            assert inv is None
        else:
            np.testing.assert_array_equal(
                inv.numpy(), np.asarray(folded["convinv"][k]["weight_inverse"]))


def test_init_waveglow_structure_matches_jax():
    cfg, tcfg, train = _params(CFGS["early"])
    folded = jwg.remove_weightnorm(train)
    ours = twg.remove_weightnorm(
        twg.init_waveglow(tcfg, torch.Generator().manual_seed(0)))
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(np.shape(x)), tree)
    assert shapes(jax.tree_util.tree_map(np.asarray, ours)) == shapes(folded)
    for p in ours["convinv"]:
        assert abs(float(torch.linalg.det(p["weight"])) - 1.0) < 1e-4


def test_stft_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3000).astype(np.float32) * 0.3
    js = j_stft.STFT(1024, 160, 1024)
    ts = t_stft.STFT(1024, 160, 1024)
    mag_j, ph_j = js.transform(jnp.asarray(x))
    mag_t, ph_t = ts.transform(torch.from_numpy(x))
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=2e-4,
                               rtol=1e-5)
    y_j = js.inverse(mag_j, ph_j)
    y_t = ts.inverse(mag_t, ph_t)
    assert y_t.shape == tuple(y_j.shape)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(
        t_stft.window_sumsquare(t_stft.hann_window(1024), 7, 160, 1024),
        j_stft.window_sumsquare(j_stft.hann_window(1024), 7, 160, 1024),
        atol=1e-6)


def test_denoiser_matches_jax():
    cfg, tcfg, train = _params(dict(CFGS["tiny"], n_mel_channels=80,
                                    hop_length=160, upsample_kernel_size=1024,
                                    wn_n_channels=16, wn_n_layers=2))
    params = jwg.remove_weightnorm(train)
    den_j = j_den.Denoiser(cfg, params)
    den_t = t_den.Denoiser(tcfg, weights.waveglow_from_jax(params))
    np.testing.assert_allclose(den_t.bias_spec.numpy(),
                               np.asarray(den_j.bias_spec), atol=1e-5)
    audio = np.random.RandomState(3).randn(2, 4000).astype(np.float32) * 0.2
    out_j = den_j(jnp.asarray(audio), strength=0.1)
    out_t = den_t(torch.from_numpy(audio), strength=0.1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
