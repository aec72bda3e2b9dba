"""The port's whole serving slice, `FusedSynthesizer`, against the JAX
package's on the CPU, at tiny widths.

Both run wav -> features -> nnet3 AM -> batched Tacotron2 decode -> silence
fill -> WaveGlow -> denoiser -> int16 PCM on the same weights, features and
prenet keep-masks (recorded from the JAX run), at sigma=0 so the vocoder
draws no noise.  Tolerance: PCM within 2 LSB, equal lengths.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import Tacotron2Config as TT2Config
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWGConfig
from fac_via_ppg_torch.eval.fused import FusedSynthesizer as TFused
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.utils import device as t_device
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_tpu.eval.fused import FusedSynthesizer as JFused
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models.tacotron2 import init_tacotron2
from fac_via_ppg_tpu.models.waveglow import init_waveglow, remove_weightnorm
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from tests.torch_port_helpers import TINY_T2, record_prenet_masks

MAX_FRAMES = 8
WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    paths = dict(
        nnet_path=str(root / "bundle/am/final.raw.txt"),
        lda_path=str(root / "bundle/feats/final.mat"),
        reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
        splice_opts_path=str(root / "bundle/feats/splice_opts"))
    t2_cfg = Tacotron2Config(**TINY_T2)
    t2_params, t2_state = jax.jit(init_tacotron2, static_argnums=1)(
        jax.random.PRNGKey(0), t2_cfg)
    # a gate that never fires: every utterance decodes MAX_FRAMES frames
    t2_params["decoder"]["gate_layer"]["bias"] = jnp.full((1,), -30.0)
    wg_cfg = WaveGlowConfig(**WG)
    wg_params = remove_weightnorm(jax.jit(init_waveglow, static_argnums=1)(
        jax.random.PRNGKey(1), wg_cfg))
    rng = np.random.RandomState(2)
    for wn in wg_params["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*np.shape(wn["end"]["weight"])) * 0.05, jnp.float32)
    wavs = []
    for i, n in enumerate((9600, 6400)):
        t = np.arange(n) / 16000.0
        x = np.sin(2 * np.pi * (150 + 40 * i) * t) * 9000
        x += rng.randn(n) * 300
        path = str(root / f"u{i}.wav")
        wavfile.write(path, 16000, x.astype(np.int16))
        wavs.append(path)
    return dict(paths=paths, t2=(t2_cfg, t2_params, t2_state),
                wg=(wg_cfg, wg_params), wavs=wavs)


def _jax_fused(setup):
    t2_cfg, t2_params, t2_state = setup["t2"]
    wg_cfg, wg_params = setup["wg"]
    return JFused(t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
                  deps=j_ppg.DependenciesPPG(**setup["paths"]), sigma=0.0,
                  serving_dtype=None, max_frames=MAX_FRAMES)


def _port_fused(setup, **kw):
    t2_cfg, t2_params, t2_state = setup["t2"]
    wg_cfg, wg_params = setup["wg"]
    tp, ts = weights.tacotron2_from_jax(t2_params, t2_state)
    return TFused(TT2Config(**TINY_T2), tp, ts, TWGConfig(**WG),
                  weights.waveglow_from_jax(wg_params),
                  deps=t_ppg.DependenciesPPG(**setup["paths"]), sigma=0.0,
                  max_frames=MAX_FRAMES, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run(setup):
    """One JAX run, batch of 2 padded to 3 (the pad row is trimmed), with
    JAX's MFCC held to its numpy backend (its native one agrees with numpy
    only to 1e-3) and the prenet keep-masks recorded."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            j_ppg, "compute_mfcc",
            lambda *a, **k: j_mfcc.compute_mfcc(*a, backend="numpy", **k))
        jf = _jax_fused(setup)
        pairs = [jf.featurize(p, dither=0.0) for p in setup["wavs"]]
        masks = record_prenet_masks(mp)
        pcm = jf.synthesize_feature_pairs(pairs, jax.random.PRNGKey(5),
                                          pad_batch_to=3)
        jax.effects_barrier()
    return pairs, masks, pcm


@pytest.mark.parametrize("pad_batch_to", [None, 3])
def test_synthesize_feature_pairs_matches_jax(setup, jax_run, pad_batch_to):
    pairs, masks, ref = jax_run
    if pad_batch_to is None:
        # the same draws for the two real rows
        masks = [m[:2] for m in masks]
    tf = _port_fused(setup, serving_dtype=None)
    port_pairs = [tf.featurize(p, dither=0.0) for p in setup["wavs"]]
    for (f_t, n_t), (f_j, n_j) in zip(port_pairs, pairs):
        assert n_t == n_j and f_t.shape == f_j.shape
        np.testing.assert_allclose(f_t, f_j, atol=1e-4, rtol=1e-5)
    out = tf.synthesize_feature_pairs(pairs, pad_batch_to=pad_batch_to,
                                      dropout_masks=masks)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.dtype == np.int16 and len(o) == len(r)
        assert len(o) == MAX_FRAMES * WG["hop_length"]
        assert np.abs(o.astype(np.int32) - r.astype(np.int32)).max() <= 2
        assert np.abs(r.astype(np.int32)).max() > 100  # not silence


def test_launch_returns_device_tensors_and_bf16_serves(setup):
    """The launch hands back tensors without reading them; bf16 serving
    (WaveGlow only, f32 inverses) gives PCM of the same lengths."""
    tf = _port_fused(setup, serving_dtype=torch.bfloat16)
    assert all(p["weight_inverse"].dtype == torch.float32
               for p in tf.wg_params["convinv"])
    assert tf.wg_params["upsample"]["weight"].dtype == torch.bfloat16
    assert tf.t2_params["decoder"]["gate_layer"]["weight"].dtype == \
        torch.float32
    pairs = [tf.featurize(p, dither=0.0) for p in setup["wavs"]]
    handle = tf.launch_feature_pairs(pairs,
                                     torch.Generator().manual_seed(1))
    pcm, mel_lens, n_real = handle
    assert isinstance(pcm, torch.Tensor) and pcm.dtype == torch.int16
    assert n_real == 2 and mel_lens.tolist() == [MAX_FRAMES] * 2
    out = tf.collect_feature_pairs(handle)
    assert [len(o) for o in out] == [MAX_FRAMES * WG["hop_length"]] * 2
    single = tf(setup["wavs"][1], dither=0.0)
    assert single.dtype == np.int16 and len(single) == len(out[1])


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_device.resolve_device(None)
    assert t_device.resolve_device("cpu") == torch.device("cpu")
