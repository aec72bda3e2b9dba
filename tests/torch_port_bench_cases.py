"""The tiny cases of the benchmark tests (tests/test_torch_port_bench*.py):
a tiny substitute bundle, tiny port models, the JAX bench's model
factories monkeypatched to the same tiny sizes, and each configuration's
pair of calls (JAX bench, port bench), with the JAX bench's fixed sizes
passed to the port's functions as arguments."""

import functools

import numpy as np
import pytest
import torch

import jax

import bench as j_bench
from fac_via_ppg_torch import bench as t_bench
from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.models import init_tacotron2, init_waveglow
from fac_via_ppg_torch.models.waveglow import remove_weightnorm
from fac_via_ppg_tpu.configs import hparams as j_hp
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models import tacotron2 as j_t2
from fac_via_ppg_tpu.models import waveglow as j_wg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from tests.torch_port_helpers import TINY_T2

WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
UTT_S = 0.3


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    make_bundle(str(root), n_senones=16, n_phones=4, hidden_dim=8,
                num_layers=1)
    return dict(nnet_path=str(root / "am/final.raw.txt"),
                lda_path=str(root / "feats/final.mat"),
                reduce_dim_path=str(root / "feats/reduce_dim.mat"),
                splice_opts_path=str(root / "feats/splice_opts"))


@pytest.fixture(scope="module")
def t_models(bundle):
    t2 = t_hp.Tacotron2Config(**TINY_T2)
    wg = t_hp.WaveGlowConfig(**WG)
    p, s = init_tacotron2(t2, torch.Generator().manual_seed(0))
    w = remove_weightnorm(init_waveglow(wg, torch.Generator().manual_seed(1)))
    return t_bench.Models(t2, p, s, wg, w, t_ppg.DependenciesPPG(**bundle))


@pytest.fixture
def jax_tiny(monkeypatch, bundle):
    """The JAX bench's model factories at the tiny sizes."""
    def models():
        t2 = j_hp.Tacotron2Config(**TINY_T2)
        p, s = j_t2.init_tacotron2(jax.random.PRNGKey(0), t2)
        wg = j_hp.WaveGlowConfig(**WG)
        w = j_wg.remove_weightnorm(j_wg.init_waveglow(
            jax.random.PRNGKey(1), wg))
        return t2, p, s, wg, w, j_ppg.DependenciesPPG(**bundle)

    monkeypatch.setattr(j_bench, "_full_size_models", models)
    monkeypatch.setattr(j_hp, "WaveGlowConfig",
                        functools.partial(j_hp.WaveGlowConfig, **WG))
    monkeypatch.setattr(j_hp, "create_hparams",
                        functools.partial(j_hp.create_hparams, **TINY_T2))


def runs(config, t_models):
    """(JAX bench call, port bench call) of one configuration, tiny."""
    t_hp_tiny = t_hp.create_hparams(**TINY_T2)
    kw = dict(device="cpu")
    return {
        "rtf": (
            lambda: j_bench.bench_waveglow_rtf(
                batch=2, seconds=0.1, warmup=1, iters=2, wn_impl="xla"),
            lambda: t_bench.bench_waveglow_rtf(
                batch=2, seconds=0.1, warmup=1, iters=2, wn_impl="xla",
                cfg=t_models.wg_cfg, **kw)),
        "e2e": (
            lambda: j_bench.bench_e2e_latency(UTT_S, 1, 2),
            lambda: t_bench.bench_e2e_latency(UTT_S, 1, 2, models=t_models,
                                              **kw)),
        "e2e_fused": (
            lambda: j_bench.bench_e2e_fused(UTT_S, 1, 2),
            lambda: t_bench.bench_e2e_fused(UTT_S, 1, 2, models=t_models,
                                            **kw)),
        "e2e_fused_batch": (
            lambda: j_bench.bench_e2e_fused_batch(3, UTT_S, 1, 2),
            lambda: t_bench.bench_e2e_fused_batch(3, UTT_S, 1, 2,
                                                  models=t_models, **kw)),
        "streaming": (
            lambda: j_bench.bench_streaming(4, UTT_S),
            lambda: t_bench.bench_streaming(4, UTT_S, models=t_models,
                                            **kw)),
        "streaming_fused": (
            lambda: j_bench.bench_streaming(4, UTT_S, fused=True, batch=2),
            lambda: t_bench.bench_streaming(4, UTT_S, fused=True, batch=2,
                                            models=t_models, **kw)),
        # the JAX bench's fixed sizes: 400 frames, 10000-sample segments
        "train_ppg2mel": (
            lambda: j_bench.bench_train_ppg2mel(1, 1, batch=2),
            lambda: t_bench.bench_train_ppg2mel(
                1, 1, batch=2, frames=400, hparams=t_hp_tiny, **kw)),
        "train_waveglow": (
            lambda: j_bench.bench_train_waveglow(1, 1, batch=2),
            lambda: t_bench.bench_train_waveglow(
                1, 1, batch=2, cfg=t_models.wg_cfg, **kw)),
    }[config]


def check_line(config, t_models):
    """The port's line against the JAX line at the same tiny size."""
    run_jax, run_port = runs(config, t_models)
    want, got = run_jax(), run_port()
    assert set(got) == set(want) - {"vs_baseline"}
    assert (got["metric"], got["unit"]) == (want["metric"], want["unit"])
    assert set(got["detail"]) == (set(want["detail"]) - {"int8_snr_note"}
                                  | {"tf32"})
    assert got["detail"]["device"] == "cpu"
    assert np.isfinite(got["value"]) and got["value"] > 0
    for k in ("batch", "iters", "utt_seconds", "frames", "segment",
              "cond_impl", "train_dtype", "steady_utts", "pipeline_depth"):
        if k in want["detail"]:
            assert got["detail"][k] == want["detail"][k], k
