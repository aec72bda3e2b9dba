"""The port's checking tools against the JAX package's, on the CPU at tiny
widths: `eval/parity.py`, `eval/duration_check.py` and
`eval/int8_snr.py`'s ladder and its CLI.

Tolerances: teacher-forced mels (f32, the same weights) within 1e-5;
duration-check frames and stops equal, with the JAX run's prenet masks
injected; ladder SNRs within 0.1 dB on the f32 rungs and 1 dB on the
bf16 rungs (the same matched noise; see the test); parity MSEs within
1e-3 relative (the two packages' PPGs agree to float rounding).
"""

import functools
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.eval import duration_check as t_dur
from fac_via_ppg_torch.eval import int8_snr as t_snr
from fac_via_ppg_torch.eval import parity as t_par
from fac_via_ppg_torch.eval import reference_oracle as t_oracle
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.models import init_tacotron2
from fac_via_ppg_torch.train import checkpoint as t_ckpt
from fac_via_ppg_tpu.configs import hparams as j_hp
from fac_via_ppg_tpu.eval import duration_check as j_dur
from fac_via_ppg_tpu.eval import int8_snr as j_snr
from fac_via_ppg_tpu.eval import parity as j_par
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models import waveglow as j_wg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from fac_via_ppg_tpu.train import checkpoint as j_ckpt
from fac_via_ppg_tpu.train.export_torch import (
    save_reference_tacotron2_checkpoint,
    save_reference_waveglow_checkpoint,
)
from tests.torch_port_helpers import TINY_T2, record_prenet_masks

WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
# max_decoder_steps 12: a config of its own, so that the JAX package's
# cached jitted decoder is traced here, with the mask recorder in place
T2 = dict(TINY_T2, max_decoder_steps=12)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("measure")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4, hidden_dim=8,
                num_layers=1)
    paths = dict(
        nnet_path=str(root / "bundle/am/final.raw.txt"),
        lda_path=str(root / "bundle/feats/final.mat"),
        reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
        splice_opts_path=str(root / "bundle/feats/splice_opts"))
    wavs = []
    rng = np.random.RandomState(3)
    for i, n in enumerate((6400, 8000)):
        t = np.arange(n) / 16000.0
        x = np.sin(2 * np.pi * (170 + 30 * i) * t) * 9000 + rng.randn(n) * 200
        wavs.append(str(root / f"u{i}.wav"))
        wavfile.write(wavs[-1], 16000, x.astype(np.int16))
    return root, paths, wavs


@pytest.fixture(scope="module")
def t2_models():
    """Tiny seeded Tacotron2, drawn by the port and handed to the JAX
    package as the same arrays; the port's copy through weights.py."""
    tp, ts = init_tacotron2(t_hp.Tacotron2Config(**T2),
                            torch.Generator().manual_seed(5))
    params, state = (jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), tree) for tree in (tp, ts))
    return (j_hp.Tacotron2Config(**T2), params, state,
            weights.tacotron2_from_jax(params, state))


# --------------------------------------------------------------- parity

def test_mel_mse_matches_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(80, 30), rng.randn(80, 27)
    assert t_par.mel_mse(a, b) == j_par.mel_mse(a, b)


def test_teacher_forced_mel_matches_jax(t2_models):
    cfg, params, state, (t_params, t_state) = t2_models
    rng = np.random.RandomState(1)
    ppg = np.abs(rng.rand(23, cfg.n_symbols)).astype(np.float32)
    mel = (rng.randn(80, 17) * 0.5).astype(np.float32)
    want = j_par.teacher_forced_mel(cfg, params, state, ppg, mel)
    got = t_par.teacher_forced_mel(t_hp.Tacotron2Config(**T2), t_params,
                                   t_state, ppg, mel)
    assert got.shape == want.shape == (80, 17)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_run_parity_matches_jax(bundle, t2_models, tmp_path, monkeypatch):
    """run_parity on one reference `.pt` both packages read, the same wavs
    and AM: the same per-utterance MSEs (1e-3 relative)."""
    root, paths, wavs = bundle
    cfg, params, state, _ = t2_models
    ckpt = str(tmp_path / "t2.pt")
    save_reference_tacotron2_checkpoint(ckpt, params, state, cfg)
    filelist = tmp_path / "wavs.txt"
    filelist.write_text("\n".join(wavs) + "\n")
    monkeypatch.setattr(
        j_ppg, "compute_mfcc",
        lambda *a, **k: j_mfcc.compute_mfcc(*a, backend="numpy", **k))
    from fac_via_ppg_torch.frontend import mfcc as t_mfcc
    monkeypatch.setattr(
        t_ppg, "compute_mfcc",
        lambda *a, **k: t_mfcc.compute_mfcc(*a, backend="numpy", **k))
    want = j_par.run_parity(ckpt, str(filelist), t2_kw=T2,
                            deps=j_ppg.DependenciesPPG(**paths))
    got = t_par.run_parity(ckpt, str(filelist), t2_kw=T2,
                           deps=t_ppg.DependenciesPPG(**paths), device="cpu")
    assert [u["wav"] for u in got["per_utterance"]] == wavs
    for g, w in zip(got["per_utterance"], want["per_utterance"]):
        assert g["mse_vs_target"] == pytest.approx(w["mse_vs_target"],
                                                   rel=1e-3)
    assert got["mean_mse_vs_target"] == pytest.approx(
        want["mean_mse_vs_target"], rel=1e-3)


def test_parity_oracle_needs_the_reference_mount(bundle, t2_models,
                                                 tmp_path, monkeypatch):
    root, paths, wavs = bundle
    cfg, params, state, _ = t2_models
    ckpt = str(tmp_path / "t2.pt")
    save_reference_tacotron2_checkpoint(ckpt, params, state, cfg)
    (tmp_path / "wavs.txt").write_text(wavs[0] + "\n")
    monkeypatch.setattr(t_oracle, "REFERENCE_SRC", str(tmp_path / "none"))
    with pytest.raises(t_oracle.ReferenceUnavailable, match="not mounted"):
        t_par.run_parity(ckpt, str(tmp_path / "wavs.txt"), True, t2_kw=T2,
                         deps=t_ppg.DependenciesPPG(**paths), device="cpu")


# ------------------------------------------------------- duration check

@pytest.mark.parametrize("gate_bias", [-30.0, 30.0])
def test_check_durations_matches_jax(bundle, t2_models, tmp_path,
                                     monkeypatch, gate_bias):
    """The JAX run (an orbax checkpoint) and the port's (the port
    trainer's checkpoint of the same weights), the JAX prenet masks of
    each utterance injected: equal frames, stops and summaries.  Gate
    bias -30 runs to the cap; +30 stops at the first step."""
    root, paths, wavs = bundle
    _, params, state, _ = t2_models
    # a config of each case's own (the jitted JAX decoder is cached per
    # config, with the mask recorder it was traced with)
    steps = {-30.0: 9, 30.0: 10}[gate_bias]
    cfg = j_hp.Tacotron2Config(**dict(T2, max_decoder_steps=steps))
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["decoder"]["gate_layer"]["bias"] = jnp.full_like(
        params["decoder"]["gate_layer"]["bias"], gate_bias)
    j_path = str(tmp_path / "ckpt_jax")
    j_ckpt.save_checkpoint(j_path, params, {}, 1e-3, 0, model_state=state)
    t_params, t_state = weights.tacotron2_from_jax(params, state)
    t_path = str(tmp_path / "checkpoint_0")
    t_ckpt.save_checkpoint(t_path, t_params, torch.optim.Adam(
        [torch.zeros(1)]), 1e-3, 0, model_state=t_state)

    masks = record_prenet_masks(monkeypatch)
    j_deps = j_ppg.DependenciesPPG(**paths)
    want_rows, per_utt = [], []
    for wav in wavs:
        n0 = len(masks)
        rows, _ = j_dur.check_durations(j_path, [wav], cfg=cfg, deps=j_deps)
        jax.effects_barrier()
        want_rows += rows
        per_utt.append(masks[n0:])
    _, want = j_dur.check_durations(j_path, wavs, cfg=cfg, deps=j_deps)
    t_cfg = t_hp.Tacotron2Config(**dict(T2, max_decoder_steps=steps))
    rows, summary = t_dur.check_durations(
        t_path, wavs, cfg=t_cfg,
        deps=t_ppg.DependenciesPPG(**paths), device="cpu", masks=per_utt)
    for g, w in zip(rows, want_rows):
        assert {k: g[k] for k in ("src_frames", "out_frames", "stop",
                                  "rel_duration_err")} == \
            {k: w[k] for k in ("src_frames", "out_frames", "stop",
                               "rel_duration_err")}
    assert [r["stop"] for r in rows] == (["CAP", "CAP"] if gate_bias < 0
                                         else ["GATE", "GATE"])
    assert {k: v for k, v in summary.items() if k != "checkpoint"} == \
        {k: v for k, v in want.items() if k != "checkpoint"}


def test_duration_check_cli(bundle, t2_models, tmp_path, monkeypatch,
                            capsys):
    """The CLI on the CPU (--cpu, --hparams, --json): one row a wav and a
    summary line."""
    root, paths, wavs = bundle
    _, _, _, (t_params, t_state) = t2_models
    ckpt = str(tmp_path / "checkpoint_0")
    t_ckpt.save_checkpoint(ckpt, t_params, torch.optim.Adam(
        [torch.zeros(1)]), 1e-3, 0, model_state=t_state)
    monkeypatch.setattr(t_hp, "create_hparams_stage",
                        functools.partial(t_hp.create_hparams_stage, **T2))
    monkeypatch.setattr(t_ppg, "DependenciesPPG",
                        functools.partial(t_ppg.DependenciesPPG, **paths))
    summary = t_dur.main([ckpt, *wavs, "--cpu", "--json",
                          str(tmp_path / "d.json")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[-1].startswith("gated ")
    assert summary["n_utts"] == 2
    assert json.loads((tmp_path / "d.json").read_text())["summary"] == \
        summary


# --------------------------------------------------------------- ladder

@pytest.fixture(scope="module")
def wg_models():
    cfg = j_hp.WaveGlowConfig(**WG)
    params = j_wg.remove_weightnorm(j_wg.init_waveglow(
        jax.random.PRNGKey(2), cfg))
    rng = np.random.RandomState(2)
    for wn in params["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.05, jnp.float32)
    mel = (rng.randn(2, 80, 12) * 0.6 - 4.0).astype(np.float32)
    return cfg, params, weights.waveglow_from_jax(params), mel


@pytest.mark.parametrize("sigma,tensorscale", [(0.0, False), (0.6, True)])
def test_run_ladder_matches_jax(wg_models, sigma, tensorscale):
    """The same rungs; the f32 rungs' SNRs (batch, worst and each
    utterance's) within 0.1 dB of the JAX package's.  The bf16 rungs'
    within 1 dB: both sit at bf16's rounding floor (~45 dB), where the
    port's documented single rounding of the cond projection after its
    f32 bias (the JAX conv rounds, then adds a bf16 bias) moves the SNR
    by up to ~0.5 dB on this tiny net."""
    cfg, params, t_params, mel = wg_models
    want = j_snr.run_ladder(cfg, params, jnp.asarray(mel), sigma, seed=4,
                            include_tensorscale=tensorscale, detailed=True)
    got = t_snr.run_ladder(t_hp.WaveGlowConfig(**WG), t_params,
                           torch.from_numpy(mel), sigma, seed=4,
                           include_tensorscale=tensorscale, detailed=True)
    assert list(got) == list(want)
    for name, w in want.items():
        tol = 1.0 if name.startswith("bf16") else 0.1
        assert got[name]["db"] == pytest.approx(w["db"], abs=tol), name
        assert got[name]["worst_utt_db"] == pytest.approx(
            w["worst_utt_db"], abs=tol), name
        np.testing.assert_allclose(got[name]["per_utt_db"], w["per_utt_db"],
                                   atol=tol)
    flat = t_snr.run_ladder(t_hp.WaveGlowConfig(**WG), t_params,
                            torch.from_numpy(mel), sigma, seed=4,
                            include_tensorscale=tensorscale)
    assert flat == {k: v["db"] for k, v in got.items()}


def test_run_ladder_wn_int8_raises(wg_models):
    """(The name is older than the rungs, which raised then.)
    include_wn_int8 adds the JAX package's WN int8 rungs, names in its
    order, each SNR (batch, worst and each utterance's) within 0.5 dB of
    its; they run on the conv formulation whatever the ladder's wn_impl
    (here flow) and say so in their detail."""
    cfg, params, t_params, mel = wg_models
    want = j_snr.run_ladder(cfg, params, jnp.asarray(mel), 0.6, seed=4,
                            include_wn_int8=True, detailed=True)
    got = t_snr.run_ladder(t_hp.WaveGlowConfig(**WG), t_params,
                           torch.from_numpy(mel), 0.6, seed=4,
                           include_wn_int8=True, detailed=True,
                           wn_impl="flow")
    assert list(got) == list(want)
    assert {"bf16_int8_wn2", "bf16_int8_wn2t", "bf16_int8_rs2"} <= set(got)
    for name, w in want.items():
        if "_wn" in name or "_rs" in name:
            assert got[name].pop("wn_impl") == "conv", name
            assert got[name]["db"] == pytest.approx(w["db"], abs=0.5), name
            assert got[name]["worst_utt_db"] == pytest.approx(
                w["worst_utt_db"], abs=0.5), name
            np.testing.assert_allclose(got[name]["per_utt_db"],
                                       w["per_utt_db"], atol=0.5)


def test_int8_snr_cli(wg_models, tmp_path, capsys):
    """The ladder CLI on a reference `.pt` and two wavs (--cpu): one JSON
    line with the JAX CLI's keys, every rung's per-utterance SNRs."""
    cfg, params, _, _ = wg_models
    pt = str(tmp_path / "wg.pt")
    save_reference_waveglow_checkpoint(pt, params, cfg)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"waveglow_config": {
        "n_mel_channels": 80, "hop_length": 160, "n_flows": 2, "n_group": 8,
        "n_early_every": 4, "n_early_size": 2,
        "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3}}}))
    wavs = []
    for i, n in enumerate((4000, 4800)):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        t = np.arange(n) / 16000.0
        wavfile.write(wavs[-1], 16000, (np.sin(2 * np.pi * 200 * t)
                                        * 8000).astype(np.int16))
    out = t_snr.main(["--waveglow_model", pt, "--config", str(config),
                      "--wav", *wavs, "--wn_impl", "xla", "--cpu"])
    line = json.loads(capsys.readouterr().out)
    assert set(line) == {"snr_db_vs_f32_dense", "mel_shape", "device"}
    assert line["mel_shape"] == [2, 80, 26] and line == json.loads(
        json.dumps(out))
    assert set(line["snr_db_vs_f32_dense"]) == {"bf16_dense", "bf16_int8",
                                                "f32_int8"}
    for rung in line["snr_db_vs_f32_dense"].values():
        assert len(rung["per_utt_db"]) == 2
