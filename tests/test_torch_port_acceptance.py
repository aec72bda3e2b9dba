"""The port's acceptance tools (eval/trained_parity.py, eval/runbook.py)
and the denoiser's `normal` mode against the JAX package, on the CPU at
tiny widths (Tacotron2 tests/torch_port_helpers.TINY_T2 with 13 decoder
steps, WaveGlow 2 flows x 2 layers x 16 channels, a substitute AM of 16
senones).  Nothing here reads the reference's sources: the stages that
need them are held to raising ReferenceUnavailable.

Tolerances: the bias template and the serve path's mel and audio within
1e-5 (f32, the same weights, another summation order); the spectral
distance within 1e-9 relative (the same numpy arithmetic); the matched
noise bit for bit (the same generator); the AM stage's per-utterance
frames equal and sums within 1e-5 of JAX's (the two MFCCs agree to float
rounding on the numpy backend).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import bench as t_bench
from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.eval import reference_oracle as t_oracle
from fac_via_ppg_torch.eval import runbook as t_rb
from fac_via_ppg_torch.eval import trained_parity as t_tp
from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.models import denoiser as t_den
from fac_via_ppg_torch.models import tacotron2 as t_t2
from fac_via_ppg_torch.train.checkpoint import save_checkpoint
from fac_via_ppg_torch.train.optim import make_optimizer
from fac_via_ppg_tpu.configs import hparams as j_hp
from fac_via_ppg_tpu.eval import runbook as j_rb
from fac_via_ppg_tpu.eval import trained_parity as j_tp
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models import denoiser as j_den
from fac_via_ppg_tpu.models import tacotron2 as j_t2
from fac_via_ppg_tpu.models import waveglow as j_wg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from tests.torch_port_helpers import TINY_T2

WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
# 13 steps and the gate held off: a config of its own, so that the JAX
# package's jitted decode is traced here with its dropout patched out
T2 = dict(TINY_T2, max_decoder_steps=13, gate_threshold=1.01)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wg():
    """(JAX config, JAX serving params, the port's): nonzero end convs."""
    cfg = j_hp.WaveGlowConfig(**WG)
    train = j_wg.init_waveglow(jax.random.PRNGKey(6), cfg)
    rng = np.random.RandomState(6)
    for wn in train["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.05, jnp.float32)
    params = j_wg.remove_weightnorm(train)
    return cfg, params, weights.waveglow_from_jax(params)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A substitute AM in the reference's am/ + feats/ layout and two
    seeded wavs."""
    root = tmp_path_factory.mktemp("acceptance")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    wavs = []
    rng = np.random.RandomState(8)
    for i, n in enumerate((6400, 7200)):
        t = np.arange(n) / 16000.0
        x = np.sin(2 * np.pi * (190 + 40 * i) * t) * 9000 + rng.randn(n) * 150
        wavs.append(str(root / f"u{i}.wav"))
        wavfile.write(wavs[-1], 16000, x.astype(np.int16))
    return root, str(root / "bundle"), wavs


@pytest.fixture
def numpy_mfcc(monkeypatch):
    """Both packages' host MFCC on their numpy backends."""
    monkeypatch.setattr(
        j_ppg, "compute_mfcc",
        lambda *a, **k: j_mfcc.compute_mfcc(*a, backend="numpy", **k))
    monkeypatch.setattr(
        t_ppg, "compute_mfcc",
        lambda *a, **k: t_mfcc.compute_mfcc(*a, backend="numpy", **k))


# ---------------------------------------------------------------- denoiser

def test_denoiser_normal_mode_matches_jax(wg, monkeypatch):
    """Denoiser(mode="normal") on the JAX package's drawn mel (its
    PRNGKey(0) split, injected through the port's draw helper): the same
    bias template and denoised audio."""
    cfg, params, t_params = wg
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    mel = np.asarray(jax.random.normal(sub, (1, 80, 88), jnp.float32))
    seen = {}

    def drawn(cfg_, mode, generator):
        seen["mode"] = mode
        return torch.from_numpy(mel.copy())

    monkeypatch.setattr(t_den, "bias_mel", drawn)
    den_j = j_den.Denoiser(cfg, params, mode="normal")
    den_t = t_den.Denoiser(t_hp.WaveGlowConfig(**WG), t_params,
                           mode="normal")
    assert seen["mode"] == "normal"
    np.testing.assert_allclose(den_t.bias_spec.numpy(),
                               np.asarray(den_j.bias_spec), atol=1e-5)
    audio = np.random.RandomState(3).randn(2, 4000).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        den_t(torch.from_numpy(audio), strength=0.1).numpy(),
        np.asarray(den_j(jnp.asarray(audio), strength=0.1)), atol=1e-5)


def test_denoiser_normal_mode_draws_from_its_generator(wg):
    """The bias mel is an f32 CPU draw from the generator (seeded 0 by
    default): equal generators, equal templates; another seed, another
    template; the zeros template differs from both."""
    _, _, t_params = wg
    cfg = t_hp.WaveGlowConfig(**WG)
    mel = t_den.bias_mel(cfg, "normal", torch.Generator().manual_seed(0))
    assert mel.dtype == torch.float32 and mel.device.type == "cpu"
    assert mel.shape == (1, 80, 88)
    assert torch.equal(mel, torch.randn(
        (1, 80, 88), generator=torch.Generator().manual_seed(0)))
    spec = {name: t_den.Denoiser(cfg, t_params, mode=mode, generator=g
                                 ).bias_spec
            for name, mode, g in (
                ("default", "normal", None),
                ("seed0", "normal", torch.Generator().manual_seed(0)),
                ("seed1", "normal", torch.Generator().manual_seed(1)),
                ("zeros", "zeros", None))}
    assert torch.equal(spec["default"], spec["seed0"])
    assert not torch.equal(spec["seed0"], spec["seed1"])
    assert not torch.equal(spec["seed0"], spec["zeros"])


def test_denoiser_unknown_mode_raises_the_jax_error(wg):
    cfg, params, t_params = wg
    msg = "unsupported denoiser mode 'uniform'; choose 'zeros' or 'normal'"
    with pytest.raises(ValueError, match=msg):
        j_den.Denoiser(cfg, params, mode="uniform")
    with pytest.raises(ValueError, match=msg):
        t_den.Denoiser(t_hp.WaveGlowConfig(**WG), t_params, mode="uniform")


# ---------------------------------------------------------- trained_parity

def test_log_spectral_distance_matches_jax():
    rng = np.random.RandomState(2)
    a = rng.randn(5000)
    b = a + rng.randn(5000) * 0.05
    want = j_tp._log_spectral_distance(a, np.concatenate([b, b[:300]]))
    got = t_tp._log_spectral_distance(a, np.concatenate([b, b[:300]]))
    assert got == pytest.approx(want, rel=1e-9)
    assert t_tp._log_spectral_distance(a, a) == 0.0


@pytest.mark.parametrize("frames,seed", [(12, 16807), (7, 16808)])
def test_matched_noise_is_the_reference_draw(wg, frames, seed):
    """The JAX package's draw (torch.manual_seed, then FloatTensor.normal_
    in WaveGlow.infer's order), bit for bit, without touching the global
    generator."""
    cfg = j_hp.WaveGlowConfig(**WG)
    want = j_tp._matched_noise(torch, cfg, frames, seed)
    torch.manual_seed(99)
    state = torch.get_rng_state()
    got = t_tp._matched_noise(t_hp.WaveGlowConfig(**WG), frames, seed)
    assert torch.equal(torch.get_rng_state(), state)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dropout_free_prenets_are_the_plain_prenet():
    """Through the keep-mask hook, with every unit kept, the halved
    prenet is relu(linear(...)) layer by layer, bit for bit."""
    cfg = t_hp.Tacotron2Config(**T2)
    params, _ = t_t2.init_tacotron2(cfg, torch.Generator().manual_seed(3))
    free, masks = t_tp.dropout_free_prenets(params)
    x = torch.randn((2, 9, cfg.n_symbols),
                    generator=torch.Generator().manual_seed(4)).abs()
    got = t_t2.prenet_apply(free["encoder"]["prenet"], x, masks=masks)
    want = x
    for layer in params["encoder"]["prenet"]["layers"]:
        want = torch.relu(t_t2.linear(layer, want))
    assert torch.equal(got, want)
    assert next(masks, None) is None
    assert free["decoder"]["prenet"]["layers"][0]["weight"].equal(
        params["decoder"]["prenet"]["layers"][0]["weight"] * 0.5)


def test_framework_serve_matches_jax(wg):
    """framework_serve on the same weights, PPG and reference-order noise
    as the JAX package's (its dropout patched out, the port's through the
    mask hook): the same stop step, mel and audio within 1e-5."""
    cfg, params, t_params = wg
    j_cfg = j_hp.Tacotron2Config(**T2)
    p, s = j_t2.init_tacotron2(jax.random.PRNGKey(11), j_cfg)
    t_p, t_s = weights.tacotron2_from_jax(p, s)
    ppg = np.abs(np.random.RandomState(12).rand(
        1, j_cfg.n_symbols, 15)).astype(np.float32)
    wg_cfg = t_hp.WaveGlowConfig(**WG)
    want = j_tp.framework_serve(
        j_cfg, p, s, cfg, params, j_den.Denoiser(cfg, params), ppg, 0.6,
        0.005, noise=lambda f: j_tp._matched_noise(torch, cfg, f, 16807))
    got = t_tp.framework_serve(
        t_hp.Tacotron2Config(**T2), t_p, t_s, wg_cfg, t_params,
        t_den.Denoiser(wg_cfg, t_params), ppg, 0.6, 0.005,
        noise=lambda f: t_tp._matched_noise(wg_cfg, f, 16807))
    assert got[2] == want[2] == 13
    assert got[0].shape == np.asarray(want[0]).shape
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-5)


def test_run_trained_parity_needs_the_reference(monkeypatch, tmp_path):
    """Without the reference's sources: ReferenceUnavailable before any
    work (the checkpoints named here do not exist, so a load would raise
    another error), and no framework-only report."""
    monkeypatch.setattr(t_oracle, "REFERENCE_SRC", "")
    with pytest.raises(t_oracle.ReferenceUnavailable,
                       match="not mounted"):
        t_tp.run_trained_parity(str(tmp_path / "t2.pt"),
                                str(tmp_path / "wg.pt"), [], device="cpu")


# ----------------------------------------------------------------- runbook

@pytest.mark.parametrize("layout", ["reference", "flat"])
def test_find_am_paths_matches_jax(bundle, tmp_path, layout):
    _, am_dir, _ = bundle
    if layout == "flat":
        flat = tmp_path / "flat"
        flat.mkdir()
        for sub, name in (("am", "final.raw.txt"), ("feats", "final.mat"),
                          ("feats", "reduce_dim.mat"),
                          ("feats", "splice_opts")):
            shutil.copy(os.path.join(am_dir, sub, name), flat / name)
        am_dir = str(flat)
    got = t_rb.find_am_paths(am_dir)
    assert got == j_rb.find_am_paths(am_dir)
    if layout == "flat":
        assert all(os.path.dirname(p) == am_dir for p in got.values())
    with pytest.raises(FileNotFoundError, match="none of"):
        t_rb.find_am_paths(str(tmp_path / "nowhere"))


def test_run_am_stage_matches_jax(bundle, numpy_mfcc):
    """The PPG invariants on the substitute AM: the same senones,
    monophones, frames per utterance, and sums within 1e-5 of JAX's."""
    _, am_dir, wavs = bundle
    paths = t_rb.find_am_paths(am_dir)
    want = j_rb.run_am_stage(j_ppg.DependenciesPPG(**paths), wavs)
    got = t_rb.run_am_stage(t_ppg.DependenciesPPG(**paths), wavs,
                            device="cpu")
    assert got["invariants_ok"] and want["invariants_ok"]
    assert (got["n_senones"], got["n_monophones"]) == (16, 4) == (
        want["n_senones"], want["n_monophones"])
    for g, w in zip(got["per_utterance"], want["per_utterance"]):
        assert g["wav"] == w["wav"] and g["frames"] == w["frames"] > 0
        for k in ("max_row_sum_err", "max_mono_sum_err"):
            assert g[k] == pytest.approx(w[k], abs=1e-5)


def test_runbook_parity_skips_trainer_checkpoints(bundle, tmp_path,
                                                  numpy_mfcc):
    """A PPG-trainer checkpoint takes the parity stage's documented skip
    (JAX runbook.py:124-147); a reference .pt goes to the oracle, which
    raises ReferenceUnavailable here (no fallback)."""
    _, am_dir, wavs = bundle
    cfg = t_hp.Tacotron2Config(**T2)
    params, state = t_t2.init_tacotron2(cfg, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint_0")
    save_checkpoint(ckpt, params, make_optimizer(1e-3).init(params), 1e-3, 0,
                    model_state=state)
    report = t_rb.run_runbook(am_dir, wavs, ppg2mel_model=ckpt,
                              waveglow_model=str(tmp_path / "waveglow_0"),
                              stages=("am", "parity"), t2_kw=T2,
                              device="cpu")
    assert report["am"]["invariants_ok"]
    assert "skipped" in report["parity"]
    assert report["stages"] == ["am", "parity"]
    with pytest.raises(ValueError, match="need --ppg2mel_model"):
        t_rb.run_runbook(am_dir, wavs, stages=("serve",), device="cpu")


def test_runbook_bench_configs_map_to_the_port_bench():
    """The five BASELINE configurations by the port bench's names: the
    JAX runbook's "waveglow" (which its own bench rejects) is "rtf"."""
    assert j_rb.BENCH_CONFIGS == ("e2e", "waveglow", "train_ppg2mel",
                                  "train_waveglow", "streaming_fused")
    mapping = dict(zip(j_rb.BENCH_CONFIGS, t_rb.BENCH_CONFIGS))
    assert mapping == {"e2e": "e2e", "waveglow": "rtf",
                       "train_ppg2mel": "train_ppg2mel",
                       "train_waveglow": "train_waveglow",
                       "streaming_fused": "streaming_fused"}
    assert set(t_rb.BENCH_CONFIGS) <= set(t_bench.CONFIGS)


def test_runbook_main_exits_nonzero_on_a_failed_bench_config(
        bundle, tmp_path, monkeypatch, capsys):
    """A configuration the bench refuses is recorded as JAX records it
    ({"error": ...}, from a real `python -m fac_via_ppg_torch.bench`
    process), the report is still printed, and main exits nonzero."""
    _, am_dir, wavs = bundle
    real = t_rb.run_bench_stage
    monkeypatch.setattr(t_rb, "run_bench_stage",
                        lambda extra_args=(): real(("no_such_config",)))
    out = tmp_path / "report.json"
    with pytest.raises(SystemExit) as e:
        t_rb.main(["--am_dir", am_dir, "--wavs", *wavs, "--stages", "bench",
                   "--output", str(out)])
    assert e.value.code not in (0, None)
    assert "no_such_config" in str(e.value.code)
    report = json.loads(out.read_text())
    assert "invalid choice" in report["bench"]["no_such_config"]["error"]
    assert t_rb.failed_configs(report) == ["no_such_config"]
    assert capsys.readouterr().out.lstrip().startswith("{")
