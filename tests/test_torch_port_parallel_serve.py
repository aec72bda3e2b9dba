"""The port's multi-process serving on the CPU (gloo ranks, spawned, torch
only): `FusedSynthesizer(data_parallel=True)` on 2 and 4 ranks and data x
model parallel (2 x 2), each against the port's one-process run of the
same padded batch and seed (masks and noise drawn: PCM within 1 int16
step, lengths exact) and, with the prenet kept whole and sigma 0, against
the JAX package's data-parallel (8 data) and DP x TP (4 x 2) runs on its
8-device CPU mesh, within the 2 steps that tests/test_torch_port_fused.py
holds the one-process port to.  The vocoder CLI's --data_parallel (its
wavs byte for byte the one-process CLI's) and --model_parallel 2 (the
conv formulation, within 1 step), int8 cond under TP above 25 dB against
dense TP, and the refusals of the hand kernels under TP.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWGConfig
from fac_via_ppg_torch.models import waveglow as tw
from fac_via_ppg_torch.parallel.mesh import Mesh
from fac_via_ppg_torch.scripts import waveglow_inference as t_cli
from fac_via_ppg_torch.train.export_torch import export_waveglow_state_dict
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_tpu.eval.fused import FusedSynthesizer as JFused
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models import tacotron2 as j_t2
from fac_via_ppg_tpu.models.tacotron2 import init_tacotron2
from fac_via_ppg_tpu.models.waveglow import init_waveglow, remove_weightnorm
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from tests.torch_port_helpers import (
    TINY_T2,
    fused_synth,
    rank_serve,
    rank_vocoder_cli,
    run_ranks,
    serve_both_ways,
)

MAX_FRAMES = 8
PAD_TO = 4  # 3 requests padded to the data axis of 2 and of 4
WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Tiny weights (a gate that never fires, nonzero end convs), three
    featurized requests, as tests/test_torch_port_fused.py's."""
    root = tmp_path_factory.mktemp("serve")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    deps = dict(nnet_path=str(root / "bundle/am/final.raw.txt"),
                lda_path=str(root / "bundle/feats/final.mat"),
                reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
                splice_opts_path=str(root / "bundle/feats/splice_opts"))
    t2_cfg = Tacotron2Config(**TINY_T2)
    t2_params, t2_state = jax.jit(init_tacotron2, static_argnums=1)(
        jax.random.PRNGKey(0), t2_cfg)
    t2_params["decoder"]["gate_layer"]["bias"] = jnp.full((1,), -30.0)
    wg_params = remove_weightnorm(jax.jit(init_waveglow, static_argnums=1)(
        jax.random.PRNGKey(1), WaveGlowConfig(**WG)))
    rng = np.random.RandomState(2)
    for wn in wg_params["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*np.shape(wn["end"]["weight"])) * 0.05, jnp.float32)
    wavs = []
    for i, n in enumerate((9600, 6400, 8000)):
        t = np.arange(n) / 16000.0
        x = np.sin(2 * np.pi * (150 + 40 * i) * t) * 9000
        x += rng.randn(n) * 300
        path = str(root / f"u{i}.wav")
        wavfile.write(path, 16000, x.astype(np.int16))
        wavs.append(path)
    tp, ts = weights.tacotron2_from_jax(t2_params, t2_state)
    out = dict(t2_cfg=dict(TINY_T2), wg_cfg=dict(WG), t2_params=tp,
               t2_state=ts, wg_params=weights.waveglow_from_jax(wg_params),
               deps=deps, max_frames=MAX_FRAMES, pad_to=PAD_TO)
    synth = fused_synth(out, sigma=0.0)
    out["pairs"] = [synth.featurize(p, dither=0.0) for p in wavs]
    out["jax"] = (t2_cfg, t2_params, t2_state, wg_params)
    return out


def _rank_setup(setup):
    return {k: v for k, v in setup.items() if k != "jax"}


@pytest.fixture(scope="module")
def one_process(setup):
    return serve_both_ways(setup, None, PAD_TO)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX package's data-parallel (8 data) and DP x TP (4 data x 2
    model) serving, dropout off and sigma 0 (tests/test_fused.py's)."""
    t2_cfg, t2_params, t2_state, wg_params = setup["jax"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_t2, "dropout", lambda key, x, rate, enabled: x)
        for model in (1, 2):
            jf = JFused(t2_cfg, t2_params, t2_state, WaveGlowConfig(**WG),
                        wg_params, deps=j_ppg.DependenciesPPG(
                            **setup["deps"]),
                        sigma=0.0, serving_dtype=None,
                        max_frames=MAX_FRAMES, data_parallel=True,
                        model_parallel=model)
            out[model] = jf.synthesize_feature_pairs(
                setup["pairs"], jax.random.PRNGKey(5))
    return out


@pytest.fixture(scope="module")
def ranks2(setup, tmp_path_factory):
    return run_ranks(2, tmp_path_factory.mktemp("r2"), rank_serve,
                     _rank_setup(setup))


@pytest.fixture(scope="module")
def ranks4(setup, tmp_path_factory):
    return run_ranks(4, tmp_path_factory.mktemp("r4"), rank_serve,
                     _rank_setup(setup))


def _close(got, want, atol):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and len(g) == len(w)
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= atol
        assert np.abs(w.astype(np.int32)).max() > 100  # not silence


LAYOUTS = [(2, 1), (4, 1), (4, 2)]  # (ranks, model)


def _ranks(ranks2, ranks4, world):
    return ranks2 if world == 2 else ranks4


@pytest.mark.parametrize("world,model", LAYOUTS)
def test_fused_parallel_equals_one_process(ranks2, ranks4, one_process,
                                           world, model):
    """The same seed, masks and noise drawn for the padded global batch:
    each rank's rows equal the one-process run's rows."""
    for r in _ranks(ranks2, ranks4, world):
        _close(r[model][0], one_process[0], atol=1)


@pytest.mark.parametrize("world,model", LAYOUTS)
def test_fused_parallel_matches_jax(ranks2, ranks4, jax_runs, world,
                                    model):
    """Prenet kept whole, sigma 0: the JAX package's DP / DP x TP run."""
    for r in _ranks(ranks2, ranks4, world):
        _close(r[model][1], jax_runs[model], atol=2)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_returns_every_row(ranks2, ranks4, world):
    res = _ranks(ranks2, ranks4, world)
    for r in res[1:]:
        for model in r:
            for way in (0, 1):
                for g, w in zip(r[model][way], res[0][model][way]):
                    np.testing.assert_array_equal(g, w)


def test_one_process_mesh_is_the_plain_synthesizer(setup, one_process):
    """data_parallel=True in a job of one process (no group): the plain
    program, the same PCM."""
    synth = fused_synth(setup, 1, sigma=0.6)
    assert synth.mesh.shape == {"data": 1, "model": 1} and not synth._dp
    got = synth.synthesize_feature_pairs(
        setup["pairs"], torch.Generator().manual_seed(5),
        pad_batch_to=PAD_TO)
    for g, w in zip(got, one_process[0]):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------- the vocoder CLI

CLI_CFG = {"n_mel_channels": 80, "hop_length": 160, "n_flows": 2,
           "n_group": 8, "n_early_every": 4, "n_early_size": 2,
           "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3}}


@pytest.fixture(scope="module")
def cli_inputs(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = TWGConfig.from_dict(CLI_CFG)
    ckpt = str(root / "waveglow.pt")
    torch.save(export_waveglow_state_dict(setup["wg_params"], cfg), ckpt)
    config = str(root / "config.json")
    with open(config, "w") as f:
        json.dump({"waveglow_config": CLI_CFG}, f)
    rng = np.random.RandomState(7)
    files = []
    for i in range(5):
        p = str(root / f"m{i}.npy")
        np.save(p, (rng.randn(80, 24) * 0.5 - 5.0).astype(np.float32))
        files.append(p)
    filelist = str(root / "mels.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(files) + "\n")

    def run(out, **kw):
        return dict(mel_files=filelist, waveglow_path=ckpt,
                    output_dir=str(root / out), sigma=0.6,
                    denoiser_strength=0.005, batch_size=8,
                    config_path=config, **kw)

    return root, run


def _wavs(out_dir):
    names = sorted(os.listdir(out_dir))
    assert len(names) == 5
    return [wavfile.read(os.path.join(out_dir, n))[1].astype(np.int32)
            for n in names]


@pytest.fixture(scope="module")
def cli_runs(cli_inputs, tmp_path_factory):
    root, run = cli_inputs
    t_cli.main(device="cpu", **run("one_flow"))
    t_cli.main(device="cpu", **run("one_conv", wn_impl="conv"))
    run_ranks(4, tmp_path_factory.mktemp("cli_ranks"), rank_vocoder_cli, [
        run("dp_flow", data_parallel=True),
        run("dp_tp", data_parallel=True, model_parallel=2, wn_impl="xla"),
        run("dp_tp_int8", data_parallel=True, model_parallel=2,
            wn_impl="conv", cond_impl="int8")])
    return root


def test_vocoder_cli_data_parallel_writes_the_same_bytes(cli_runs):
    """4 data ranks, the flow kernel's plain version: every wav's bytes
    equal the one-process CLI's (the noise drawn for the whole batch)."""
    for name in sorted(os.listdir(cli_runs / "one_flow")):
        with open(cli_runs / "one_flow" / name, "rb") as a, \
                open(cli_runs / "dp_flow" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_vocoder_cli_model_parallel_matches_one_process(cli_runs):
    """2 data x 2 model on the conv formulation: within 1 int16 step of
    the one-process conv run (the all-reduced sums in another order)."""
    for a, b in zip(_wavs(cli_runs / "one_conv"), _wavs(cli_runs / "dp_tp")):
        assert np.abs(a - b).max() <= 1
        assert np.abs(a).max() > 100


def test_vocoder_cli_int8_tp_close_to_dense_tp(cli_runs):
    for b, c in zip(_wavs(cli_runs / "dp_tp"),
                    _wavs(cli_runs / "dp_tp_int8")):
        snr = 10 * np.log10(max(np.sum(b.astype(np.float64) ** 2), 1e-30)
                            / max(np.sum((c - b).astype(np.float64) ** 2),
                                  1e-30))
        assert snr > 25.0, snr


def test_vocoder_cli_one_process_mesh(cli_inputs, capsys):
    """--data_parallel in one process: a 1 data x 1 model mesh, the same
    wavs."""
    root, run = cli_inputs
    t_cli.main(device="cpu", **run("one_dp", data_parallel=True))
    assert "vocoder mesh: 1 data x 1 model" in capsys.readouterr().out
    for a, b in zip(_wavs(root / "one_dp"), _wavs(root / "one_flow")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wn_impl", ["flow", "layer", "pallas"])
def test_model_parallel_refuses_the_hand_kernels(cli_inputs, wn_impl):
    _, run = cli_inputs
    with pytest.raises(SystemExit, match="--wn_impl conv"):
        t_cli.main(device="cpu", **run("refused", model_parallel=2,
                                       wn_impl=wn_impl))
    cfg = TWGConfig(**WG)
    mesh = Mesh(1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="conv formulation"):
        tw.waveglow_infer(cfg, {}, torch.zeros(1, 80, 4), 0.6,
                          wn_impl=tw.resolve_wn_impl(wn_impl), mesh=mesh)


@pytest.mark.parametrize("kw,match", [
    (dict(fused=False, data_parallel=True), "need fused=True"),
    (dict(fused=False, model_parallel=2), "need fused=True"),
    (dict(fused=True, data_parallel=True, frontend_threads=2),
     "frontend_threads=1")])
def test_streaming_parallel_options_are_checked(kw, match):
    """The streaming converter's --data_parallel / --model_parallel are
    the fused route's, and data parallelism takes one front-end thread
    (every rank must form the same micro-batches)."""
    from fac_via_ppg_torch.eval.streaming import StreamingAccentConverter

    with pytest.raises(ValueError, match=match):
        StreamingAccentConverter(None, None, None, None, None, device="cpu",
                                 **kw)
