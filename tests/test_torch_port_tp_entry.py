"""The port's tensor-parallel pieces around the train step, on the CPU
(gloo ranks, spawned once, torch only in the ranks).

The three autograd collectives (parallel/tp.py) against one process's
autograd of the unsharded op; both trainers' main() at
tensor_parallel_devices=2 on 2 ranks (the loss lines on rank 0 alone,
the same whole params on every rank); the WN int8 rungs under TP (within
0.5 dB of the one-process rung's SNR), the vocoder CLI's --model_parallel
2 --wn_impl conv --wn_int8_flows and the bench's rung flags under the
mesh; the graft entry (`graft_entry.entry` against JAX's `entry` at the
same weights; `dryrun_multichip(4, device="cpu")`'s tagged lines).
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from fac_via_ppg_torch import graft_entry
from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWGConfig
from fac_via_ppg_torch.models import waveglow as tw
from fac_via_ppg_torch.parallel import tp as ptp
from fac_via_ppg_torch.scripts import waveglow_inference as t_cli
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle
from fac_via_ppg_torch.train import checkpoint as ckpt
from fac_via_ppg_torch.train.export_torch import export_waveglow_state_dict
from fac_via_ppg_torch.utils.tree import tree_leaves
from fac_via_ppg_torch.weights import tacotron2_from_jax
from tests.torch_port_helpers import (
    LSTM_SPLITS,
    TINY_T2,
    _lstm_case,
    lstm_cell_grads,
    rank_tp_tools,
    record_prenet_masks,
    run_ranks,
    tp_collectives_one_process,
    tp_rungs,
)

WG = dict(n_mel_channels=16, hop_length=64, n_flows=4, n_group=8,
          n_early_every=2, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=256)
CLI_CFG = {"n_mel_channels": 80, "hop_length": 160, "n_flows": 2,
           "n_group": 8, "n_early_every": 4, "n_early_size": 2,
           "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """A seeded tiny WaveGlow in the train form (nonzero end convs) and a
    mel batch, for the rungs."""
    cfg = TWGConfig(**WG)
    params = tw.init_waveglow(cfg, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(9)
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.05
    rng = np.random.RandomState(9)
    return dict(wg_cfg=dict(WG), wg_params=tw.weight_norm_params(params),
                rung_mel=(rng.randn(2, 16, 6) * 0.5 - 3).astype(np.float32))


def _wavs(root, n, base):
    paths = []
    for i in range(n):
        t = np.arange(base + 160 * i) / 16000.0
        p = str(root / f"w{i}.wav")
        wavfile.write(p, 16000, (np.sin(2 * np.pi * (180 + 15 * i) * t)
                                 * 9000).astype(np.int16))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def trainer_inputs(tmp_path_factory):
    """Both trainers' tiny runs (the data-parallel trainer test's), at
    tensor_parallel_devices=2 on 2 ranks."""
    root = tmp_path_factory.mktemp("tp_trainers")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    deps = dict(nnet_path=str(root / "bundle/am/final.raw.txt"),
                lda_path=str(root / "bundle/feats/final.mat"),
                reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
                splice_opts_path=str(root / "bundle/feats/splice_opts"))
    wavs = _wavs(root, 3, 4800)
    (root / "train.txt").write_text("\n".join(wavs[:2]) + "\n")
    (root / "val.txt").write_text(wavs[2] + "\n")
    run = dict(training_files=str(root / "train.txt"),
               validation_files=str(root / "val.txt"),
               output_directory=str(root / "t2run"), batch_size=1, seed=1,
               length_bucket_size=32, learning_rate=1e-3,
               **{**TINY_T2, "max_decoder_steps": 16})
    with open(DEFAULT_WAVEGLOW_CONFIG_PATH) as f:
        config = json.load(f)
    config["train_config"].update(output_directory=str(root / "wgrun"),
                                  batch_size=1, seed=1, learning_rate=1e-3)
    config["data_config"].update(training_files=str(root / "train.txt"),
                                 segment_length=2048, filter_length=256,
                                 hop_length=64, win_length=256,
                                 n_mel_channels=16)
    config["waveglow_config"] = {
        "n_mel_channels": 16, "hop_length": 64, "n_flows": 2, "n_group": 8,
        "n_early_every": 4, "n_early_size": 2,
        "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3}}
    cfg_path = str(root / "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    return root, (run, deps, cfg_path)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A tiny vocoder checkpoint (nonzero end convs), 3 mels, and the
    vocoder CLI's keyword arguments for a run writing to `out`."""
    root = tmp_path_factory.mktemp("tp_cli")
    cfg = TWGConfig.from_dict(CLI_CFG)
    params = tw.init_waveglow(cfg, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.05
    ckpt_path = str(root / "waveglow.pt")
    torch.save(export_waveglow_state_dict(params, cfg), ckpt_path)
    config = str(root / "config.json")
    with open(config, "w") as f:
        json.dump({"waveglow_config": CLI_CFG}, f)
    rng = np.random.RandomState(7)
    files = []
    for i in range(3):
        p = str(root / f"m{i}.npy")
        np.save(p, (rng.randn(80, 24) * 0.5 - 5.0).astype(np.float32))
        files.append(p)
    (root / "mels.txt").write_text("\n".join(files) + "\n")

    def run(out, **kw):
        return dict(mel_files=str(root / "mels.txt"),
                    waveglow_path=ckpt_path, output_dir=str(root / out),
                    sigma=0.6, denoiser_strength=0.0, batch_size=4,
                    config_path=config, wn_impl="conv", **kw)

    return root, run


RUNGS = dict(wn_int8_flows=2)


@pytest.fixture(scope="module")
def two(setup, trainer_inputs, cli_inputs, tmp_path_factory):
    """One spawn of 2 ranks, a (1 data x 2 model) mesh (rank_tp_tools)."""
    _, args = trainer_inputs
    _, run = cli_inputs
    return run_ranks(2, tmp_path_factory.mktemp("tp_two"), rank_tp_tools,
                     setup, args, [run("tp", model_parallel=2, **RUNGS)])


# ------------------------------------------------- the autograd collectives

@pytest.mark.parametrize("op", ["copy", "reduce", "gather"])
def test_autograd_collective_matches_one_process(two, op):
    """Each rank's part of the op, through the collective, gives the
    whole op's output, and the gradient of the rank's input is its part
    of the whole op's (copy: the whole input's gradient; reduce: the
    rank's columns of the weight's; gather: the rank's columns)."""
    want_y, want_g = tp_collectives_one_process()[op]
    for rank, r in enumerate(two):
        y, g = r["collectives"][op]
        cols = slice(rank * want_g.shape[1] // 2,
                     (rank + 1) * want_g.shape[1] // 2)
        if op == "copy":
            np.testing.assert_allclose(y, want_y[:, rank * 3:rank * 3 + 3],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g, want_g, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(g, want_g[:, cols], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("case", ["both", "ih", "hh"])
def test_split_lstm_cell_matches_one_process(two, case):
    """ops/layers.py's lstm_cell with both gate stacks split (one gather a
    step) or one of them (the other whole), with and without the input
    projection up front, against the whole cell: (h', c') and every
    gradient, a split stack's this rank's rows."""
    p, x, h, c, up = _lstm_case()
    for rank, r in enumerate(two):
        for proj in (False, True):
            want = lstm_cell_grads(p, x, h, c, up, proj)
            got = r["lstm"][(case, proj)]
            for i, (g, w) in enumerate(zip(got, want)):
                name = (["h", "c", "x", "h_in"] + list(
                    ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))[i]
                if name in LSTM_SPLITS[case]:
                    n = w.shape[0] // 2
                    w = w[rank * n:(rank + 1) * n]
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{case} {proj} {name}")


def test_autograd_collectives_are_the_identity_without_a_group():
    x = torch.randn(3, 4, requires_grad=True)
    for y in (ptp.copy_to_model(x, None), ptp.reduce_from_model(x, None),
              ptp.gather_from_model(x, None, 1)):
        assert y is x


# -------------------------------------------------------- the trainers

@pytest.mark.parametrize("name,pattern,prefix", [
    ("ppg2mel", "Train loss", "checkpoint_"),
    ("waveglow", "s/it)", "waveglow_")])
def test_trainers_tensor_parallel_on_two_ranks(trainer_inputs, two, name,
                                               pattern, prefix):
    """tensor_parallel_devices=2 on 2 ranks (1 data x 2 model): 2 items,
    both ranks' rows, 2 iterations an epoch, 2 epochs; rank 0 alone
    prints, validates and writes; both ranks return the same whole
    params, finite, and the checkpoints hold them whole."""
    root, _ = trainer_inputs
    (out0, it0, p0), (out1, it1, p1) = (r["trainers"][name] for r in two)
    assert it0 == it1 == 4
    assert len([ln for ln in out0.splitlines() if pattern in ln]) == 4, out0
    assert not [ln for ln in out1.splitlines() if pattern in ln]
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
        assert np.all(np.isfinite(a))
    run_dir = root / ("t2run" if name == "ppg2mel" else "wgrun")
    assert sorted(n for n in os.listdir(run_dir) if n.startswith(prefix)) \
        == [prefix + "0", prefix + "2"]
    saved = tree_leaves(ckpt.load_checkpoint(
        str(run_dir / (prefix + "2")))["params"])
    assert [tuple(x.shape) for x in saved] == [a.shape for a in p0]
    if name == "ppg2mel":
        assert "Validation loss 0:" in out0
        assert "Validation loss" not in out1


# --------------------------------------------------- the WN int8 rungs

def _snr(ref, x):
    ref, x = ref.astype(np.float64), x.astype(np.float64)
    return 10 * np.log10(np.sum(ref ** 2)
                         / max(np.sum((x - ref) ** 2), 1e-30))


@pytest.mark.parametrize("rung", ["in_column", "in_tensor", "rs"])
def test_wn_int8_rung_under_tp(setup, two, rung):
    """Every flow on the rung, (1 x 2) against one process: the rung's
    SNR against the dense f32 call within 0.5 dB of the one-process
    rung's (whose activation scales are every rank's: the in conv's input
    is whole, the res_skip's scale static)."""
    one = tp_rungs(setup, None)
    for r in two:
        tp = r["rungs"]
        np.testing.assert_allclose(tp["dense"], one["dense"], atol=1e-5)
        want = _snr(one["dense"], one[rung])
        assert abs(_snr(one["dense"], tp[rung]) - want) <= 0.5, want


def test_vocoder_cli_and_bench_rungs_under_tp(cli_inputs, two):
    """The vocoder CLI's --model_parallel 2 --wn_impl conv --wn_int8_flows
    against the one-process CLI (40 dB), and the bench's rung flags under
    the mesh (a finite real-time factor, the mesh recorded)."""
    root, run = cli_inputs
    t_cli.main(device="cpu", **run("one", **RUNGS))
    names = sorted(os.listdir(root / "one"))
    assert len(names) == 3 and sorted(os.listdir(root / "tp")) == names
    for n in names:
        a = wavfile.read(str(root / "one" / n))[1]
        b = wavfile.read(str(root / "tp" / n))[1]
        assert np.abs(a).max() > 100 and _snr(a, b) > 40.0
    for r in two:
        line = r["bench"]
        assert np.isfinite(line["value"]) and line["value"] > 0
        assert line["detail"]["mesh"] == {"data": 1, "model": 2}
        assert line["detail"]["wn_int8_flows"] == 2


# ------------------------------------------------------- the graft entry

def test_graft_entry_matches_jax_entry():
    """The port's `entry()` against JAX's `entry()` (the root
    `__graft_entry__.py`) at the same full-width weights and the same
    example batch, JAX's prenet masks injected: mel_post, gate and
    alignments within 1e-4."""
    import __graft_entry__ as jg

    j_fn, j_args = jg.entry()
    fn, args = graft_entry.entry(device="cpu")
    for a, b in zip(args[2:6], j_args[2:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        want = j_fn(*j_args)
        jax.effects_barrier()
    params, state = tacotron2_from_jax(j_args[0], j_args[1])
    got = fn(params, state, *args[2:], masks=masks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    lines = graft_entry.dryrun_multichip(4, device="cpu")
    tags = ["tacotron2", "waveglow", "waveglow-tp-zero1", "ckpt-topology",
            "serving", "serving-pipelined"]
    assert [ln.split("]")[0].split("[")[1] for ln in lines] == tags
    assert all(ln.endswith("OK") for ln in lines)
    assert "mesh=(2 data x 2 model)" in lines[0]
    out = capsys.readouterr().out
    for ln in lines:
        assert ln in out


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    """No fallback: without cards, device=None raises (the dryrun and
    entry() alike); the model axis follows JAX's rule."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    assert [graft_entry.model_axis_for(n) for n in (4, 8, 16, 32)] \
        == [2, 2, 4, 8]
