"""The port's trainers on the CPU: checkpoints (save / load / resume bit
for bit, warm start, the newest checkpoint, the async saver), SIGTERM
preemption, both CLIs end to end at tiny widths, and their refusals (no
card, unported options).  The port alone: nothing here imports JAX.
"""

import glob
import json
import os
import signal

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.data import ppg_mel_dataset as ds_mod
from fac_via_ppg_torch.frontend.ppg import DependenciesPPG
from fac_via_ppg_torch.models.tacotron2 import init_tacotron2
from fac_via_ppg_torch.scripts import train_ppg2mel, train_waveglow
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle
from fac_via_ppg_torch.train import checkpoint as ckpt
from fac_via_ppg_torch.train import preemption
from fac_via_ppg_torch.train.optim import make_optimizer
from fac_via_ppg_torch.train.profiling import span, spans, trace
from fac_via_ppg_torch.train.step import make_tacotron2_train_step
from fac_via_ppg_torch.utils.tree import tree_leaves

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small ops: the suite runs several
    workers on the CPU, and oversubscribed threads slow it manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the widths of tests/torch_port_helpers.TINY_T2 (which imports JAX)
T2 = dict(n_symbols=16, symbols_embedding_dim=16, encoder_embedding_dim=16,
          decoder_rnn_dim=12, prenet_dim=8, attention_rnn_dim=12,
          attention_dim=8, attention_location_n_filters=4,
          attention_location_kernel_size=7, postnet_embedding_dim=16,
          max_decoder_steps=16)
WG_CONFIG = dict(n_mel_channels=16, hop_length=64, n_flows=2, n_group=8,
                 n_early_every=4, n_early_size=2,
                 WN_config=dict(n_layers=2, n_channels=16, kernel_size=3))


def _batch(seed=0, B=4, T_in=10, T_out=12):
    rng = np.random.RandomState(seed)
    ppg = np.abs(rng.rand(B, T2["n_symbols"], T_in)).astype(np.float32)
    out_len = np.array([12, 11, 9, 8])
    mel = (rng.randn(B, 80, T_out) * 0.3).astype(np.float32)
    gate = (np.arange(T_out)[None] >= (out_len - 1)[:, None]).astype(
        np.float32)
    return tuple(torch.as_tensor(x) for x in (
        ppg, np.array([10, 9, 8, 6]), mel, gate, out_len))


def _fresh(seed=0):
    cfg = Tacotron2Config(**T2)
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(seed))
    opt = make_optimizer(1e-3, 1e-6, 1.0)
    return cfg, params, state, opt


def _run(step, params, state, opt_state, iterations):
    for it in iterations:
        out = step(params, state, opt_state, _batch(it),
                   torch.Generator().manual_seed(100 + it))
        state = out.model_state
    return params, state


# ------------------------------------------------------------ checkpoints

def test_checkpoint_resume_equals_uninterrupted_training(tmp_path):
    """2 steps, save, load into a fresh optimizer, 2 more steps: the same
    params and BN state, bit for bit, as 4 uninterrupted steps."""
    cfg, params, state, opt = _fresh()
    step = make_tacotron2_train_step(cfg, opt)
    opt_state = opt.init(params)
    ref_params, ref_state = _run(step, params, state, opt_state, range(4))

    cfg, params, state, opt = _fresh()
    opt_state = opt.init(params)
    params, state = _run(step, params, state, opt_state, range(2))
    path = str(tmp_path / "checkpoint_1")
    ckpt.save_checkpoint(path, params, opt_state, 1e-3, 1, state)
    payload = ckpt.load_checkpoint(path)
    assert payload["iteration"] == 1 and payload["learning_rate"] == 1e-3
    params, state = payload["params"], payload["model_state"]
    opt_state = opt.init(params)
    opt_state.load_state_dict(payload["opt_state"])
    params, state = _run(step, params, state, opt_state, range(2, 4))
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((ref_params, ref_state))):
        assert torch.equal(a, b)


def test_warm_start_and_latest_checkpoint(tmp_path):
    cfg, params, state, opt = _fresh()
    for it in (3, 12, 7):
        ckpt.save_checkpoint(str(tmp_path / f"checkpoint_{it}"), params,
                             opt.init(params), 1e-3, it, state)
    (tmp_path / "checkpoint_99.tmp").write_bytes(b"")
    (tmp_path / "checkpoint_50").mkdir()
    assert ckpt.find_latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "checkpoint_12")
    assert ckpt.find_latest_checkpoint(str(tmp_path), "waveglow_") is None
    assert ckpt.find_latest_checkpoint(str(tmp_path / "nope")) is None
    warm = ckpt.warm_start(str(tmp_path / "checkpoint_7"))
    assert set(warm) == {"encoder", "decoder", "postnet"}
    for a, b in zip(tree_leaves(warm), tree_leaves(params)):
        assert torch.equal(a, b)


def test_async_saver_snapshots_and_reports_failures(tmp_path):
    cfg, params, state, opt = _fresh()
    opt_state = opt.init(params)
    step = make_tacotron2_train_step(cfg, opt)
    step(params, state, opt_state, _batch(0), torch.Generator())
    want = [x.clone() for x in tree_leaves(params)]
    saver = ckpt.AsyncCheckpointSaver()
    saver.save(str(tmp_path / "a"), params, opt_state, 1e-3, 4, state)
    # the optimizer updates the params in place right after save()
    step(params, state, opt_state, _batch(1), torch.Generator())
    saver.save(str(tmp_path / "b"), params, opt_state, 1e-3, 5, state)
    saver.wait()
    a = ckpt.load_checkpoint(str(tmp_path / "a"))
    assert a["iteration"] == 4
    for x, y in zip(tree_leaves(a["params"]), want):
        assert torch.equal(x, y)
    b = ckpt.load_checkpoint(str(tmp_path / "b"))
    assert not torch.equal(tree_leaves(b["params"])[0], want[0])
    bad = ckpt.AsyncCheckpointSaver()
    bad.save("/proc/definitely/not/writable", params, opt_state, 1e-3, 0)
    with pytest.raises(RuntimeError, match="does not exist"):
        bad.wait()


def test_preemption_guard_sigterm_and_uninstall():
    before = signal.getsignal(signal.SIGTERM)
    with preemption.PreemptionGuard() as guard:
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)  # handled, not fatal
        assert guard.requested and guard.should_stop()
    assert signal.getsignal(signal.SIGTERM) is before


# --------------------------------------------------------- the trainers

def _wavs(tmp_path, n, base):
    paths = []
    for i in range(n):
        t = np.arange(base + 160 * i) / 16000.0
        p = str(tmp_path / f"w{i}.wav")
        wavfile.write(p, 16000, (np.sin(2 * np.pi * (180 + 15 * i) * t)
                                 * 9000).astype(np.int16))
        paths.append(p)
    return paths


@pytest.fixture
def ppg2mel_run(tmp_path, monkeypatch):
    """A tiny substitute AM (the dataset's default deps) and 4 + 1 wavs;
    returns the hparams overrides of a run."""
    make_bundle(str(tmp_path / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    deps = DependenciesPPG(
        nnet_path=str(tmp_path / "bundle/am/final.raw.txt"),
        lda_path=str(tmp_path / "bundle/feats/final.mat"),
        reduce_dim_path=str(tmp_path / "bundle/feats/reduce_dim.mat"),
        splice_opts_path=str(tmp_path / "bundle/feats/splice_opts"))
    monkeypatch.setattr(ds_mod, "DependenciesPPG", lambda: deps)
    wavs = _wavs(tmp_path, 5, 4800)
    (tmp_path / "train.txt").write_text("\n".join(wavs[:4]) + "\n")
    (tmp_path / "val.txt").write_text(wavs[4] + "\n")
    return dict(training_files=str(tmp_path / "train.txt"),
                validation_files=str(tmp_path / "val.txt"),
                output_directory=str(tmp_path / "run"), batch_size=2,
                seed=1, length_bucket_size=32, learning_rate=1e-3, **T2)


def test_train_ppg2mel_cli_on_cpu(ppg2mel_run, capsys):
    """main(): 2 epochs of 2 iterations, validation and a checkpoint
    every 2, a falling finite loss; then auto-resume from the newest
    checkpoint (iteration 2): iteration 3 on, from the start of its
    epoch (1), through epoch 2."""
    run = ppg2mel_run
    params, _, _, iteration = train_ppg2mel.main(
        device="cpu", epochs=2, iters_per_checkpoint=2, **run)
    assert iteration == 4
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("Train loss")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "Validation loss 0:" in out and "Validation loss 2:" in out
    cks = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(run["output_directory"],
                                        "checkpoint_*")))
    assert cks == ["checkpoint_0", "checkpoint_2"]
    assert os.path.isfile(os.path.join(run["output_directory"],
                                       "hparams.txt"))
    assert glob.glob(os.path.join(run["output_directory"], "log",
                                  "events.*"))
    _, _, _, iteration = train_ppg2mel.main(
        device="cpu", epochs=3, iters_per_checkpoint=100,
        checkpoint_path="auto", **run)
    assert iteration == 7
    out = capsys.readouterr().out
    assert "Auto-resume from" in out and "Train loss 3 " in out
    assert "Train loss 2 " not in out and "Epoch: 1" in out


def test_train_ppg2mel_preemption_checkpoints(ppg2mel_run, monkeypatch):
    class FireAtSecondPoll(preemption.PreemptionGuard):
        polls = 0

        def should_stop(self):
            FireAtSecondPoll.polls += 1
            if FireAtSecondPoll.polls == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().should_stop()

    monkeypatch.setattr(preemption, "PreemptionGuard", FireAtSecondPoll)
    _, _, _, iteration = train_ppg2mel.main(
        device="cpu", epochs=50, iters_per_checkpoint=100, **ppg2mel_run)
    assert iteration == 2
    assert os.path.isfile(os.path.join(ppg2mel_run["output_directory"],
                                       "checkpoint_1"))


@pytest.fixture
def waveglow_run(tmp_path):
    wavs = _wavs(tmp_path, 4, 6000)
    (tmp_path / "files.txt").write_text("\n".join(wavs) + "\n")
    with open(DEFAULT_WAVEGLOW_CONFIG_PATH) as f:
        config = json.load(f)
    config["train_config"].update(output_directory=str(tmp_path / "run"),
                                  batch_size=2, seed=1, learning_rate=1e-3)
    config["data_config"].update(training_files=str(tmp_path / "files.txt"),
                                 segment_length=2048, filter_length=256,
                                 hop_length=64, win_length=256,
                                 n_mel_channels=16)
    config["waveglow_config"] = WG_CONFIG
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path, str(tmp_path / "run")


def test_train_waveglow_cli_on_cpu(waveglow_run, capsys):
    path, out_dir = waveglow_run
    params, _, iteration = train_waveglow.main(
        path, device="cpu", epochs=2, iters_per_checkpoint=2)
    assert iteration == 4
    out = capsys.readouterr().out
    losses = [float(line.split("\t")[1]) for line in out.splitlines()
              if "s/it)" in line]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out_dir, "waveglow_*"))) == ["waveglow_0",
                                                  "waveglow_2"]
    assert os.path.isfile(os.path.join(out_dir, "config.json"))
    # the train form is kept: weight-norm g / v leaves
    assert set(params["wn"][0]["in_layers"][0]) == {"g", "v", "bias"}
    # from waveglow_2: iteration 3 on, epochs 1 and 2
    _, _, iteration = train_waveglow.main(
        path, device="cpu", epochs=3, iters_per_checkpoint=100,
        checkpoint_path="auto")
    assert iteration == 7


def test_torch_train_waveglow_preemption_resumes(waveglow_run,
                                                           monkeypatch):
    path, out_dir = waveglow_run

    class FireAtThirdPoll(preemption.PreemptionGuard):
        polls = 0

        def should_stop(self):
            FireAtThirdPoll.polls += 1
            if FireAtThirdPoll.polls == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().should_stop()

    monkeypatch.setattr(preemption, "PreemptionGuard", FireAtThirdPoll)
    _, _, iteration = train_waveglow.main(
        path, device="cpu", epochs=2000, iters_per_checkpoint=1000)
    assert iteration == 3
    assert os.path.isfile(os.path.join(out_dir, "waveglow_2"))
    monkeypatch.undo()
    # no work lost: iteration 3 on, from the start of epoch 1
    _, _, iteration = train_waveglow.main(
        path, device="cpu", epochs=3, iters_per_checkpoint=1000,
        checkpoint_path="auto")
    assert iteration == 7


@pytest.mark.parametrize("trainer", ["ppg2mel", "waveglow"])
def test_trainers_default_to_cuda(tmp_path, monkeypatch, trainer):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if trainer == "ppg2mel":
            train_ppg2mel.main(output_directory=str(tmp_path / "run"))
        else:
            train_waveglow.main(output_directory=str(tmp_path / "run"))


@pytest.mark.parametrize("option,value,match", [
    ("data_parallel_devices", 2, "queue 1 item 6"),
    ("tensor_parallel_devices", 2, "queue 1 item 6"),
    ("zero_sharded_opt_state", True, "queue 1 item 6"),
])
def test_unported_options_raise(tmp_path, option, value, match,
                                ppg2mel_run, waveglow_run):
    """The parallel options in one process: data_parallel_devices=2 and
    tensor_parallel_devices=2 each ask for two processes and raise, saying
    how to launch (torchrun); ZeRO-1 over a data axis of 1 is a no-op and
    trains.  (`match`, the case's id, names the multi-GPU item of the
    ROADMAP's first queue that ported these options.)"""
    path, _ = waveglow_run
    if option == "zero_sharded_opt_state":
        _, _, _, iteration = train_ppg2mel.main(
            device="cpu", epochs=1, iters_per_checkpoint=100,
            **{**ppg2mel_run, option: value})
        assert iteration == 2
        _, opt_state, iteration = train_waveglow.main(
            path, device="cpu", epochs=1, iters_per_checkpoint=100,
            **{option: value})
        assert iteration == 2 and isinstance(opt_state, torch.optim.Adam)
        return
    match = "needs 2 processes, but this job has 1.*torchrun"
    with pytest.raises(ValueError, match=match):
        train_ppg2mel.main(device="cpu",
                           output_directory=str(tmp_path / "run"),
                           **{option: value})
    with pytest.raises(ValueError, match=match):
        train_waveglow.main(path, device="cpu",
                            output_directory=str(tmp_path / "wg"),
                            **{option: value})


def test_profiling_trace_and_timer(tmp_path):
    with trace(str(tmp_path / "prof")):
        with span("matmul", None, n=8):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert '"matmul"' in f.read()
    (rec,) = spans()
    assert rec.name == "matmul" and rec.attrs == {"n": 8}
    assert rec.seconds > 0 and rec.self_seconds == rec.seconds
    with trace(""):  # disabled
        with span("off"):
            pass
    assert [s.name for s in spans()] == ["matmul"]


def test_parse_overrides():
    assert train_ppg2mel.parse_overrides(
        ["epochs=2", "output_directory=/tmp/x", "train_dtype=bfloat16",
         "remat=True"]) == {"epochs": 2, "output_directory": "/tmp/x",
                            "train_dtype": "bfloat16", "remat": True}
