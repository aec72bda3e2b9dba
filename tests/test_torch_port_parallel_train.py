"""The port's data-parallel training on the CPU (gloo ranks, spawned,
torch only): a 2-rank Tacotron2 step (batch norm over the global batch,
the global batch's dropout masks injected) and a WaveGlow step, each
against the port's one-process step on the concatenated batch and the JAX
package's data-parallel step on its mesh (the same masks: JAX's draws
are sharding-invariant): loss 1e-6 relative, each gradient leaf within
1e-5 of its norm, batch-norm running statistics 1e-6.  ZeRO-1's params
bit for bit the unsharded step's; a checkpoint written at world 2 with
ZeRO-1 resumed at worlds 1 and 4 (the next loss 1e-6 relative, the
params after it 1e-6); both trainers' main() on 2 ranks; the mask
helpers that make a data-parallel step draw the one-process step's masks.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import fac_via_ppg_tpu.models.tacotron2 as jt
import fac_via_ppg_tpu.models.waveglow as jw
from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.models import tacotron2 as tt
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle
from fac_via_ppg_torch.train import step as t_step
from fac_via_ppg_torch.utils.tree import tree_leaves
from fac_via_ppg_torch.weights import tacotron2_from_jax, \
    waveglow_train_from_jax
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config as JT2Config
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig as JWGConfig
from fac_via_ppg_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from fac_via_ppg_tpu.train import step as j_step
from tests.torch_port_helpers import (
    TINY_T2,
    rank_train_steps,
    rank_trainers,
    rank_zero_resume,
    record_prenet_masks,
    run_ranks,
    train_step_out,
    zero_resume,
)

WG = dict(n_mel_channels=16, hop_length=64, n_flows=4, n_group=8,
          n_early_every=2, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=256)
J_CFG = JT2Config(**TINY_T2, scan_unroll=1)
SGD_LR = 1e6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t2_batch(seed=0, B=4, T_in=10, T_out=16):
    """A global batch of 4 (two ranks' rows each), bucket-padded: every
    rank's shard has the same padded shape, as `pad_dims` makes it."""
    rng = np.random.RandomState(seed)
    in_len = np.array([10, 9, 7, 6], np.int64)
    out_len = np.array([13, 16, 9, 7], np.int64)
    ppg = np.abs(rng.rand(B, J_CFG.n_symbols, T_in)).astype(np.float32)
    ppg *= np.arange(T_in)[None, None] < in_len[:, None, None]
    mel = (rng.randn(B, 80, T_out) * 0.3).astype(np.float32)
    mel *= np.arange(T_out)[None, None] < out_len[:, None, None]
    gate = (np.arange(T_out)[None] >= (out_len - 1)[:, None]).astype(
        np.float32)
    return ppg, in_len, mel, gate, out_len


def _wg_batch(seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(4, 16, 12) * 0.5).astype(np.float32),
            (rng.randn(4, 12 * 64) * 0.2).astype(np.float32))


def _leaves(tree, like):
    """`tree`'s leaves in the order of `like`'s, the tree the port's
    params were converted from (a JAX step returns its dicts with sorted
    keys), as numpy arrays."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, lk in zip(tree, like) for x in _leaves(t, lk)]
    return [np.asarray(tree)]


def _sgd_grads(before, after):
    return [((a.astype(np.float64) - b) / SGD_LR).astype(np.float32)
            for a, b in zip(_leaves(before, before), _leaves(after, before))]


@pytest.fixture(scope="module")
def setup():
    """Seeded tiny params (nonzero WaveGlow end convs), the global
    batches, and JAX's one-device Tacotron2 step with its masks recorded
    (the global batch's, in the port's `masks=` order); then JAX's step
    on a 2-data mesh with the same key, which draws the same masks."""
    t2_params, t2_state = jt.init_tacotron2(jax.random.PRNGKey(1), J_CFG)
    wg = jw.init_waveglow(jax.random.PRNGKey(2), JWGConfig(**WG))
    rng = np.random.RandomState(9)
    for wn in wg["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*wn["end"]["weight"].shape).astype(np.float32) * 0.05)
    t2_batch, wg_batch = _t2_batch(7), _wg_batch(3)
    key = jax.random.PRNGKey(9)
    # SGD(SGD_LR): (params before - after) / SGD_LR are the gradients, to
    # f32's relative rounding (lr * g dwarfs the params)
    sgd = optax.sgd(SGD_LR)
    step = j_step.make_tacotron2_train_step(J_CFG, sgd, donate=False)
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        one = step(t2_params, t2_state, sgd.init(t2_params),
                   tuple(map(jnp.asarray, t2_batch)), key)
        jax.effects_barrier()
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    dp = step(replicate(mesh, t2_params), replicate(mesh, t2_state),
              replicate(mesh, sgd.init(t2_params)),
              shard_batch(mesh, t2_batch), key)
    wg_step = j_step.make_waveglow_train_step(JWGConfig(**WG), sgd, 0.7,
                                              donate=False)
    wg_dp = wg_step(replicate(mesh, wg), replicate(
        mesh, sgd.init(wg)), shard_batch(mesh, wg_batch))
    tp, ts = tacotron2_from_jax(t2_params, t2_state)
    port = dict(t2_cfg=dict(TINY_T2), t2_params=tp, t2_state=ts,
                wg_cfg=dict(WG), wg_params=waveglow_train_from_jax(wg),
                t2_batch=t2_batch, wg_batch=wg_batch, masks=masks,
                wg_batches=[_wg_batch(s) for s in (11, 12, 13)])
    jax_dp = {
        "t2_loss": float(dp.loss), "wg_loss": float(wg_dp.loss),
        "t2_grads": _sgd_grads(t2_params, dp.params),
        "wg_grads": _sgd_grads(wg, wg_dp.params),
        "t2_state": _leaves(dp.model_state, t2_state),
        "t2_one_loss": float(one.loss)}
    return port, jax_dp


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    port, _ = setup
    root = tmp_path_factory.mktemp("train_ranks")
    path = str(root / "zero_ckpt")
    res = run_ranks(2, root, rank_train_steps, port, path)
    return res, path


@pytest.fixture(scope="module")
def one_process(setup):
    port, _ = setup
    return {"t2": train_step_out("t2", port, tuple(
        torch.as_tensor(x) for x in port["t2_batch"]), masks=port["masks"]),
        "wg": train_step_out("wg", port, tuple(
            torch.as_tensor(x) for x in port["wg_batch"]))}


def _grads_close(got, want, kind, tol=1e-5):
    """Each leaf within `tol` of its norm; a conv bias that a training
    batch norm follows, whose gradient is zero but for rounding, within
    `tol` of the whole gradient's norm."""
    assert len(got) == len(want)
    total = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for w in want))
    for g, w, path in zip(got, want, _paths(kind)):
        noise = path.startswith(("['encoder']['convolutions']",
                                 "['postnet']['convolutions']")) \
            and path.endswith("['conv']['bias']")
        ref = total if noise else max(np.linalg.norm(w), 1e-12)
        assert np.linalg.norm(g - w) <= tol * ref, path


def _paths(kind):
    from fac_via_ppg_torch.parallel.sharding import tree_paths

    if kind == "t2":
        cfg = Tacotron2Config(**TINY_T2)
        tree = tt.init_tacotron2(cfg, torch.Generator())[0]
    else:
        tree = jw.init_waveglow(jax.random.PRNGKey(0), JWGConfig(**WG))
    return tree_paths(tree)


@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_dp_step_equals_one_process_on_the_concatenated_batch(
        ranks, one_process, kind):
    res, _ = ranks
    want = one_process[kind]
    for r in res:
        got = r[kind]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        _grads_close(got["grads"], want["grads"], kind)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        if kind == "t2":  # the running statistics of the global batch
            for a, b in zip(got["state"], want["state"]):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    # both ranks hold the same params after the step
    for a, b in zip(res[0][kind]["params"], res[1][kind]["params"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_dp_step_matches_jax_dp_step(setup, ranks, kind):
    _, jax_dp = setup
    res, _ = ranks
    got = res[0][kind]
    np.testing.assert_allclose(got["losses"][0], jax_dp[f"{kind}_loss"],
                               rtol=1e-6)
    _grads_close(got["grads"], jax_dp[f"{kind}_grads"], kind)
    if kind == "t2":
        for a, b in zip(got["state"], jax_dp["t2_state"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        # JAX's DP step drew the one-device step's masks
        np.testing.assert_allclose(jax_dp["t2_loss"], jax_dp["t2_one_loss"],
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_zero1_params_bit_equal_to_unsharded(ranks, kind):
    res, _ = ranks
    for r in res:
        z = r[f"zero_{kind}"]
        assert z["bit_equal"] and z["moments_sharded"]
        assert np.all(np.isfinite(z["losses"]))


@pytest.mark.parametrize("world", [1, 4])
def test_zero_checkpoint_resumes_at_another_world(setup, ranks, world,
                                                  tmp_path):
    """Saved at world 2 with ZeRO-1 (one file, the unsharded Adam's
    state), read at world 1 (plain Adam) and at world 4 (ZeRO-1): the
    next step's loss and the params after it are world 2's."""
    port, _ = setup
    res, path = ranks
    want = res[0]["resume"]
    if world == 1:
        got = [zero_resume(port, path, None, 0, 1)]
    else:
        got = run_ranks(4, tmp_path, rank_zero_resume, port, path)
    for g in got:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-6)
        for a, b in zip(g["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_zero_checkpoint_holds_the_whole_moments(setup, ranks):
    from fac_via_ppg_torch.train import checkpoint as ckpt

    port, _ = setup
    _, path = ranks
    payload = ckpt.load_checkpoint(path)
    leaves = tree_leaves(port["wg_params"])
    assert len(payload["opt_state"]["state"]) == len(leaves)
    for i, p in enumerate(leaves):
        st = payload["opt_state"]["state"][i]
        assert st["exp_avg"].shape == p.shape == st["exp_avg_sq"].shape
        assert float(st["step"]) == 2


# ----------------------------------------- the masks of the global batch

def test_training_masks_are_the_generator_path_draws(setup):
    """A step whose masks are `training_masks` drawn from a generator
    equals the step that draws them itself from the same seed."""
    port, _ = setup
    cfg = Tacotron2Config(**TINY_T2)
    batch = tuple(torch.as_tensor(x) for x in port["t2_batch"])
    outs = []
    for inject in (False, True):
        g = torch.Generator().manual_seed(4)
        masks = (tt.training_masks(cfg, port["t2_params"], 4, 10, 16, "cpu",
                                   g) if inject else None)
        opt = t_step.make_tacotron2_train_step(cfg, _Plain())
        outs.append(opt(_fresh(port["t2_params"]), _fresh(port["t2_state"]),
                        None, batch, torch.Generator().manual_seed(4),
                        masks=masks))
    assert float(outs[0].loss) == float(outs[1].loss)
    for a, b in zip(tree_leaves(outs[0].model_state),
                    tree_leaves(outs[1].model_state)):
        assert torch.equal(a, b)


def test_inference_masks_are_the_decode_draws(setup):
    port, _ = setup
    cfg = Tacotron2Config(**TINY_T2)
    ppg = torch.as_tensor(port["t2_batch"][0][:2])
    lens = torch.as_tensor(port["t2_batch"][1][:2])
    outs = []
    for inject in (False, True):
        g = torch.Generator().manual_seed(6)
        masks = (iter(tt.inference_masks(cfg, port["t2_params"], 2, 10,
                                         "cpu", g)) if inject else None)
        outs.append(tt.tacotron2_inference_batched(
            cfg, port["t2_params"], port["t2_state"], ppg, lens,
            torch.Generator().manual_seed(6), masks=masks))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


class _Plain:
    """No update: the step's loss and state alone."""

    def apply(self, opt_state, grads):
        return torch.zeros(())


def _fresh(tree):
    from fac_via_ppg_torch.utils.tree import tree_map

    return tree_map(lambda x: x.clone(), tree)


# ---------------------------------------------------------- the trainers

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
def trainers(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    deps = dict(nnet_path=str(root / "bundle/am/final.raw.txt"),
                lda_path=str(root / "bundle/feats/final.mat"),
                reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
                splice_opts_path=str(root / "bundle/feats/splice_opts"))
    wavs = _wavs(root, 5, 4800)
    (root / "train.txt").write_text("\n".join(wavs[:4]) + "\n")
    (root / "val.txt").write_text(wavs[4] + "\n")
    t2 = {**TINY_T2, "max_decoder_steps": 16}
    run = dict(training_files=str(root / "train.txt"),
               validation_files=str(root / "val.txt"),
               output_directory=str(root / "t2run"), batch_size=1, seed=1,
               length_bucket_size=32, learning_rate=1e-3,
               data_parallel_devices=2, **t2)
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
    res = run_ranks(2, root, rank_trainers, run, deps, cfg_path)
    return root, res


@pytest.mark.parametrize("name,pattern,prefix", [
    ("ppg2mel", "Train loss", "checkpoint_"),
    ("waveglow", "s/it)", "waveglow_")])
def test_trainers_on_two_ranks(trainers, name, pattern, prefix):
    """4 items, 1 a rank: 2 iterations an epoch, 2 epochs; rank 0 alone
    prints and writes; both ranks end on the same params."""
    root, res = trainers
    (out0, it0, p0), (out1, it1, p1) = res[0][name], res[1][name]
    assert it0 == it1 == 4
    lines = [ln for ln in out0.splitlines() if pattern in ln]
    assert len(lines) == 4, out0
    assert not [ln for ln in out1.splitlines() if pattern in ln]
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
        assert np.all(np.isfinite(a))
    run_dir = root / ("t2run" if name == "ppg2mel" else "wgrun")
    assert sorted(n for n in os.listdir(run_dir) if n.startswith(prefix)) \
        == [prefix + "0", prefix + "2"]
    if name == "ppg2mel":
        assert "Validation loss 0:" in out0
        assert "Validation loss" not in out1
