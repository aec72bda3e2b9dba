"""The port's tensor-parallel training steps on the CPU (gloo ranks,
spawned once per mesh, torch only in the ranks), held against the JAX
package.

The Tacotron2 TP step at (1 x 2) and (2 x 2), with the JAX tests' lowered
thresholds (wide 16, big 64) so that every clause of the rule fires,
against JAX's single-device step and JAX's (4 x 2) step on the 8-device
host mesh, the same masks injected: loss 1e-5 relative, each gathered
gradient leaf within 1e-5 of its norm, the params after an SGD step 1e-5
(JAX's own bound), the batch-norm statistics 1e-6.  The WaveGlow TP step
(the res_skip weight norm summed over the model group) likewise.  The
global norm where the clip binds (1e-6 relative), the collectives a step
issues, replicated leaves equal on every model rank, ZeRO-1 over TP bit
for bit the TP step, a checkpoint moved from (2 x 2) to (4 x 1) and to
one process (the next two losses 1e-5 relative).  The collectives
themselves, the trainers, the WN int8 rungs and the graft entry are
tests/test_torch_port_tp_entry.py's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fac_via_ppg_tpu.models.tacotron2 as jt
import fac_via_ppg_tpu.models.waveglow as jw
from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWGConfig
from fac_via_ppg_torch.models import tacotron2 as tt
from fac_via_ppg_torch.parallel.mesh import Mesh
from fac_via_ppg_torch.parallel.sharding import tree_paths
from fac_via_ppg_torch.train import checkpoint as ckpt
from fac_via_ppg_torch.train import step as t_step
from fac_via_ppg_torch.utils.tree import tree_leaves
from fac_via_ppg_torch.weights import tacotron2_from_jax, \
    waveglow_train_from_jax
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config as JT2Config
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig as JWGConfig
from fac_via_ppg_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from fac_via_ppg_tpu.parallel.sharding import (
    apply_shardings,
    tacotron2_param_shardings,
    waveglow_param_shardings,
)
from fac_via_ppg_tpu.train import step as j_step
from tests.torch_port_helpers import (
    TINY_T2,
    rank_tp_four,
    rank_tp_steps,
    record_prenet_masks,
    run_ranks,
    tp_resume,
    train_step_out,
)

WG = dict(n_mel_channels=16, hop_length=64, n_flows=4, n_group=8,
          n_early_every=2, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=256)
J_CFG = JT2Config(**TINY_T2, scan_unroll=1)
SGD_LR = 1e6      # the gradients from JAX's params: (before - after) / lr
PARAM_LR = 1e-2   # JAX's TP tests' SGD rate, for the params after a step
TIGHT_CLIP = 1e-2
MESHES = ["1x2", "2x2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t2_batch(seed=0, B=4, T_in=10, T_out=16):
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
    """`tree`'s leaves in the order of `like`'s (a JAX step returns its
    dicts with sorted keys), as numpy arrays."""
    if isinstance(like, dict):
        return [x for k in like for x in _leaves(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, lk in zip(tree, like) for x in _leaves(t, lk)]
    return [np.asarray(tree)]


def _sgd_grads(before, after):
    return [((a.astype(np.float64) - b) / SGD_LR).astype(np.float32)
            for a, b in zip(_leaves(before, before), _leaves(after, before))]


def _jax_tp(step, params, state, batch, key, kind):
    """JAX's step on its (4 data x 2 model) mesh, the params under its TP
    rule (the lowered thresholds for Tacotron2, as its own test)."""
    mesh = make_mesh(data=4, model=2)
    if kind == "t2":
        p = apply_shardings(params, tacotron2_param_shardings(
            mesh, params, wide_threshold=16, big_threshold=64))
        return step(p, replicate(mesh, state), optax.sgd(SGD_LR).init(p),
                    shard_batch(mesh, batch), key)
    p = apply_shardings(params, waveglow_param_shardings(mesh, params))
    return step(p, optax.sgd(SGD_LR).init(p), shard_batch(mesh, batch))


@pytest.fixture(scope="module")
def setup():
    """Seeded tiny params (nonzero WaveGlow end convs) and batches; JAX's
    one-device Tacotron2 step with its masks recorded (the global batch's,
    in the port's `masks=` order) and JAX's (4 x 2) TP step with the same
    key (the same masks: its draws are sharding-invariant); JAX's WaveGlow
    step on one device and on the TP mesh."""
    t2_params, t2_state = jt.init_tacotron2(jax.random.PRNGKey(1), J_CFG)
    wg = jw.init_waveglow(jax.random.PRNGKey(2), JWGConfig(**WG))
    rng = np.random.RandomState(9)
    for wn in wg["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*wn["end"]["weight"].shape).astype(np.float32) * 0.05)
    t2_batch, wg_batch = _t2_batch(7), _wg_batch(3)
    key = jax.random.PRNGKey(9)
    sgd = optax.sgd(SGD_LR)
    step = j_step.make_tacotron2_train_step(J_CFG, sgd, donate=False)
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        one = step(t2_params, t2_state, sgd.init(t2_params),
                   tuple(map(jnp.asarray, t2_batch)), key)
        jax.effects_barrier()
    t2_tp = _jax_tp(step, t2_params, t2_state, t2_batch, key, "t2")
    wg_step = j_step.make_waveglow_train_step(JWGConfig(**WG), sgd, 0.7,
                                              donate=False)
    wg_one = wg_step(wg, sgd.init(wg), tuple(map(jnp.asarray, wg_batch)))
    wg_tp = _jax_tp(wg_step, wg, None, wg_batch, None, "wg")
    tp, ts = tacotron2_from_jax(t2_params, t2_state)
    port = dict(t2_cfg=dict(TINY_T2), t2_params=tp, t2_state=ts,
                wg_cfg=dict(WG), wg_params=waveglow_train_from_jax(wg),
                t2_batch=t2_batch, wg_batch=wg_batch, masks=masks,
                wg_batches=[_wg_batch(s) for s in (11, 12, 13)],
                tight_clip=TIGHT_CLIP)
    jax_ref = {
        "one": {"t2_loss": float(one.loss), "wg_loss": float(wg_one.loss),
                "t2_grads": _sgd_grads(t2_params, one.params),
                "wg_grads": _sgd_grads(wg, wg_one.params),
                "t2_state": _leaves(one.model_state, t2_state)},
        "tp": {"t2_loss": float(t2_tp.loss), "wg_loss": float(wg_tp.loss),
               "t2_grads": _sgd_grads(t2_params, t2_tp.params),
               "wg_grads": _sgd_grads(wg, wg_tp.params),
               "t2_state": _leaves(t2_tp.model_state, t2_state)},
        "t2_before": _leaves(t2_params, t2_params),
        "wg_before": _leaves(wg, wg)}
    return port, jax_ref


@pytest.fixture(scope="module")
def two(setup, tmp_path_factory):
    """One spawn of 2 ranks, a (1 data x 2 model) mesh (rank_tp_steps)."""
    port, _ = setup
    return run_ranks(2, tmp_path_factory.mktemp("tp_two"), rank_tp_steps,
                     port)


@pytest.fixture(scope="module")
def four(setup, tmp_path_factory):
    """One spawn of 4 ranks, a (2 data x 2 model) mesh (rank_tp_four)."""
    port, _ = setup
    root = tmp_path_factory.mktemp("tp_four")
    path = str(root / "tp_ckpt")
    return run_ranks(4, root, rank_tp_four, port, path), path


@pytest.fixture(scope="module")
def ranks(two, four):
    return {"1x2": two, "2x2": four[0]}


@pytest.fixture(scope="module")
def one_process(setup):
    port, _ = setup
    t2b = tuple(torch.as_tensor(x) for x in port["t2_batch"])
    wgb = tuple(torch.as_tensor(x) for x in port["wg_batch"])
    return {"t2": train_step_out("t2", port, t2b, masks=port["masks"]),
            "wg": train_step_out("wg", port, wgb),
            "t2_clip": train_step_out("t2", port, t2b, masks=port["masks"],
                                      clip=TIGHT_CLIP),
            "wg_clip": train_step_out("wg", port, wgb, clip=TIGHT_CLIP)}


def _paths(kind):
    if kind == "t2":
        tree = tt.init_tacotron2(Tacotron2Config(**TINY_T2),
                                 torch.Generator())[0]
    else:
        tree = jw.init_waveglow(jax.random.PRNGKey(0), JWGConfig(**WG))
    return tree_paths(tree)


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


# ------------------------------------------------------- the TP steps

@pytest.mark.parametrize("mesh", MESHES)
def test_tacotron2_tp_step_against_jax_one_device(setup, ranks, mesh):
    _, jax_ref = setup
    want = jax_ref["one"]
    for r in ranks[mesh]:
        got = r["t2"]
        np.testing.assert_allclose(got["losses"][0], want["t2_loss"],
                                   rtol=1e-5)
        _grads_close(got["grads"], want["t2_grads"], "t2")
        for a, b in zip(got["state"], want["t2_state"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_tacotron2_tp_step_against_jax_tp_mesh(setup, ranks, mesh):
    """Against JAX's (4 x 2) step, which drew the one-device masks."""
    _, jax_ref = setup
    want = jax_ref["tp"]
    np.testing.assert_allclose(want["t2_loss"], jax_ref["one"]["t2_loss"],
                               rtol=1e-6)
    got = ranks[mesh][0]["t2"]
    np.testing.assert_allclose(got["losses"][0], want["t2_loss"], rtol=1e-5)
    _grads_close(got["grads"], want["t2_grads"], "t2")
    for a, b in zip(got["state"], want["t2_state"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["t2", "wg"])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_sgd_params_within_jax_bound(setup, ranks, mesh, kind):
    """The params after an SGD step at JAX's TP tests' rate, p - lr g,
    from the port's gathered gradients and from JAX's TP step's, to JAX's
    own bound (1e-5)."""
    _, jax_ref = setup
    got = ranks[mesh][0][kind]["grads"]
    for p, g, w in zip(jax_ref[f"{kind}_before"], got,
                       jax_ref["tp"][f"{kind}_grads"]):
        np.testing.assert_allclose(p - np.float32(PARAM_LR) * g,
                                   p - np.float32(PARAM_LR) * w, atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_waveglow_tp_step_against_jax(setup, ranks, mesh):
    """Every gradient leaf, the res_skip layers' g, v and bias among
    them (their weight norm sums the ranks' squares), against JAX's
    one-device and (4 x 2) steps."""
    _, jax_ref = setup
    for ref in ("one", "tp"):
        for r in ranks[mesh]:
            got = r["wg"]
            np.testing.assert_allclose(got["losses"][0],
                                       jax_ref[ref]["wg_loss"], rtol=1e-5)
            _grads_close(got["grads"], jax_ref[ref]["wg_grads"], "wg")
    paths = _paths("wg")
    assert any("res_skip_layers" in p and p.endswith("['v']") for p in paths)


@pytest.mark.parametrize("kind", ["t2", "wg"])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_step_matches_the_port_one_process(ranks, one_process, mesh,
                                              kind):
    """Against the port's own one-process Adam step: the loss, the
    gradients, the global norm (1e-6 relative) and the params after it."""
    want = one_process[kind]
    got = ranks[mesh][0][kind]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _grads_close(got["grads"], want["grads"], kind)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_tp_global_norm_where_the_clip_binds(ranks, one_process, kind):
    """A clip well under the norm: the norm every rank returns is the
    one-process step's (1e-6 relative), on every rank alike."""
    want = one_process[f"{kind}_clip"]
    assert want["grad_norm"] > 10 * TIGHT_CLIP
    norms = [r[f"{kind}_clip"]["grad_norm"] for r in ranks["1x2"]]
    assert norms[0] == norms[1]
    np.testing.assert_allclose(norms[0], want["grad_norm"], rtol=1e-6)
    _grads_close(ranks["1x2"][0][f"{kind}_clip"]["grads"], want["grads"],
                 kind)


@pytest.mark.parametrize("kind", ["t2", "wg"])
@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_leaves_equal_on_every_model_rank(ranks, mesh, kind):
    res = ranks[mesh]
    for m in range(0, len(res), 2):
        a, b = res[m][kind]["replicated"], res[m + 1][kind]["replicated"]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _tacotron2_collectives(T_in, T_out, n_bn=8):
    """The collectives of one (1 x 2) Tacotron2 step at the lowered
    thresholds (every clause fires; the query splits too).  Gathers,
    forward: the encoder prenet's layer 1, 3 encoder convs, a BLSTM step
    a direction, the attention memory, 2 decoder prenet layers, 4 a
    decoder step (attention LSTM, query, decoder LSTM, projection), 5
    postnet convs.  All-reduces: the prenet's contraction split; 2 a batch
    norm (sum, squared deviations) and the longest target over the data
    group; the gradients and the loss averaged; the clip's norm; and,
    backward, one `copy_to_model` for every split product whose input
    needs a gradient: the gathers' but the decoder prenet's first layer
    (the teacher mel) and a BLSTM's first step (h = 0), plus each BLSTM
    direction's input projection.  One broadcast: the replicated leaves'
    gradients from model rank 0."""
    gathers = 1 + 3 + 2 * T_in + 1 + 2 + 4 * T_out + 5
    forward = 1 + 2 * n_bn + 1 + 2 + 1
    backward = gathers - 1 - 2 + 2
    return {"all_reduce": forward + backward, "all_gather": gathers,
            "broadcast": 1}


def _waveglow_collectives(cfg):
    """The collectives of one (1 x 2) WaveGlow step: a flow's res_skip
    weight norm (one all-reduce of every layer's squares), residuals (one
    a layer but the last) and skip sum forward; backward, its g and norms'
    `copy_to_model`, the grouped spect's, and the audio entering each
    in_layer; the gradients, the loss and the clip's norm; one broadcast
    of the replicated leaves' gradients."""
    L, F = cfg["wn_n_layers"], cfg["n_flows"]
    return {"all_reduce": F * (1 + (L - 1) + 1) + F * (1 + 1 + L) + 3,
            "all_gather": 0, "broadcast": 1}


@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_tp_collectives_per_step(setup, two, kind):
    port, _ = setup
    want = (_tacotron2_collectives(10, 16) if kind == "t2"
            else _waveglow_collectives(port["wg_cfg"]))
    for r in two:
        assert r[kind]["collectives"] == want


# ------------------------------------------------------- ZeRO-1 and TP

@pytest.mark.parametrize("kind", ["t2", "wg"])
def test_zero1_over_tp_bit_equal_to_tp(four, kind):
    """Three steps at (2 x 2), Adam's moments over both axes or over the
    model axis alone: the same params bit for bit; at least one moment
    leaf composes the model and data splits."""
    res, _ = four
    for r in res:
        z = r[f"zero_{kind}"]
        assert z["bit_equal"] and z["composed"] > 0 and z["data_split"] > 0
        assert np.all(np.isfinite(z["losses"]))


@pytest.mark.parametrize("where", ["4x1", "one_process"])
def test_tp_checkpoint_moves_between_meshes(setup, four, where):
    """Written at (2 x 2) with ZeRO-1, read at (4 x 1) with ZeRO-1 and in
    one process: the next two steps' losses (the second reads the params
    the restored moments updated) within 1e-5 relative, the params after
    them within 1e-6."""
    port, _ = setup
    res, path = four
    want = res[0]["resume"]
    got = ([r["resume_4x1"] for r in res] if where == "4x1"
           else [tp_resume(port, path, None)])
    for g in got:
        for k in ("loss", "next_loss"):
            np.testing.assert_allclose(g[k], want[k], rtol=1e-5)
        for a, b in zip(g["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_tp_checkpoint_holds_whole_tensors(setup, four):
    port, _ = setup
    _, path = four
    payload = ckpt.load_checkpoint(path)
    leaves = tree_leaves(port["wg_params"])
    got = tree_leaves(payload["params"])
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in leaves]
    for i, p in enumerate(leaves):
        st = payload["opt_state"]["state"][i]
        assert st["exp_avg"].shape == p.shape == st["exp_avg_sq"].shape
        assert float(st["step"]) == 2


def test_tensor_parallel_step_needs_the_layout():
    mesh = Mesh(1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="tensor-parallel layout"):
        t_step.make_waveglow_train_step(TWGConfig(**WG), None, 0.7,
                                        mesh=mesh)


