"""The port's training pieces against the JAX package on the CPU: losses,
the optimizer and LR schedules, training-mode batch norm, Tacotron2's
teacher-forced forward and its gradients (every JAX dropout mask recorded
and injected), whole train steps (f32, grad_accum=2, remat, bf16), and
WaveGlow's training forward, its gradients and its steps.

Tolerances: losses atol 1e-6; Adam rtol 1e-6 with atol 1e-6 on params
of unit scale (five f32 updates rounded in another order, 4 ulp; torch's
clip divides by norm + 1e-6, optax's by the norm); schedules rtol 1e-6 (optax computes in
f32); batch norm 1e-6; Tacotron2 outputs atol 1e-5 x max(1, max|JAX
output|) (the postnet's training batch norm over a 4 x 16 batch scales
its inputs' rounding up; its outputs reach ~5), BN state
1e-6, gradients rtol 1e-4 / atol 1e-6; params after a step 1e-5 (but
the conv biases a training batch norm follows: 2 lr, `_feeds_train_bn`);
bf16
loss 1e-2 relative; WaveGlow atol 1e-5, gradients rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fac_via_ppg_tpu.models.tacotron2 as jt
import fac_via_ppg_tpu.models.waveglow as jw
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config as JT2Config
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig as JWGConfig
from fac_via_ppg_tpu.ops.initializers import batchnorm_apply as j_bn
from fac_via_ppg_tpu.train import losses as j_losses
from fac_via_ppg_tpu.train import optim as j_optim
from fac_via_ppg_tpu.train import step as j_step

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.models import tacotron2 as tt
from fac_via_ppg_torch.models import waveglow as tw
from fac_via_ppg_torch.ops.layers import batchnorm_apply
from fac_via_ppg_torch.train import losses as t_losses
from fac_via_ppg_torch.train import optim as t_optim
from fac_via_ppg_torch.train import step as t_step
from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from fac_via_ppg_torch.weights import tacotron2_from_jax, \
    waveglow_train_from_jax

from tests.torch_port_helpers import TINY_T2, record_prenet_masks

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small ops: the suite runs several
    workers on the CPU, and oversubscribed threads slow it manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# scan_unroll 1: the JAX loops compile in a third of the time
J_CFG = JT2Config(**TINY_T2, scan_unroll=1)
T_CFG = Tacotron2Config(**TINY_T2)
WG = dict(n_mel_channels=16, hop_length=64, n_flows=4, n_group=8,
          n_early_every=2, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=256)
J_WG, T_WG = JWGConfig(**WG), WaveGlowConfig(**WG)


def _t(x):
    return torch.as_tensor(np.array(x))


def _pairs(port, ref, path=()):
    """(path, port leaf, JAX leaf) for every leaf of the JAX tree."""
    if isinstance(ref, dict):
        for k in ref:
            yield from _pairs(port[k], ref[k], path + (k,))
    elif isinstance(ref, (list, tuple)):
        for i, r in enumerate(ref):
            yield from _pairs(port[i], r, path + (i,))
    else:
        yield path, port, ref


def _assert_trees_close(port, ref, loose=None, **tol):
    """Every leaf of the port's tree against the JAX tree's leaf at the
    same path; `loose` maps a path to its own atol, or None."""
    n = 0
    for path, a, b in _pairs(port, ref):
        t = dict(tol)
        if loose is not None and loose(path) is not None:
            t["atol"] = loose(path)
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32),
                                   err_msg=str(path), **t)
        n += 1
    assert n


def _t2_batch(seed=0, B=4, T_in=10, T_out=16, in_len=(10, 9, 7, 6),
              out_len=(13, 12, 9, 7)):
    """A bucket-padded batch: lengths below the padded sizes."""
    rng = np.random.RandomState(seed)
    ppg = np.abs(rng.rand(B, J_CFG.n_symbols, T_in)).astype(np.float32)
    mel = (rng.randn(B, 80, T_out) * 0.3).astype(np.float32)
    out_len = np.array(out_len, np.int64)
    valid = np.arange(T_out)[None] < out_len[:, None]
    mel = mel * valid[:, None]
    gate = (np.arange(T_out)[None] >= (out_len - 1)[:, None]).astype(
        np.float32)
    return ppg, np.array(in_len, np.int64), mel, gate, out_len


# ---------------------------------------------------------------- losses

def test_tacotron2_loss_matches_jax_with_bucket_padding():
    rng = np.random.RandomState(1)
    ppg, in_len, mel, gate, out_len = _t2_batch(1)
    out = [(rng.randn(*mel.shape) * 0.5).astype(np.float32) for _ in "ab"]
    gate_out = (rng.randn(*gate.shape) * 3).astype(np.float32)
    gate_out[np.arange(16)[None] >= out_len[:, None]] = 1e3
    want = j_losses.tacotron2_loss(
        (*map(jnp.asarray, out), jnp.asarray(gate_out)),
        (jnp.asarray(mel), jnp.asarray(gate)), 1.0, 0.005,
        output_lengths=jnp.asarray(out_len))
    got = t_losses.tacotron2_loss(
        (*map(_t, out), _t(gate_out)), (_t(mel), _t(gate)), 1.0, 0.005,
        output_lengths=_t(out_len))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    # the padded size is not the denominator
    wider = t_losses.tacotron2_loss(
        (*(_t(np.pad(o, ((0, 0), (0, 0), (0, 16)))) for o in out),
         _t(np.pad(gate_out, ((0, 0), (0, 16)), constant_values=1e3))),
        (_t(np.pad(mel, ((0, 0), (0, 0), (0, 16)))),
         _t(np.pad(gate, ((0, 0), (0, 16)), constant_values=1.0))),
        output_lengths=_t(out_len))
    np.testing.assert_allclose(float(wider), float(got), rtol=1e-6)


def test_waveglow_loss_matches_jax():
    rng = np.random.RandomState(2)
    z = rng.randn(3, 8, 50).astype(np.float32)
    log_s = [rng.randn(3, 4, 50).astype(np.float32) * 0.1 for _ in range(3)]
    log_det = [np.float32(rng.randn()) for _ in range(3)]
    want = j_losses.waveglow_loss(
        (jnp.asarray(z), [jnp.asarray(x) for x in log_s],
         [jnp.asarray(x) for x in log_det]), sigma=0.7071)
    got = t_losses.waveglow_loss(
        (_t(z), [_t(x) for x in log_s], [_t(x) for x in log_det]),
        sigma=0.7071)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip,wd", [(1.0, 1e-3), (None, 0.0), (0.5, 0.0)])
def test_adam_matches_optax_chain(clip, wd):
    """5 steps of the port's Adam against the JAX package's optax chain,
    the learning rate changed between steps, clipping active (the
    gradients' norm is ~10)."""
    rng = np.random.RandomState(3)
    init = {"w": rng.randn(6, 5).astype(np.float32),
            "layers": [{"b": rng.randn(5).astype(np.float32)}]}
    grads = [{"w": rng.randn(6, 5).astype(np.float32) * 2,
              "layers": [{"b": rng.randn(5).astype(np.float32) * 2}]}
             for _ in range(5)]
    j_opt = j_optim.make_optimizer(1e-2, wd, clip)
    j_params = jax.tree.map(jnp.asarray, init)
    j_state = j_opt.init(j_params)
    t_opt = t_optim.make_optimizer(1e-2, wd, clip)
    t_params = tree_map(_t, init)
    t_state = t_opt.init(t_params)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        j_state.hyperparams["learning_rate"] = lr
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state,
                                    j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_optim.set_learning_rate(t_state, lr)
        gnorm = t_opt.apply(t_state, [_t(x) for x in tree_leaves(g)])
        np.testing.assert_allclose(
            float(gnorm), float(j_optim.global_norm(g)), rtol=1e-6)
    _assert_trees_close(t_params, j_params, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule,kw", [
    ("constant", {}),
    ("exponential", dict(decay_steps=7, decay_rate=0.5)),
    ("cosine", dict(decay_steps=9, min_factor=0.1)),
])
@pytest.mark.parametrize("warmup", [0, 4])
def test_lr_schedule_matches_optax(schedule, kw, warmup):
    j = j_optim.make_lr_schedule(3e-4, schedule, warmup_steps=warmup, **kw)
    t = t_optim.make_lr_schedule(3e-4, schedule, warmup_steps=warmup, **kw)
    for step in range(0, 20):
        np.testing.assert_allclose(t(step), j(step), rtol=1e-6, atol=1e-12)


def test_global_norm_matches_jax():
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": [rng.randn(7).astype(np.float32)]}
    np.testing.assert_allclose(
        float(t_optim.global_norm(jax.tree.map(_t, tree))),
        float(j_optim.global_norm(tree)), rtol=1e-6)


# ------------------------------------------------------------ batch norm

@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_apply_matches_jax(training):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 6, 11).astype(np.float32) * 2 + 1
    p = {"weight": rng.rand(6).astype(np.float32) + 0.5,
         "bias": rng.randn(6).astype(np.float32)}
    s = {"running_mean": rng.randn(6).astype(np.float32),
         "running_var": rng.rand(6).astype(np.float32) + 0.5}
    y_j, s_j = j_bn(jax.tree.map(jnp.asarray, p),
                    jax.tree.map(jnp.asarray, s), jnp.asarray(x), training)
    y_t, s_t = batchnorm_apply(jax.tree.map(_t, p), jax.tree.map(_t, s),
                               _t(x), training)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6,
                               rtol=0)
    _assert_trees_close(s_t, s_j, atol=1e-6, rtol=0)


# ------------------------------------------- Tacotron2 teacher-forced forward

@pytest.fixture(scope="module")
def t2_forward():
    """JAX's training forward, loss and gradients on a padded batch, its
    dropout masks recorded; the port's on the same params and masks."""
    params, state = jt.init_tacotron2(jax.random.PRNGKey(0), J_CFG)
    ppg, in_len, mel, gate, out_len = _t2_batch(0)
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)

        def loss_fn(p):
            out, ns = jt.tacotron2_forward(
                J_CFG, p, state, jnp.asarray(ppg), jnp.asarray(in_len),
                jnp.asarray(mel), jnp.asarray(out_len),
                jax.random.PRNGKey(3), training=True)
            loss = j_losses.tacotron2_loss(
                out, (jnp.asarray(mel), jnp.asarray(gate)),
                output_lengths=jnp.asarray(out_len))
            return loss, (out, ns)

        (j_loss, (j_out, j_state)), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.effects_barrier()
    tp, ts = tacotron2_from_jax(params, state)
    batch = tuple(map(_t, (ppg, in_len, mel, gate, out_len)))

    def port_loss(p, remat=False):
        out, ns = tt.tacotron2_forward(
            T_CFG, p, ts, batch[0], batch[1], batch[2], batch[4],
            masks=iter(masks), training=True, remat=remat)
        return t_losses.tacotron2_loss(out, (batch[2], batch[3]),
                                       output_lengths=batch[4]), (out, ns)

    (t_loss, (t_out, t_state)), t_grads = t_step.value_and_grad(port_loss,
                                                                tp)
    return dict(masks=masks, j_loss=j_loss, j_out=j_out, j_state=j_state,
                j_grads=j_grads, t_loss=t_loss, t_out=t_out,
                t_state=t_state, t_grads=tree_unflatten(tp, t_grads),
                port_loss=port_loss, tp=tp)


def test_tacotron2_forward_consumes_every_recorded_mask(t2_forward):
    # 2 encoder prenet + 3 convs + 2 decoder prenet + 4 a step + 5 postnet
    assert len(t2_forward["masks"]) == 2 + 3 + 2 + 4 * 16 + 5


@pytest.mark.parametrize("i,name", [(0, "mel"), (1, "mel_postnet"),
                                    (2, "gate"), (3, "alignments")])
def test_tacotron2_forward_outputs_match_jax(t2_forward, i, name):
    got = t2_forward["t_out"][i].detach().numpy()
    want = np.asarray(t2_forward["j_out"][i])
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(np.where(want == 1e3, 0, want)).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_tacotron2_forward_loss_and_bn_state_match_jax(t2_forward):
    np.testing.assert_allclose(float(t2_forward["t_loss"]),
                               float(t2_forward["j_loss"]), rtol=1e-6)
    _assert_trees_close(t2_forward["t_state"], t2_forward["j_state"],
                        atol=1e-6, rtol=0)


def test_tacotron2_forward_gradients_match_jax(t2_forward):
    _assert_trees_close(t2_forward["t_grads"], t2_forward["j_grads"],
                        rtol=1e-4, atol=1e-6)


def test_tacotron2_remat_equals_no_remat(t2_forward):
    """Each decoder step recomputed in the backward pass from its carry
    and its pre-drawn masks: the same loss and gradients."""
    f = t2_forward
    (loss, _), grads = t_step.value_and_grad(
        lambda p: f["port_loss"](p, remat=True), f["tp"])
    assert float(loss) == float(f["t_loss"])
    for a, b in zip(grads, tree_leaves(f["t_grads"])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_tacotron2_eval_forward_keeps_state_and_drops_prenet_only():
    params, state = tt.init_tacotron2(T_CFG, torch.Generator().manual_seed(0))
    ppg, in_len, mel, gate, out_len = map(_t, _t2_batch(6))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in "ab")
    out1, s1 = tt.tacotron2_forward(T_CFG, params, state, ppg, in_len, mel,
                                    out_len, generator=g1, training=False)
    out2, _ = tt.tacotron2_forward(T_CFG, params, state, ppg, in_len, mel,
                                   out_len, generator=g2, training=False)
    assert s1["encoder"]["convolutions"][0] is \
        state["encoder"]["convolutions"][0]
    for a, b in zip(out1, out2):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------- Tacotron2 steps

LR = 1e-3


def _feeds_train_bn(path):
    """A conv bias that a training-mode batch norm follows: its gradient
    is zero but for rounding (the batch mean takes it out), and Adam's
    first update maps any g to lr * g / (|g| + eps), so the two packages'
    rounding noise moves it by up to 2 lr in either direction."""
    if path[0] in ("encoder", "postnet") and path[-2:] == ("conv", "bias"):
        return 2 * LR
    return None


class _SGD:
    """params -= grads, the port-side twin of optax.sgd(1.0): a step's
    params then show its gradients, value for value."""

    def init(self, params):
        return tree_leaves(params)

    def apply(self, leaves, grads):
        for p, g in zip(leaves, grads):
            p.sub_(g)
        return t_optim.global_norm(grads)


def _jax_t2_step(batch, grad_accum=1, compute_dtype=None, sgd=False):
    """One JAX train step from seeded params; returns (its StepOut, the
    masks it drew, the params and state before)."""
    params, state = jt.init_tacotron2(jax.random.PRNGKey(1), J_CFG)
    opt = optax.sgd(1.0) if sgd else j_optim.make_optimizer(LR, 1e-6, 1.0)
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        step = j_step.make_tacotron2_train_step(
            J_CFG, opt, donate=False, compute_dtype=compute_dtype,
            grad_accum=grad_accum)
        out = step(params, state, opt.init(params),
                   tuple(map(jnp.asarray, batch)), jax.random.PRNGKey(9))
        jax.effects_barrier()
    return out, masks, params, state


def _port_t2_step(params, state, batch, masks, sgd=False, **kw):
    tp, ts = tacotron2_from_jax(params, state)
    opt = _SGD() if sgd else t_optim.make_optimizer(LR, 1e-6, 1.0)
    step = t_step.make_tacotron2_train_step(T_CFG, opt, **kw)
    return step(tp, ts, opt.init(tp), tuple(map(_t, batch)), masks=masks)


@pytest.mark.parametrize("opt,grad_accum", [("adam", 1), ("sgd", 2)])
def test_tacotron2_train_step_matches_jax(opt, grad_accum):
    """A whole step (forward, loss, gradients, the optimizer), and with
    grad_accum=2 JAX's strided micro-batches, the BN state threaded.
    With SGD(1) the params after the step show the gradients themselves
    (Adam's first update is lr * sign(g) wherever |g| >> eps)."""
    sgd = opt == "sgd"
    batch = _t2_batch(7)
    j_out, masks, params, state = _jax_t2_step(batch, grad_accum, sgd=sgd)
    t_out = _port_t2_step(params, state, batch, masks, sgd=sgd,
                          grad_accum=grad_accum)
    np.testing.assert_allclose(float(t_out.loss), float(j_out.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_out.grad_norm),
                               float(j_out.grad_norm), rtol=1e-4)
    _assert_trees_close(t_out.params, j_out.params,
                        loose=None if sgd else _feeds_train_bn,
                        atol=1e-5, rtol=0)
    _assert_trees_close(t_out.model_state, j_out.model_state, atol=1e-5,
                        rtol=0)


def test_tacotron2_bf16_train_step_matches_jax():
    """train_dtype bfloat16: params and inputs cast inside the
    differentiated function; f32 gradients, optimizer and BN state."""
    batch = _t2_batch(8)
    j_out, masks, params, state = _jax_t2_step(batch,
                                               compute_dtype=jnp.bfloat16)
    t_out = _port_t2_step(params, state, batch, masks,
                          compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(t_out.loss), float(j_out.loss),
                               rtol=1e-2)
    for leaf in tree_leaves(t_out.params) + tree_leaves(t_out.model_state):
        assert leaf.dtype == torch.float32 and torch.isfinite(leaf).all()


def test_split_micro_is_strided_and_checks_divisibility():
    x = torch.arange(6)
    micro = t_step._split_micro((x, x * 10), 2)
    assert [m[0].tolist() for m in micro] == [[0, 2, 4], [1, 3, 5]]
    ref = j_step._split_micro((np.arange(6),), 2)[0]
    assert [m[0].tolist() for m in micro] == np.asarray(ref).tolist()
    with pytest.raises(ValueError, match="must divide"):
        t_step._split_micro((x,), 4)


# -------------------------------------------------------------- WaveGlow

@pytest.fixture(scope="module")
def wg_setup():
    params = jw.init_waveglow(jax.random.PRNGKey(2), J_WG)
    # the end convs are zero at init (identity couplings): give them
    # weights so that the coupling nets reach the loss
    rng = np.random.RandomState(9)
    params = jax.tree.map(lambda x: x, params)
    for wn in params["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*wn["end"]["weight"].shape).astype(np.float32) * 0.05)
    mel = (rng.randn(4, 16, 12) * 0.5).astype(np.float32)
    audio = (rng.randn(4, 12 * 64) * 0.2).astype(np.float32)
    return params, mel, audio


def test_waveglow_forward_and_gradients_match_jax(wg_setup):
    params, mel, audio = wg_setup

    def j_loss(p):
        out = jw.waveglow_forward(J_WG, p, jnp.asarray(mel),
                                  jnp.asarray(audio))
        return j_losses.waveglow_loss(out, sigma=0.7), out

    (jl, j_out), j_grads = jax.jit(jax.value_and_grad(j_loss,
                                                      has_aux=True))(params)
    tp = waveglow_train_from_jax(params)

    def t_loss(p):
        out = tw.waveglow_forward(T_WG, p, _t(mel), _t(audio))
        return t_losses.waveglow_loss(out, sigma=0.7), out

    (tl, t_out), t_grads = t_step.value_and_grad(t_loss, tp)
    np.testing.assert_allclose(t_out[0].detach().numpy(),
                               np.asarray(j_out[0]), atol=1e-5, rtol=0)
    for a, b in zip(t_out[1], j_out[1]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=0)
    for a, b in zip(t_out[2], j_out[2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_trees_close(tree_unflatten(tp, t_grads), j_grads, rtol=1e-4,
                        atol=1e-6)


def test_waveglow_train_step_matches_jax(wg_setup):
    params, mel, audio = wg_setup
    j_opt = j_optim.make_optimizer(1e-3)
    j_out = j_step.make_waveglow_train_step(J_WG, j_opt, 0.7, donate=False)(
        params, j_opt.init(params), (jnp.asarray(mel), jnp.asarray(audio)))
    tp = waveglow_train_from_jax(params)
    t_opt = t_optim.make_optimizer(1e-3)
    t_out = t_step.make_waveglow_train_step(T_WG, t_opt, 0.7)(
        tp, t_opt.init(tp), (_t(mel), _t(audio)))
    np.testing.assert_allclose(float(t_out.loss), float(j_out.loss),
                               rtol=1e-5)
    _assert_trees_close(t_out.params, j_out.params, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["grad_accum", "remat"])
def test_waveglow_step_variants_equal_the_plain_step(wg_setup, variant):
    """grad_accum=2 against the full batch (the step draws nothing at
    random, so only the order of the sums differs), and remat against no
    remat (the same ops replayed); with SGD(1), so that the params after
    the step show the gradients (Adam's first update would be their
    signs)."""
    params, mel, audio = wg_setup
    batch = (_t(mel), _t(audio))
    outs = []
    for kw in ({}, {"grad_accum": 2} if variant == "grad_accum"
               else {"remat": True}):
        tp = waveglow_train_from_jax(params)
        opt = _SGD()
        outs.append(t_step.make_waveglow_train_step(T_WG, opt, 0.7, **kw)(
            tp, opt.init(tp), batch))
    np.testing.assert_allclose(float(outs[1].loss), float(outs[0].loss),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(outs[1].params),
                    tree_leaves(outs[0].params)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_weight_norm_params_fold_back():
    """The train form made from the folded form folds back to it (8 ulp:
    the norm is recomputed)."""
    g = torch.Generator().manual_seed(3)
    folded = tw.init_waveglow(T_WG, g)
    train = tw.weight_norm_params(folded)
    assert set(train["wn"][0]["in_layers"][0]) == {"g", "v", "bias"}
    assert set(train["wn"][0]["end"]) == {"weight", "bias"}
    from fac_via_ppg_torch.weights import fold_waveglow

    for a, b in zip(tree_leaves(fold_waveglow(train)), tree_leaves(folded)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
