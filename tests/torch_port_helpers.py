"""Shared pieces of the port's CPU tests (tests/test_torch_port_*.py).

Importing this module imports torch and the port only: the ranks that the
multi-process tests spawn (`run_ranks`) import it, and they must not load
JAX.  `record_prenet_masks` imports JAX when it is called."""

import numpy as np
import torch

from fac_via_ppg_torch.parallel import spawn

# A Tacotron2 narrow enough for the CPU (the shape of tests/test_fused.py's).
TINY_T2 = dict(
    n_symbols=16, symbols_embedding_dim=16, encoder_embedding_dim=16,
    decoder_rnn_dim=12, prenet_dim=8, attention_rnn_dim=12,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    max_decoder_steps=20,
)


def record_prenet_masks(monkeypatch):
    """Replace the JAX Tacotron2's dropout with one that draws the same
    bits and records each enabled keep-mask in call order, through an
    ordered host callback, so that jitted loops record every step.  Call
    `jax.effects_barrier()` before reading the list.

    Every dropout call of the JAX Tacotron2 module goes through it: at
    inference the prenet's alone; in training (`tacotron2_forward`,
    `training=True`) also the encoder convs', the attention and decoder
    LSTM states' (4 a step) and the postnet's, in the order the port's
    `masks=` takes them."""
    import jax
    import jax.numpy as jnp

    import fac_via_ppg_tpu.models.tacotron2 as jax_tacotron2

    masks = []

    def dropout(key, x, rate, enabled):
        if not enabled or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = jax.random.bernoulli(key, keep, x.shape)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask,
                           ordered=True)
        return jnp.where(mask, x / keep, 0.0)

    monkeypatch.setattr(jax_tacotron2, "dropout", dropout)
    return masks


# ------------------------------------------------ multi-process (gloo) runs

RANK_TIMEOUT_S = 120


def run_ranks(world, tmp_dir, fn, *args, timeout=RANK_TIMEOUT_S * 2,
              backend="gloo", device="cpu"):
    """`fn(rank, world, *args)` in `world` spawned processes joined in one
    group (parallel/spawn.py: gloo on the CPU by default, a file:// store
    under `tmp_dir`, never a TCP port), one intra-op thread a rank;
    returns each rank's result, in rank order.  A rank's failure or the
    timeout fails the call, with the ranks' tracebacks."""
    return spawn.run_ranks(world, fn, *args, backend=backend, device=device,
                           tmp_dir=str(tmp_dir), timeout=timeout, threads=1,
                           collective_timeout=RANK_TIMEOUT_S)


# ------------------------------------------------ rank scenarios: the mesh

def rank_fails(rank, world):
    """Rank 1 raises; the others wait in a barrier for it."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def rank_mesh_checks(rank, world):
    """The meshes of a `world`-rank job and their collectives: returns what
    each shape's mesh says of this rank and what its groups computed."""
    import torch.distributed as dist

    from fac_via_ppg_torch.parallel import mesh as pm

    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for model in (1, 2) if world % 2 == 0 else (1,):
        m = pm.make_mesh(model=model, device="cpu")
        assert pm.make_mesh(model=model, device="cpu") is m  # reused
        x = torch.tensor([float(rank)])
        data_sum = pm.all_reduce(x.clone(), m.data_group).item()
        model_sum = pm.all_reduce(x.clone(), m.model_group).item()
        # a batch of 5 rows padded to the data axis; every rank's rows
        batch = torch.arange(5 * 3, dtype=torch.int16).view(5, 3)
        mine = pm.shard_batch(m, batch)
        back = pm.gather_rows(m, mine, 5)
        tree = {"w": torch.full((2, 2), float(rank))}
        pm.replicate(m, tree)
        out[model] = {
            "shape": dict(m.shape), "data_rank": m.data_rank,
            "model_rank": m.model_rank, "data_sum": data_sum,
            "model_sum": model_sum, "rows": mine.tolist(),
            "gathered": back.tolist(), "gathered_dtype": str(back.dtype),
            "replicated": tree["w"].tolist()}
    return out


def rank_collectives(rank, world, device):
    """The collectives the port relies on, on this rank's device (its
    process group's backend): all_reduce (sum, max; f32, bf16, int16),
    all_gather of int16 rows, broadcast, and the autograd all-reduce of
    the global batch norm with its gradient."""
    import torch.distributed as dist

    from fac_via_ppg_torch.ops.layers import batchnorm_apply
    from fac_via_ppg_torch.parallel import mesh as pm

    m = pm.make_mesh(device=device)
    dev = m.device
    out = {"backend": dist.get_backend(), "device": str(dev)}
    x = torch.full((3,), float(rank + 1), device=dev)
    out["sum"] = pm.all_reduce(x, m.data_group).tolist()
    out["max"] = pm.all_reduce(torch.tensor([rank], device=dev),
                               m.data_group, op=dist.ReduceOp.MAX).item()
    out["bf16"] = pm.all_reduce(torch.full((2,), 1.5, device=dev,
                                           dtype=torch.bfloat16),
                                m.data_group).float().tolist()
    out["int16"] = pm.all_reduce(torch.full((2,), 7, device=dev,
                                            dtype=torch.int16),
                                 m.data_group).tolist()
    rows = torch.arange(4, dtype=torch.int16, device=dev).view(2, 2) + rank
    out["gather"] = pm.gather_rows(m, rows, 2 * world).tolist()
    tree = {"w": torch.full((2,), float(rank), device=dev)}
    out["bcast"] = pm.replicate(m, tree)["w"].tolist()
    g = torch.Generator().manual_seed(rank)
    xb = torch.randn((2, 3, 5), generator=g).to(dev).requires_grad_()
    p = {"weight": torch.ones(3, device=dev), "bias": torch.zeros(3,
                                                                device=dev)}
    st = {"running_mean": torch.zeros(3, device=dev),
          "running_var": torch.ones(3, device=dev)}
    y, new = batchnorm_apply(p, st, xb, True, group=m.data_group)
    (grad,) = torch.autograd.grad((y * torch.arange(5, device=dev)).sum(),
                                  xb)
    out["bn"] = (xb.detach().cpu().numpy(), y.detach().cpu().numpy(),
                 grad.cpu().numpy(), new["running_var"].cpu().numpy())
    return out


def check_collectives(res, world):
    """What `rank_collectives` computed on `world` ranks, against the
    arithmetic and against one process's batch norm on the concatenated
    batch (forward, gradient, running variance: 1e-5)."""
    from fac_via_ppg_torch.ops.layers import batchnorm_apply

    xs = torch.cat([torch.as_tensor(r["bn"][0]) for r in res])
    xs.requires_grad_()
    p = {"weight": torch.ones(3), "bias": torch.zeros(3)}
    st = {"running_mean": torch.zeros(3), "running_var": torch.ones(3)}
    y, new = batchnorm_apply(p, st, xs, True)
    (grad,) = torch.autograd.grad((y * torch.arange(5)).sum(), xs)
    total = sum(range(1, world + 1))
    for rank, r in enumerate(res):
        assert r["sum"] == [float(total)] * 3 and r["max"] == world - 1
        assert r["bf16"] == [1.5 * world] * 2
        assert r["int16"] == [7 * world] * 2
        assert r["gather"] == [[i + k, i + 1 + k] for k in range(world)
                               for i in (0, 2)]
        assert r["bcast"] == [0.0, 0.0]
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(r["bn"][1], y[rows].detach().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(r["bn"][2], grad[rows].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(r["bn"][3], new["running_var"].numpy(),
                                   atol=1e-6)


def rank_shard_roundtrip(rank, world, tree):
    """apply_shardings then gather_shards over every mesh shape of the job,
    under the paired WN rule, ZeRO-1 and both: this rank's slices' shapes
    and whether the gathered tree is the original, bit for bit."""
    from fac_via_ppg_torch.parallel import sharding as ps
    from fac_via_ppg_torch.parallel.mesh import make_mesh
    from fac_via_ppg_torch.utils.tree import tree_leaves

    specs_of = {
        "waveglow": ps.waveglow_param_shardings,
        "zero": ps.optimizer_state_shardings,
        "zero_tp": lambda m, t: ps.optimizer_state_shardings(
            m, t, param_spec_fn=ps.waveglow_spec_fn(m)),
    }
    out = {}
    for model in (1, 2) if world % 2 == 0 else (1,):
        m = make_mesh(model=model, device="cpu")
        for name, fn in specs_of.items():
            specs = fn(m, tree)
            local = ps.apply_shardings(tree, specs, m)
            full = ps.gather_shards(local, specs, m)
            out[(model, name)] = {
                "shapes": [tuple(x.shape) for x in tree_leaves(local)],
                "equal": all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(full), tree_leaves(tree)))}
    return out


def rank_wn_tp(rank, world, cfg, params, audio, spect, packed_cond):
    """One coupling net and a whole vocoder call on each model-parallel
    mesh of the job, against the dense conv formulation on the same
    inputs (float64, so only the order of the sums differs)."""
    from fac_via_ppg_torch.models import waveglow as tw
    from fac_via_ppg_torch.parallel.mesh import collectives, make_mesh

    out = {}
    for model in (2, 4):
        if world % model:
            continue
        m = make_mesh(model=model, device="cpu")
        local = tw.tp_shard_waveglow(params, m)
        with torch.no_grad():
            n0 = collectives["all_reduce"]
            got = tw.wn_apply(cfg, local["wn"][0], audio, spect,
                              model_group=m.model_group)
            n_wn = collectives["all_reduce"] - n0
            want = tw.wn_apply(cfg, params["wn"][0], audio, spect)
            mel = spect[:, :cfg.n_mel_channels, :4]
            g = torch.Generator().manual_seed(3)
            n0 = collectives["all_reduce"]
            a_tp = tw.waveglow_infer(cfg, params, mel, 0.6, g,
                                     wn_impl="conv", mesh=m)
            n_call = collectives["all_reduce"] - n0
            g = torch.Generator().manual_seed(3)
            a_dense = tw.waveglow_infer(cfg, params, mel, 0.6, g,
                                        wn_impl="conv")
            # int8 cond against dense, both tensor parallel, in f32
            p32 = tw.cast_params(params, torch.float32)
            local32 = tw.tp_shard_waveglow(p32, m)
            pk = tw.tp_shard_int8cond(cfg, packed_cond, m)
            runs = {}
            for impl in ("dense", "int8"):
                g = torch.Generator().manual_seed(3)
                runs[impl] = tw.waveglow_infer(
                    cfg, p32, mel.float(), 0.6, g, wn_impl="conv",
                    cond_impl=impl, packed_cond=pk, packed_wn=local32,
                    mesh=m).numpy()
        out[model] = {"wn_err": float((got - want).abs().max()),
                      "wn_scale": float(want.abs().max()),
                      "wn_all_reduces": n_wn,
                      "call_err": float((a_tp - a_dense).abs().max()),
                      "call_scale": float(a_dense.abs().max()),
                      "call_all_reduces": n_call,
                      "int8": runs["int8"], "dense_tp": runs["dense"],
                      "in_rows": tuple(local["wn"][0]["in_layers"][0]
                                       ["weight"].shape),
                      "rs_shape": tuple(local["wn"][0]["res_skip_layers"]
                                        [0]["weight"].shape)}
    return out


# ----------------------------------------------- rank scenarios: serving

def whole_prenet_masks(t2_params, B, T_in, M):
    """Every inference prenet keep-mask of a batch of B (call order), all
    kept: with the prenet weights halved (`halve_prenet`), dropout is the
    identity, as the JAX tests' patched dropout."""
    enc = [torch.ones((B, T_in, layer["weight"].shape[0]), dtype=torch.bool)
           for layer in t2_params["encoder"]["prenet"]["layers"]]
    dec = [torch.ones((B, layer["weight"].shape[0]), dtype=torch.bool)
           for _ in range(M)
           for layer in t2_params["decoder"]["prenet"]["layers"]]
    return enc + dec


def halve_prenet(t2_params):
    """The prenet layers' weights halved (bias-free layers): relu(y / 2) / 0.5
    = relu(y), so every unit kept is no dropout at all."""
    out = dict(t2_params)
    for part in ("encoder", "decoder"):
        out[part] = dict(t2_params[part])
        out[part]["prenet"] = {"layers": [
            {k: v / 2 for k, v in layer.items()}
            for layer in t2_params[part]["prenet"]["layers"]]}
    return out


def fused_synth(setup, mesh_model=None, **kw):
    """The port's FusedSynthesizer at the serve tests' tiny widths, on the
    CPU; `mesh_model` makes it data parallel over the job with that model
    axis."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.eval.fused import FusedSynthesizer
    from fac_via_ppg_torch.frontend import ppg as t_ppg

    par = {} if mesh_model is None else dict(data_parallel=True,
                                             model_parallel=mesh_model)
    t2 = kw.pop("t2_params", setup["t2_params"])
    return FusedSynthesizer(
        Tacotron2Config(**setup["t2_cfg"]), t2, setup["t2_state"],
        WaveGlowConfig(**setup["wg_cfg"]), setup["wg_params"],
        deps=t_ppg.DependenciesPPG(**setup["deps"]),
        max_frames=setup["max_frames"], device="cpu", serving_dtype=None,
        **par, **kw)


def serve_both_ways(setup, mesh_model, pad_to):
    """(a) sigma 0.6, masks and noise drawn from a seeded generator;
    (b) sigma 0, the prenet kept whole: each a list of int16 PCM arrays."""
    pairs = setup["pairs"]
    a = fused_synth(setup, mesh_model, sigma=0.6).synthesize_feature_pairs(
        pairs, torch.Generator().manual_seed(5), pad_batch_to=pad_to)
    t_in = max(f.shape[0] for f, _ in pairs)
    masks = whole_prenet_masks(setup["t2_params"], pad_to, t_in,
                               setup["max_frames"])
    b = fused_synth(setup, mesh_model, sigma=0.0,
                    t2_params=halve_prenet(setup["t2_params"])
                    ).synthesize_feature_pairs(
        pairs, torch.Generator().manual_seed(5), pad_batch_to=pad_to,
        dropout_masks=masks)
    return a, b


def rank_serve(rank, world, setup):
    """The fused batch data parallel over every rank (model 1) and, on 4
    ranks, 2 data x 2 model; per layout both ways of `serve_both_ways`."""
    out = {}
    for model in (1, 2) if world == 4 else (1,):
        out[model] = serve_both_ways(setup, model, setup["pad_to"])
    return out


def rank_vocoder_cli(rank, world, runs):
    """The vocoder CLI (scripts/waveglow_inference.main) once per entry of
    `runs` (keyword arguments), every rank; rank 0 writes the wavs."""
    from fac_via_ppg_torch.scripts import waveglow_inference

    return [waveglow_inference.main(device="cpu", **kw)["audio_s"]
            for kw in runs]


# ----------------------------------------------- rank scenarios: training

def capture_optimizer(lr=1e-3, wd=1e-6, clip=1.0):
    """The port's Adam that also keeps copies of the gradients its `apply`
    receives (after any data-parallel averaging, before the clip)."""
    from fac_via_ppg_torch.train.optim import Optimizer

    class Capture(Optimizer):
        grads = None

        def apply(self, opt_state, grads):
            self.grads = [g.detach().clone() for g in grads]
            return super().apply(opt_state, grads)

    return Capture(lr, wd, clip)


def _copy(tree):
    from fac_via_ppg_torch.utils.tree import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _rows(batch, rank, world):
    b = batch[0].shape[0] // world
    return tuple(torch.as_tensor(np.asarray(x[rank * b:(rank + 1) * b]))
                 for x in batch)


def tp_layout(kind, setup, mesh, thresholds=(16, 64)):
    """The tensor-parallel layout of the setup's Tacotron2 ("t2"; the JAX
    tests' lowered thresholds by default, so that every clause fires) or
    WaveGlow ("wg", the paired rule on the train form) on `mesh`."""
    from fac_via_ppg_torch.parallel import sharding as ps
    from fac_via_ppg_torch.parallel.tp import TensorParallel

    if kind == "t2":
        specs = ps.tacotron2_param_shardings(mesh, setup["t2_params"],
                                             *thresholds)
    else:
        specs = ps.waveglow_param_shardings(mesh, setup["wg_params"])
    return TensorParallel(mesh, specs)


def train_step_out(kind, setup, batch, mesh=None, masks=None, zero=False,
                   steps=1, tp=None, clip=1.0, lr=1e-3):
    """`steps` train steps of Tacotron2 (`kind` "t2") or WaveGlow ("wg")
    from the setup's params on `batch` (this rank's rows), with
    capture_optimizer: (losses, the last step's gradients, grad norm, BN
    state, params after).  Under a tensor-parallel layout `tp` the
    gradients and params come back gathered whole, with this rank's
    replicated leaves after the steps (`replicated`), the collectives of
    the last step (`collectives`) and the optimizer's moment records."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.parallel.mesh import collectives
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.utils.tree import tree_leaves, tree_unflatten

    opt = capture_optimizer(lr=lr, clip=clip)
    if kind == "t2":
        params, state = _copy(setup["t2_params"]), _copy(setup["t2_state"])
        step = t_step.make_tacotron2_train_step(
            Tacotron2Config(**setup["t2_cfg"]), opt, mesh=mesh, tp=tp)
    else:
        params, state = _copy(setup["wg_params"]), None
        step = t_step.make_waveglow_train_step(
            WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh,
            tp=tp)
    if tp is not None:
        params = tp.shard(params)
    opt_state = opt.init(params, mesh=mesh, zero=zero, tp=tp)
    losses, out = [], None
    for _ in range(steps):
        n0 = dict(collectives)
        if kind == "t2":
            out = step(params, state, opt_state, batch, masks=masks)
            state = out.model_state
        else:
            out = step(params, opt_state, batch)
        losses.append(float(out.loss))
    res = {"losses": losses, "grad_norm": float(out.grad_norm),
           "state": None if state is None else [
               x.numpy() for x in tree_leaves(state)],
           "opt_state": opt_state}
    grads = opt.grads
    if tp is not None:
        res["collectives"] = {k: collectives[k] - n0[k] for k in n0}
        res["replicated"] = [x.numpy().copy() for x, s in zip(
            tree_leaves(params), tp.sharded) if not s]
        res["moment_specs"] = opt_state.specs
        grads = tree_leaves(tp.gather(tree_unflatten(params, grads)))
        params = tp.gather(params)
    res["grads"] = [g.numpy() for g in grads]
    res["params"] = [x.numpy() for x in tree_leaves(params)]
    return res


def rank_train_steps(rank, world, setup, ckpt_path):
    """On `world` data-parallel ranks: one Tacotron2 step (the global
    batch's masks injected) and one WaveGlow step on this rank's rows;
    three steps of each with and without ZeRO-1; a WaveGlow ZeRO-1 run of
    two steps saved to `ckpt_path`, then its third step's loss."""
    from fac_via_ppg_torch.parallel.mesh import make_mesh
    from fac_via_ppg_torch.train import checkpoint as ckpt

    mesh = make_mesh(device="cpu")
    t2_b = _rows(setup["t2_batch"], rank, world)
    wg_b = _rows(setup["wg_batch"], rank, world)
    out = {"t2": train_step_out("t2", setup, t2_b, mesh, setup["masks"]),
           "wg": train_step_out("wg", setup, wg_b, mesh)}
    for kind, b in (("t2", t2_b), ("wg", wg_b)):
        runs = [train_step_out(kind, setup, b, mesh, setup["masks"],
                               zero=z, steps=3) for z in (False, True)]
        out[f"zero_{kind}"] = {
            "bit_equal": all(np.array_equal(a, c) for a, c in zip(
                runs[0]["params"], runs[1]["params"])),
            "losses": runs[1]["losses"],
            "moments_sharded": sum(
                st["exp_avg"].numel() for st in
                runs[1]["opt_state"].adam.state_dict()["state"].values())
            < sum(p.size for p in runs[1]["params"])}
    # a ZeRO-1 checkpoint after two steps, then the third step
    res = zero_run(setup, mesh, rank, world, steps=2)
    ckpt.save_checkpoint(ckpt_path, res["params"], res["opt_state"], 1e-3,
                         1, mesh=mesh)
    out["resume"] = zero_resume(setup, ckpt_path, mesh, rank, world)
    for k in ("t2", "wg"):
        out[k].pop("opt_state")
    return out


def zero_run(setup, mesh, rank, world, steps):
    """WaveGlow with ZeRO-1: `steps` steps on the setup's batches."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.train.optim import make_optimizer

    opt = make_optimizer(1e-3)
    params = _copy(setup["wg_params"])
    step = t_step.make_waveglow_train_step(
        WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh)
    opt_state = opt.init(params, mesh=mesh, zero=True)
    for i in range(steps):
        step(params, opt_state, _rows(setup["wg_batches"][i], rank, world))
    return {"params": params, "opt_state": opt_state}


def zero_resume(setup, path, mesh, rank, world):
    """The checkpoint at `path` read back with ZeRO-1 on this mesh (plain
    Adam without one), then one step on the setup's third batch: its loss
    and the params after it."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.utils.tree import tree_leaves

    payload = ckpt.load_checkpoint(path)
    opt = make_optimizer(1e-3)
    params = payload["params"]
    opt_state = opt.init(params, mesh=mesh, zero=mesh is not None)
    opt_state.load_state_dict(payload["opt_state"])
    step = t_step.make_waveglow_train_step(
        WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh)
    out = step(params, opt_state, _rows(setup["wg_batches"][2], rank, world))
    return {"loss": float(out.loss),
            "params": [x.numpy() for x in tree_leaves(params)]}


def rank_zero_resume(rank, world, setup, path):
    from fac_via_ppg_torch.parallel.mesh import make_mesh

    return zero_resume(setup, path, make_mesh(device="cpu"), rank, world)


def rank_trainers(rank, world, ppg2mel_run, deps, waveglow_config):
    """Both trainers' main() on every rank, ZeRO-1 on: (stdout, the last
    iteration, the final params) of each."""
    import contextlib
    import io

    from fac_via_ppg_torch.data import ppg_mel_dataset as ds_mod
    from fac_via_ppg_torch.frontend.ppg import DependenciesPPG
    from fac_via_ppg_torch.scripts import train_ppg2mel, train_waveglow
    from fac_via_ppg_torch.utils.tree import tree_leaves

    the_deps = DependenciesPPG(**deps)
    ds_mod.DependenciesPPG = lambda: the_deps
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, _, _, it = train_ppg2mel.main(
            device="cpu", epochs=2, iters_per_checkpoint=2,
            zero_sharded_opt_state=True, **ppg2mel_run)
    out["ppg2mel"] = (buf.getvalue(), it,
                      [x.numpy() for x in tree_leaves(params)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, _, it = train_waveglow.main(
            waveglow_config, device="cpu", epochs=2, iters_per_checkpoint=2,
            zero_sharded_opt_state=True, data_parallel_devices=world)
    out["waveglow"] = (buf.getvalue(), it,
                       [x.numpy() for x in tree_leaves(params)])
    return out


# ------------------------------------ rank scenarios: tensor parallelism

def rank_tp_collectives(mesh, seed=0):
    """The three autograd collectives on this rank (parallel/tp.py), each
    on the rank's part of one unsharded op, its forward output and its
    input's gradient; `tp_collectives_one_process` computes the same op
    whole in one process."""
    from fac_via_ppg_torch.parallel.tp import (
        copy_to_model,
        gather_from_model,
        reduce_from_model,
    )

    g = torch.Generator().manual_seed(seed)
    x, w, c = (torch.randn((3, 8), generator=g),
               torch.randn((6, 8), generator=g),
               torch.randn((3, 6), generator=g))
    m, r, grp = mesh.shape["model"], mesh.model_rank, mesh.model_group
    out = {}
    # copy: the input to a column split (rank r holds rows of w)
    rows = slice(r * 6 // m, (r + 1) * 6 // m)
    xi = x.clone().requires_grad_()
    y = copy_to_model(xi, grp) @ w[rows].T
    (y * c[:, rows]).sum().backward()
    out["copy"] = (y.detach().numpy(), xi.grad.numpy())
    # reduce: a contraction split (rank r holds columns of w)
    cols = slice(r * 8 // m, (r + 1) * 8 // m)
    wi = w[:, cols].clone().requires_grad_()
    y = reduce_from_model(x[:, cols] @ wi.T, grp)
    (y * c).sum().backward()
    out["reduce"] = (y.detach().numpy(), wi.grad.numpy())
    # gather: an output split along dim 1
    xi = (x @ w.T)[:, rows].clone().requires_grad_()
    y = gather_from_model(xi, grp, 1)
    (y * c).sum().backward()
    out["gather"] = (y.detach().numpy(), xi.grad.numpy())
    return out


LSTM_SPLITS = {"both": ("weight_ih", "weight_hh"), "ih": ("weight_ih",),
               "hh": ("weight_hh",)}


def _lstm_case(seed=1):
    from fac_via_ppg_torch.ops.layers import lstm_params

    g = torch.Generator().manual_seed(seed)
    p = lstm_params(g, 6, 4)
    x, h, c = (torch.randn((3, 6), generator=g),
               torch.randn((3, 4), generator=g),
               torch.randn((3, 4), generator=g))
    up = torch.randn((2, 3, 4), generator=g)
    return p, x, h, c, up


def lstm_cell_grads(p, x, h, c, up, x_proj=False):
    """One lstm_cell step (its input projection up front with `x_proj`,
    as ops/rnn.py runs it): (h', c') and the gradients of x, h and every
    leaf of `p` against the upstream `up`."""
    from fac_via_ppg_torch.ops.layers import lstm_cell, lstm_input_proj

    names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    leaves = {k: p[k].clone().requires_grad_() for k in names}
    q = dict(leaves, **({"tp": p["tp"]} if "tp" in p else {}))
    xi, hi = x.clone().requires_grad_(), h.clone().requires_grad_()
    proj = lstm_input_proj(q, xi) if x_proj else None
    hn, cn = lstm_cell(q, xi, hi, c, x_proj=proj)
    grads = torch.autograd.grad((hn * up[0]).sum() + (cn * up[1]).sum(),
                                [xi, hi] + [leaves[k] for k in names])
    return [t.detach().numpy() for t in (hn, cn, *grads)]


def rank_tp_lstm(mesh):
    """lstm_cell with each gate stack split on its own or both, with and
    without the input projection up front, on this rank's rows of the
    split stacks: (h', c') and the gradients (the split stacks' this
    rank's rows)."""
    from fac_via_ppg_torch.parallel.tp import Split

    m, r = mesh.shape["model"], mesh.model_rank
    p, x, h, c, up = _lstm_case()
    out = {}
    for case, names in LSTM_SPLITS.items():
        q = dict(p)
        for k in names:
            n = p[k].shape[0] // m
            q[k] = p[k][r * n:(r + 1) * n]
        q["tp"] = Split(mesh.model_group, r, {k: "out" for k in names})
        for proj in (False, True):
            out[(case, proj)] = lstm_cell_grads(q, x, h, c, up, proj)
    return out


def tp_collectives_one_process(seed=0):
    """`rank_tp_collectives`' ops whole: (output, the whole input's
    gradient) of each."""
    g = torch.Generator().manual_seed(seed)
    x, w, c = (torch.randn((3, 8), generator=g),
               torch.randn((6, 8), generator=g),
               torch.randn((3, 6), generator=g))
    out = {}
    xi = x.clone().requires_grad_()
    y = xi @ w.T
    (y * c).sum().backward()
    out["copy"] = (y.detach().numpy(), xi.grad.numpy())
    wi = w.clone().requires_grad_()
    y = x @ wi.T
    (y * c).sum().backward()
    out["reduce"] = (y.detach().numpy(), wi.grad.numpy())
    xi = (x @ w.T).clone().requires_grad_()
    (xi * c).sum().backward()
    out["gather"] = (xi.detach().numpy(), xi.grad.numpy())
    return out


def _tp_steps(setup, mesh, out, clip_binding=False):
    """One TP step of each model on this rank's rows of the global
    batches (the global masks injected), into `out`."""
    for kind in ("t2", "wg"):
        tp = tp_layout(kind, setup, mesh)
        b = _rows(setup[f"{kind}_batch"], mesh.data_rank, mesh.shape["data"])
        masks = setup["masks"] if kind == "t2" else None
        r = train_step_out(kind, setup, b, mesh, masks, tp=tp)
        r.pop("opt_state")
        out[kind] = r
        if clip_binding:
            r = train_step_out(kind, setup, b, mesh, masks, tp=tp,
                               clip=setup["tight_clip"])
            r.pop("opt_state")
            out[f"{kind}_clip"] = r


def rank_tp_steps(rank, world, setup):
    """On 2 ranks, a (1 data x 2 model) mesh: one TP step of each model,
    and one whose clip binds."""
    from fac_via_ppg_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model=2, device="cpu")
    out = {}
    _tp_steps(setup, mesh, out, clip_binding=True)
    return out


def rank_tp_tools(rank, world, setup, trainer_args, cli_runs):
    """On 2 ranks, a (1 data x 2 model) mesh: the autograd collectives;
    the WN int8 rungs through waveglow_infer, the vocoder CLI and the
    bench under the mesh; both trainers' main() at
    tensor_parallel_devices=2."""
    from fac_via_ppg_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model=2, device="cpu")
    return {"collectives": rank_tp_collectives(mesh),
            "lstm": rank_tp_lstm(mesh),
            "rungs": tp_rungs(setup, mesh),
            "cli": rank_vocoder_cli(rank, world, cli_runs),
            "bench": tp_bench(mesh),
            "trainers": rank_tp_trainers(*trainer_args)}


def tp_rungs(setup, mesh):
    """waveglow_infer at the setup's tiny WaveGlow, in f32, dense and with
    each WN int8 rung (in conv per column, per tensor, res_skip), tensor
    parallel over `mesh` when given: each one's audio."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models import waveglow as tw
    from fac_via_ppg_torch.weights import fold_waveglow

    cfg = WaveGlowConfig(**setup["wg_cfg"])
    params = tw.remove_weightnorm(fold_waveglow(setup["wg_params"]))
    mel = torch.as_tensor(setup["rung_mel"])
    runs = {"dense": {}, "in_column": dict(wn_int8_flows=cfg.n_flows),
            "in_tensor": dict(wn_int8_flows=cfg.n_flows,
                              wn_int8_quant="tensor"),
            "rs": dict(wn_int8_rs_flows=cfg.n_flows)}
    out = {}
    with torch.no_grad():
        for name, kw in runs.items():
            out[name] = tw.waveglow_infer(
                cfg, params, mel, 0.6, torch.Generator().manual_seed(3),
                wn_impl="conv", mesh=mesh, **kw).numpy()
    return out


def tp_bench(mesh):
    """The rtf bench's WN int8 rung flags at a tiny WaveGlow under `mesh`:
    its JSON line."""
    from fac_via_ppg_torch.bench import bench_waveglow_rtf
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig

    cfg = WaveGlowConfig(n_mel_channels=80, hop_length=64, n_flows=2,
                         n_group=8, n_early_every=4, n_early_size=2,
                         wn_n_layers=2, wn_n_channels=16, wn_kernel_size=3,
                         upsample_kernel_size=256)
    return bench_waveglow_rtf(batch=2, seconds=0.1, warmup=1, iters=1,
                              wn_impl="conv", cond_impl="int8",
                              wn_int8_flows=2, wn_int8_rs_flows=1,
                              cfg=cfg, mesh=mesh)


def rank_tp_trainers(ppg2mel_run, deps, waveglow_config):
    """Both trainers' main() at tensor_parallel_devices=2, ZeRO-1 asked
    for (a no-op at data 1): (stdout, the last iteration, the whole
    params) of each."""
    import contextlib
    import io

    from fac_via_ppg_torch.data import ppg_mel_dataset as ds_mod
    from fac_via_ppg_torch.frontend.ppg import DependenciesPPG
    from fac_via_ppg_torch.scripts import train_ppg2mel, train_waveglow
    from fac_via_ppg_torch.utils.tree import tree_leaves

    the_deps = DependenciesPPG(**deps)
    ds_mod.DependenciesPPG = lambda: the_deps
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, _, _, it = train_ppg2mel.main(
            device="cpu", epochs=2, iters_per_checkpoint=2,
            tensor_parallel_devices=2, zero_sharded_opt_state=True,
            **ppg2mel_run)
    out["ppg2mel"] = (buf.getvalue(), it,
                      [x.numpy() for x in tree_leaves(params)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, _, it = train_waveglow.main(
            waveglow_config, device="cpu", epochs=2, iters_per_checkpoint=2,
            tensor_parallel_devices=2)
    out["waveglow"] = (buf.getvalue(), it,
                       [x.numpy() for x in tree_leaves(params)])
    return out


def rank_tp_four(rank, world, setup, ckpt_path):
    """On 4 ranks, a (2 data x 2 model) mesh: one TP step of each model;
    three TP steps of each with and without ZeRO-1; a WaveGlow TP + ZeRO-1
    run of two steps saved to `ckpt_path`, then its third step; that
    checkpoint resumed at (4 x 1) with ZeRO-1, its next step."""
    from fac_via_ppg_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model=2, device="cpu")
    out = {}
    _tp_steps(setup, mesh, out)
    for kind in ("t2", "wg"):
        tp = tp_layout(kind, setup, mesh)
        b = _rows(setup[f"{kind}_batch"], mesh.data_rank, mesh.shape["data"])
        masks = setup["masks"] if kind == "t2" else None
        runs = [train_step_out(kind, setup, b, mesh, masks, zero=z, steps=3,
                               tp=tp) for z in (False, True)]
        specs = runs[1]["moment_specs"]
        out[f"zero_{kind}"] = {
            "bit_equal": all(np.array_equal(a, c) for a, c in zip(
                runs[0]["params"], runs[1]["params"])),
            "losses": runs[1]["losses"],
            "composed": sum("model" in str(s) and "data" in str(s)
                            for s in specs),
            "data_split": sum("data" in str(s) for s in specs)}
    out["resume"] = tp_zero_run(setup, mesh, ckpt_path)
    flat = make_mesh(model=1, device="cpu")
    out["resume_4x1"] = tp_resume(setup, ckpt_path, flat)
    return out


def _wg_rows(setup, i, mesh):
    batch = setup["wg_batches"][i]
    if mesh is None:
        return tuple(torch.as_tensor(x) for x in batch)
    return _rows(batch, mesh.data_rank, mesh.shape["data"])


def tp_zero_run(setup, mesh, path):
    """WaveGlow TP + ZeRO-1: two steps on the setup's batches, the
    checkpoint written (rank 0 writes whole tensors), the third step's
    loss and the params after it (whole)."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.utils.tree import tree_leaves

    tp = tp_layout("wg", setup, mesh)
    opt = make_optimizer(1e-3)
    params = tp.shard(_copy(setup["wg_params"]))
    step = t_step.make_waveglow_train_step(
        WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh, tp=tp)
    opt_state = opt.init(params, mesh=mesh, zero=True, tp=tp)
    for i in range(2):
        step(params, opt_state, _wg_rows(setup, i, mesh))
    ckpt.save_checkpoint(path, params, opt_state, 1e-3, 1, mesh=mesh, tp=tp)
    loss = float(step(params, opt_state, _wg_rows(setup, 2, mesh)).loss)
    nxt = float(step(params, opt_state, _wg_rows(setup, 2, mesh)).loss)
    return {"loss": loss, "next_loss": nxt,
            "params": [x.numpy() for x in tree_leaves(tp.gather(params))]}


def tp_resume(setup, path, mesh):
    """The TP checkpoint at `path` read on `mesh` (ZeRO-1 where its data
    axis is above 1; None: one process, plain Adam): the third batch's
    step twice, its losses, and the params after them."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.utils.tree import tree_leaves

    payload = ckpt.load_checkpoint(path)
    opt = make_optimizer(1e-3)
    params = payload["params"]
    opt_state = opt.init(params, mesh=mesh, zero=mesh is not None)
    opt_state.load_state_dict(payload["opt_state"])
    step = t_step.make_waveglow_train_step(
        WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh)
    loss = float(step(params, opt_state, _wg_rows(setup, 2, mesh)).loss)
    nxt = float(step(params, opt_state, _wg_rows(setup, 2, mesh)).loss)
    return {"loss": loss, "next_loss": nxt,
            "params": [x.numpy() for x in tree_leaves(params)]}


def rank_tp_identity(rank, world):
    """The three autograd collectives over this 1-rank job's model group
    (a group of one: each the identity), on this rank's card: whether the
    output and the input's gradient equal the input and the upstream
    gradient bit for bit, and the collectives counted."""
    import torch.distributed as dist

    from fac_via_ppg_torch.parallel.mesh import collectives, make_mesh
    from fac_via_ppg_torch.parallel.tp import (
        copy_to_model,
        gather_from_model,
        reduce_from_model,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(device=dev)
    g = torch.Generator(dev).manual_seed(0)
    out = {"backend": dist.get_backend()}
    n0 = dict(collectives)
    for name, op in (("copy", copy_to_model), ("reduce", reduce_from_model),
                     ("gather", lambda x, grp: gather_from_model(x, grp, 1))):
        x = torch.randn((4, 6), generator=g, device=dev).requires_grad_()
        up = torch.randn((4, 6), generator=g, device=dev)
        y = op(x, mesh.model_group)
        (grad,) = torch.autograd.grad(y, x, up)
        out[name] = {"equal": torch.equal(y, x) and torch.equal(grad, up)}
    out["counted"] = {k: collectives[k] - n0[k] for k in n0}
    return out
