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


def train_step_out(kind, setup, batch, mesh=None, masks=None, zero=False,
                   steps=1):
    """`steps` train steps of Tacotron2 (`kind` "t2") or WaveGlow ("wg")
    from the setup's params on `batch` (this rank's rows), with
    capture_optimizer: (losses, the last step's gradients, grad norm, BN
    state, params after)."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.train import step as t_step
    from fac_via_ppg_torch.utils.tree import tree_leaves

    opt = capture_optimizer()
    if kind == "t2":
        params, state = _copy(setup["t2_params"]), _copy(setup["t2_state"])
        step = t_step.make_tacotron2_train_step(
            Tacotron2Config(**setup["t2_cfg"]), opt, mesh=mesh)
    else:
        params, state = _copy(setup["wg_params"]), None
        step = t_step.make_waveglow_train_step(
            WaveGlowConfig(**setup["wg_cfg"]), opt, sigma=0.7, mesh=mesh)
    opt_state = opt.init(params, mesh=mesh, zero=zero)
    losses, out = [], None
    for _ in range(steps):
        if kind == "t2":
            out = step(params, state, opt_state, batch, masks=masks)
            state = out.model_state
        else:
            out = step(params, opt_state, batch)
        losses.append(float(out.loss))
    return {"losses": losses, "grads": [g.numpy() for g in opt.grads],
            "grad_norm": float(out.grad_norm),
            "state": None if state is None else [
                x.numpy() for x in tree_leaves(state)],
            "params": [x.numpy() for x in tree_leaves(params)],
            "opt_state": opt_state}


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
