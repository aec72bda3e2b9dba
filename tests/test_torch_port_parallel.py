"""The port's mesh and placement rules (fac_via_ppg_torch/parallel/) on the
CPU: the mesh and its collectives on 2 and 4 gloo ranks (spawned, torch
only; a file:// store), `shard_batch`'s padding, the Tacotron2 / int8-cond
/ ZeRO-1 split records against the JAX package's PartitionSpecs leaf for
leaf at create_hparams() widths, WaveGlow's paired WN split against the
dense conv formulation (float64: 1e-12 of the output's scale), the
sharded EpochBatcher and `ppg_acoustics_collate(pad_dims=)` against
JAX's, the launcher's arguments and the device rules.
"""

import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.data import ppg_mel_dataset as t_ds
from fac_via_ppg_torch.models import waveglow as tw
from fac_via_ppg_torch.parallel import mesh as pm
from fac_via_ppg_torch.parallel import sharding as ps
from fac_via_ppg_torch.scripts import multiproc
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config as JT2Config
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig as JWGConfig
from fac_via_ppg_tpu.configs.hparams import create_hparams
from fac_via_ppg_tpu.data import ppg_mel_dataset as j_ds
from fac_via_ppg_tpu.models import tacotron2 as jt
from fac_via_ppg_tpu.models import waveglow as jw
from fac_via_ppg_tpu.parallel import mesh as jm
from fac_via_ppg_tpu.parallel import sharding as js
from fac_via_ppg_tpu.train import optim as j_optim
from tests.torch_port_helpers import (
    check_collectives,
    rank_collectives,
    rank_fails,
    rank_mesh_checks,
    rank_shard_roundtrip,
    rank_wn_tp,
    run_ranks,
)


def _mesh(data, model, rank=0):
    """A mesh's coordinates without a process group."""
    return pm.Mesh(data, model, torch.device("cpu"), rank)


def _spec(p, ndim):
    """A JAX PartitionSpec as the port's record: one entry a dim."""
    entries = list(p) + [None] * (ndim - len(tuple(p)))
    return tuple(entries)


def _axes(record):
    """A record's axis names, a paired split's groups dropped."""
    return tuple(e[0] if isinstance(e, tuple) else e for e in record)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_on_ranks(tmp_path, world):
    res = run_ranks(world, tmp_path, rank_mesh_checks)
    rows_all = np.arange(15).reshape(5, 3)
    for rank, r in enumerate(res):
        assert r["backend"] == "gloo" and r["world"] == world
        for model in (1, 2):
            m = r[model]
            data = world // model
            assert m["shape"] == {"data": data, "model": model}
            assert m["data_rank"] == rank // model
            assert m["model_rank"] == rank % model
            # the data group: the ranks of this model index
            assert m["data_sum"] == sum(i * model + rank % model
                                        for i in range(data))
            assert m["model_sum"] == sum((rank // model) * model + j
                                         for j in range(model))
            n_pad = -(-5 // data) * data
            padded = np.concatenate([rows_all, np.repeat(
                rows_all[-1:], n_pad - 5, 0)])
            b = n_pad // data
            d = rank // model
            assert m["rows"] == padded[d * b:(d + 1) * b].tolist()
            assert m["gathered"] == rows_all.tolist()
            assert m["gathered_dtype"] == "torch.int16"
            assert m["replicated"] == [[0.0, 0.0], [0.0, 0.0]]


def test_run_ranks_stops_on_a_failed_rank(tmp_path):
    """A rank that raises fails the run with its own traceback (not that
    of the peer whose barrier it broke), and the peer is not waited for."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="(?s)rank 1 of 2 failed "
                       "first.*fails on purpose"):
        run_ranks(2, tmp_path, rank_fails)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("data,n", [(2, 5), (4, 5), (4, 8), (3, 1)])
def test_shard_batch_pads_with_repeats(data, n):
    """Each rank's rows of a batch padded to the data axis with repeats of
    its last row (JAX eval/fused.py pads the same way)."""
    batch = (np.arange(n * 2).reshape(n, 2), torch.arange(n))
    n_pad = -(-n // data) * data
    got = [pm.shard_batch(_mesh(data, 1, r), batch) for r in range(data)]
    flat = np.concatenate([g[0] for g in got])
    want = np.concatenate([batch[0], np.repeat(batch[0][-1:], n_pad - n, 0)])
    np.testing.assert_array_equal(flat, want)
    assert torch.cat([g[1] for g in got]).tolist() == \
        list(range(n)) + [n - 1] * (n_pad - n)
    assert pm.padded_rows(_mesh(data, 1), n) == n_pad


def test_one_process_mesh_and_wrong_world(capsys):
    """No process group, no environment: a one-process run, a mesh of one
    that issues nothing; a mesh larger than the job raises, saying how to
    launch."""
    assert pm.init_distributed(device="cpu") == torch.device("cpu")
    assert "process 0/1" in capsys.readouterr().out
    m = pm.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None
    t = torch.ones(2)
    assert pm.all_reduce(t, m.data_group) is t
    with pytest.raises(ValueError, match="needs 2 processes.*torchrun"):
        pm.make_mesh(data=2, device="cpu")


def test_local_rank_out_of_range_raises(monkeypatch):
    """cuda:LOCAL_RANK, never wrapped round onto a shared card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pm.local_device() == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK 2 has no card"):
        pm.local_device()
    assert pm.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.local_device()


def test_multiproc_arguments(monkeypatch):
    """The JAX launcher's flags become a tcp:// rendezvous; none given,
    torchrun's environment; the trainer's key=value overrides."""
    args = multiproc.parse_args(
        ["--coordinator", "localhost:1234", "--num_processes", "2",
         "--process_id", "1", "train_waveglow", "config=c.json",
         "epochs=3", "device=cpu"])
    assert (args.coordinator, args.num_processes, args.process_id) == \
        ("localhost:1234", 2, 1)
    assert args.trainer == "train_waveglow"
    assert multiproc.parse_overrides(args.overrides) == {
        "config": "c.json", "epochs": 3, "device": "cpu"}
    seen = {}
    monkeypatch.setattr(multiproc, "init_distributed",
                        lambda **kw: seen.update(kw) or "dev")
    monkeypatch.setenv("LOCAL_RANK", "0")  # restored to its state after
    monkeypatch.delenv("LOCAL_RANK")
    assert multiproc.initialize_distributed("h:1", 2, 1, "cpu") == "dev"
    assert seen == {"init_method": "tcp://h:1", "world_size": 2, "rank": 1,
                    "device": "cpu"}
    with pytest.raises(SystemExit):  # the backend follows the device
        multiproc.parse_args(["--backend", "gloo", "train_ppg2mel"])
    import os

    assert os.environ["LOCAL_RANK"] == "1"
    seen.clear()
    multiproc.initialize_distributed()
    assert seen["init_method"] is None and seen["world_size"] is None
    with pytest.raises(ValueError, match="go together"):
        multiproc.initialize_distributed("h:1", None, None)


# ----------------------------------------------- the placement rules

@pytest.fixture(scope="module")
def full_t2():
    """create_hparams()'s Tacotron2: JAX shapes only, and the port's tree
    of the same shapes (meta tensors)."""
    cfg = JT2Config.from_hparams(create_hparams())
    shapes = jax.eval_shape(lambda k: jt.init_tacotron2(k, cfg)[0],
                            jax.random.PRNGKey(0))
    port = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    return shapes, port


@pytest.mark.parametrize("model", [2, 4])
def test_tacotron2_param_shardings_match_jax(full_t2, model):
    shapes, port = full_t2
    mesh = jm.make_mesh(data=8 // model, model=model)
    want = jax.tree.leaves(js.tacotron2_param_shardings(mesh, shapes))
    got = ps.tree_leaves_specs(ps.tacotron2_param_shardings(
        types.SimpleNamespace(shape=dict(mesh.shape)), port))
    leaves = jax.tree.leaves(shapes)
    assert len(got) == len(want) == len(leaves)
    n_split = 0
    for g, w, leaf in zip(got, want, leaves):
        assert g == _spec(w.spec, leaf.ndim)
        n_split += any(g)
    assert n_split >= 10  # the wide matrices are split


@pytest.mark.parametrize("model", [2, 4])
def test_int8cond_shardings_match_jax(model):
    """The same leaves split on the same dim over 'model' as JAX's; the
    port's records split each layer's two gate halves ((model, 2L))."""
    cfg = JWGConfig()
    shapes = jax.eval_shape(
        lambda k: jw.pack_waveglow_int8cond(cfg, jw.init_waveglow(k, cfg)),
        jax.random.PRNGKey(0))
    mesh = jm.make_mesh(data=8 // model, model=model)
    want = jax.tree.leaves(js.int8cond_shardings(mesh, shapes))
    port = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    got = ps.tree_leaves_specs(ps.int8cond_shardings(
        types.SimpleNamespace(shape=dict(mesh.shape)), port,
        cfg.wn_n_layers))
    leaves = jax.tree.leaves(shapes)
    assert len(got) == len(want) == len(leaves)
    for g, w, leaf in zip(got, want, leaves):
        assert _axes(g) == _spec(w.spec, leaf.ndim)
        if any(g):
            assert g[0] == ("model", 2 * cfg.wn_n_layers)


@pytest.mark.parametrize("layout", ["dp", "dp_tp"])
def test_optimizer_state_shardings_match_jax(full_t2, layout):
    """ZeRO-1: the moments' records against JAX's on optax's Adam state
    (its mu tree mirrors the params), alone over 8 data and composed with
    Tacotron2's TP over 4 data x 2 model."""
    shapes, port = full_t2
    model = 1 if layout == "dp" else 2
    mesh = jm.make_mesh(data=8 // model, model=model)
    fake = types.SimpleNamespace(shape=dict(mesh.shape))
    opt = j_optim.make_optimizer(1e-3, 1e-6, 1.0)
    state = jax.eval_shape(opt.init, shapes)
    kw, kw_t = {}, {}
    if model > 1:
        kw = {"param_spec_fn": js.tacotron2_spec_fn(mesh)}
        kw_t = {"param_spec_fn": ps.tacotron2_spec_fn(fake)}
    specs = js.optimizer_state_shardings(mesh, state, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    mu = [(jax.tree_util.keystr(p), s) for p, s in flat if ".mu" in
          jax.tree_util.keystr(p)]
    leaves = jax.tree.leaves(shapes)
    got = ps.tree_leaves_specs(ps.optimizer_state_shardings(fake, port,
                                                            **kw_t))
    assert len(mu) == len(got) == len(leaves)
    for (path, w), g, leaf in zip(mu, got, leaves):
        assert g == _spec(w.spec, leaf.ndim), path
    assert sum("data" in g for g in got) > len(got) // 2


def _tiny_wg(C=16, L=2):
    cfg = WaveGlowConfig(n_mel_channels=16, hop_length=64, n_flows=4,
                         n_group=8, n_early_every=2, n_early_size=2,
                         wn_n_layers=L, wn_n_channels=C, wn_kernel_size=3,
                         upsample_kernel_size=256)
    g = torch.Generator().manual_seed(4)
    params = tw.remove_weightnorm(tw.init_waveglow(cfg, g))
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.1
    return cfg, params


def test_waveglow_paired_rule_slices():
    """Model rank m of p holds rows [m c, (m+1) c) of both gate halves of
    every in / cond conv, the same columns of every res_skip conv, and
    every other leaf whole."""
    cfg, params = _tiny_wg()
    C, p = cfg.wn_n_channels, 4
    c = C // p
    for m in range(p):
        local = tw.tp_shard_waveglow(params, _mesh(1, p, m))
        wn, lw = params["wn"][1], local["wn"][1]
        rows = list(range(m * c, (m + 1) * c)) + \
            list(range(C + m * c, C + (m + 1) * c))
        for kind in ("in_layers", "cond_layers"):
            for full, loc in zip(wn[kind], lw[kind]):
                assert torch.equal(loc["weight"], full["weight"][rows])
                assert torch.equal(loc["bias"], full["bias"][rows])
        for full, loc in zip(wn["res_skip_layers"], lw["res_skip_layers"]):
            assert torch.equal(loc["weight"],
                               full["weight"][:, m * c:(m + 1) * c])
            assert torch.equal(loc["bias"], full["bias"])
        for key in ("start", "end"):
            assert torch.equal(lw[key]["weight"], wn[key]["weight"])
        assert local["upsample"]["weight"] is params["upsample"]["weight"]


def test_waveglow_tp_matches_dense_on_ranks(tmp_path):
    """On 4 ranks (model 2 and 4): one coupling net and a whole vocoder
    call in float64 equal the dense conv formulation to 1e-12 of their
    scale, with one all-reduce per layer but the last plus one for the
    skip sum; int8 cond TP within 25 dB SNR of dense TP (JAX
    tests/test_dp_serving.py:79-140)."""
    cfg, params = _tiny_wg()
    p64 = tw.cast_params(params, torch.float64)
    p64["convinv"] = [{k: v.double() for k, v in c.items()}
                      for c in params["convinv"]]
    rng = np.random.RandomState(5)
    n_half = tw.flow_channels(cfg)[0] // 2
    audio = torch.as_tensor(rng.randn(2, n_half, 24))
    spect = torch.as_tensor(rng.randn(2, cfg.n_mel_channels * cfg.n_group,
                                      24))
    packed = tw.pack_waveglow_int8cond(cfg, params)
    res = run_ranks(4, tmp_path, rank_wn_tp, cfg, p64, audio, spect, packed)
    for model in (2, 4):
        for r in res:
            got = r[model]
            assert got["wn_err"] <= 1e-12 * got["wn_scale"]
            assert got["call_err"] <= 1e-12 * got["call_scale"]
            assert got["wn_all_reduces"] == cfg.wn_n_layers
            assert got["call_all_reduces"] == cfg.n_flows * cfg.wn_n_layers
            assert got["in_rows"] == (2 * cfg.wn_n_channels // model,
                                      cfg.wn_n_channels, 3)
            b, e = got["dense_tp"], got["int8"]
            snr = 10 * np.log10(np.sum(b ** 2) / np.sum((e - b) ** 2))
            assert snr > 25.0, snr
        # every rank of the model group returns the same audio
        np.testing.assert_array_equal(res[0][model]["int8"],
                                      res[-1][model]["int8"])


def test_apply_and_gather_shards_roundtrip_on_ranks(tmp_path):
    """apply_shardings then gather_shards gives every leaf back, bit for
    bit, under the paired WN rule, ZeRO-1 over 'data', and both at once."""
    cfg, params = _tiny_wg()
    res = run_ranks(2, tmp_path, rank_shard_roundtrip, params)
    for r in res:
        for key, got in r.items():
            assert got["equal"], key
    # 2 ranks of model 1: ZeRO halves the first divisible dim
    assert res[0][(1, "zero")]["shapes"][0][0] == \
        params["upsample"]["weight"].shape[0] // 2


# ------------------------------------------------- the sharded batcher

class _Items:
    """A dataset of (ppg (T1, 3), mel (T2, 2)) items of varied lengths."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.items = [(np.full((int(a), 3), i, np.float32),
                       np.full((int(b), 2), i, np.float32))
                      for i, (a, b) in enumerate(zip(
                          rng.randint(3, 20, n), rng.randint(4, 30, n)))]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)


def _ids_and_dims(batch, pad_to=1, pad_dims=None):
    out = j_ds.ppg_acoustics_collate(batch, pad_to=pad_to, pad_dims=pad_dims)
    return [int(x[0, 0]) for x, _ in batch], out[0].shape, out[2].shape


@pytest.mark.parametrize("seed,epoch,num_shards,pad_to", [
    (0, 0, 2, 1), (3, 1, 2, 8), (7, 2, 4, 4), (11, 0, 3, 16)])
def test_epoch_batcher_shards_match_jax(seed, epoch, num_shards, pad_to):
    """Strided shards of one (seed, epoch) shuffle; every shard runs the
    minimum number of batches; pad_dims the maximum over the shards'
    concurrent batches: the JAX batcher's batches, shard by shard."""
    data = _Items(23, seed)
    for shard in range(num_shards):
        kw = dict(drop_last=True, shard=shard, num_shards=num_shards,
                  pad_to=pad_to,
                  length_fn=lambda it: (it[0].shape[0], it[1].shape[0]))
        tb = t_ds.EpochBatcher(data, 3, seed, _ids_and_dims, **kw)
        jb = j_ds.EpochBatcher(data, 3, seed, _ids_and_dims, **kw)
        tb.epoch = jb.epoch = epoch
        got, want = list(tb), list(jb)
        assert got == want and len(got) == len(tb) == len(jb)
        assert len(got) == (23 // num_shards) // 3
    assert t_ds.ppg_mel_lengths(data[0]) == (data[0][0].shape[0],
                                            data[0][1].shape[0])


def test_epoch_batcher_shards_require_drop_last():
    with pytest.raises(ValueError, match="drop_last"):
        t_ds.EpochBatcher(_Items(4, 0), 2, 0, _ids_and_dims,
                          drop_last=False, num_shards=2)


@pytest.mark.parametrize("pad_dims", [None, (24, 32)])
def test_collate_pad_dims_matches_jax(pad_dims):
    batch = [_Items(5, 1)[i] for i in range(4)]
    got = t_ds.ppg_acoustics_collate(batch, pad_to=8, pad_dims=pad_dims)
    want = j_ds.ppg_acoustics_collate(batch, pad_to=8, pad_dims=pad_dims)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if pad_dims:
        assert got[0].shape[2] == 24 and got[2].shape[2] == 32


def test_jax_shapes_unchanged():
    """The JAX package's own shapes (jnp arrays) pass through the port's
    rules as tensors do."""
    leaf = jnp.zeros((4, 6))
    assert ps.optimizer_state_shardings(
        types.SimpleNamespace(shape={"data": 2, "model": 1}),
        {"w": leaf})["w"] == ("data", None)


@pytest.mark.parametrize("world", [1, 2])
def test_collectives_and_global_batchnorm_on_ranks(tmp_path, world):
    check_collectives(run_ranks(world, tmp_path, rank_collectives, "cpu"),
                      world)
