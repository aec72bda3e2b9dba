"""The port's data and checkpoint tools against the JAX package on the
CPU: scripts/make_corpus.py (byte-identical wavs and filelists),
scripts/mel2samp_dump.py, train/precision.py (the loss scalers' state step
by step, the Policy casts), train/convert_model.py (the old res / skip
format) and train/export_torch.py's pickled-module WaveGlow.

Tolerances: corpus files and checkpoint leaves bit for bit; mels atol 1e-5
(the two packages' STFTs, as test_torch_port_train_data.py holds
Mel2Samp); folded weights within 8 ulp (XLA and torch sum the norm's
squares in different orders, as test_torch_port_vocoder_cli.py holds
them).
"""

import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWaveGlowConfig
from fac_via_ppg_torch.scripts import make_corpus as t_corpus
from fac_via_ppg_torch.scripts import mel2samp_dump as t_dump
from fac_via_ppg_torch.train import convert_model as t_conv
from fac_via_ppg_torch.train import export_torch as t_exp
from fac_via_ppg_torch.train import import_torch as t_imp
from fac_via_ppg_torch.train import precision as t_prec
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.scripts import make_corpus as j_corpus
from fac_via_ppg_tpu.train import convert_model as j_conv
from fac_via_ppg_tpu.train import export_torch as j_exp
from fac_via_ppg_tpu.train import import_torch as j_imp
from fac_via_ppg_tpu.train import precision as j_prec

TINY = {
    "n_mel_channels": 80, "hop_length": 160, "n_flows": 2, "n_group": 8,
    "n_early_every": 4, "n_early_size": 2,
    "WN_config": {"n_layers": 3, "n_channels": 16, "kernel_size": 3},
}
CFG, TCFG = WaveGlowConfig.from_dict(TINY), TWaveGlowConfig.from_dict(TINY)


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_array_equal(g, want[name], err_msg=name)


# ------------------------------------------------------------ make_corpus

def _read_tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("style", ["formant", "vowel"])
def test_make_corpus_writes_the_jax_packages_bytes(tmp_path, style):
    """The same arguments and seed into the same directory: every wav and
    both filelists byte for byte."""
    out = str(tmp_path / "corpus")
    kw = dict(n_train=3, n_val=2, seed=11, min_seconds=0.6,
              max_seconds=1.2, style=style)
    want_paths = j_corpus.make_corpus(out, **kw)
    want = _read_tree(out)
    for path in want_paths["wavs"]:
        os.remove(path)
    got_paths = t_corpus.make_corpus(out, **kw)
    assert got_paths == want_paths
    got = _read_tree(out)
    assert sorted(got) == sorted(want) and len(got) == 7
    for name in want:
        assert got[name] == want[name], name
    sr, wav = wavfile.read(got_paths["wavs"][0])
    assert sr == 16000 and wav.dtype == np.int16 and wav.std() > 0
    with pytest.raises(ValueError, match="unknown corpus style"):
        t_corpus.make_corpus(out, style="noise")


# ---------------------------------------------------------- mel2samp_dump

def test_mel2samp_dump_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    paths = []
    for i, n in enumerate([4000, 5321]):
        paths.append(str(tmp_path / f"a{i}.wav"))
        wavfile.write(paths[-1], 16000, (rng.randn(n) * 3000).astype(np.int16))
    filelist = tmp_path / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")

    monkeypatch.setattr(sys, "argv", ["mel2samp_dump", "-f", str(filelist),
                                      "-o", str(tmp_path / "j")])
    runpy.run_module("fac_via_ppg_tpu.scripts.mel2samp_dump",
                     run_name="__main__")
    argv = ["-f", str(filelist), "-o", str(tmp_path / "t")]
    if not torch.cuda.is_available():  # the card unless the CPU is asked
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_dump.main(argv)
    written = t_dump.main(argv, device="cpu")
    assert [os.path.basename(p) for p in written] == ["a0.wav.npy",
                                                      "a1.wav.npy"]
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t"))
    for path in written:
        got = np.load(path)
        want = np.load(tmp_path / "j" / os.path.basename(path))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and got.shape[0] == 80
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -------------------------------------------------------------- precision

@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_loss_scaler_state_matches_jax_step_by_step(kind):
    """20 steps with infs and nans injected: the scale, the good-step
    count, the step's verdict and the unscaled gradients each step."""
    if kind == "dynamic":
        t_s = t_prec.DynamicLossScaler(init_scale=2.0 ** 12, scale_window=3)
        j_s = j_prec.DynamicLossScaler(init_scale=2.0 ** 12, scale_window=3)
    else:
        t_s, j_s = t_prec.StaticLossScaler(64.0), j_prec.StaticLossScaler(64.0)
    t_state, j_state = t_s.init(), j_s.init()
    assert t_state._fields == j_state._fields == ("scale", "good_steps")
    rng = np.random.RandomState(0)
    verdicts = []
    for step in range(20):
        g = (rng.randn(5) * 100).astype(np.float32)
        if step % 7 == 3:
            g[1] = np.inf
        if step % 5 == 4:
            g[2] = np.nan
        h = (rng.randn(2, 3)).astype(np.float32)
        t_g, t_state, t_ok = t_s.unscale(
            {"a": torch.tensor(g), "b": [torch.tensor(h)]}, t_state)
        j_g, j_state, j_ok = j_s.unscale(
            {"a": jnp.asarray(g), "b": [jnp.asarray(h)]}, j_state)
        assert t_state.scale.dtype == torch.float32
        assert t_state.good_steps.dtype == torch.int32
        assert float(t_state.scale) == float(j_state.scale), step
        assert int(t_state.good_steps) == int(j_state.good_steps), step
        assert bool(t_ok) == bool(j_ok), step
        verdicts.append(bool(t_ok))
        np.testing.assert_array_equal(t_g["a"].numpy(), np.asarray(j_g["a"]))
        np.testing.assert_array_equal(t_g["b"][0].numpy(),
                                      np.asarray(j_g["b"][0]))
    assert verdicts.count(False) == 7


def test_dynamic_loss_scaler_defaults():
    state = t_prec.DynamicLossScaler().init()
    assert float(state.scale) == 2.0 ** 32 and int(state.good_steps) == 0
    assert t_prec.DynamicLossScaler().scale_window == \
        j_prec.DynamicLossScaler().scale_window == 1000


def test_policy_casts_match_jax():
    for name in ("bfloat16", "float16", "float32"):
        t_pol, j_pol = t_prec.get_policy(name), j_prec.get_policy(name)
        tree = {"w": torch.ones(3), "i": torch.ones(2, dtype=torch.int32),
                "nested": [{"b": torch.zeros(1, dtype=torch.float64)}]}
        cast = t_pol.cast_to_compute(tree)
        assert str(cast["w"].dtype) == f"torch.{j_pol.compute_dtype}"
        assert cast["nested"][0]["b"].dtype == getattr(torch, name)
        assert cast["i"].dtype == torch.int32  # non-float leaves untouched
        assert t_pol.cast_to_param(cast)["w"].dtype == torch.float32
        assert t_pol.cast_to_output(cast)["nested"][0]["b"].dtype == \
            torch.float32


# ---------------------------------------------------------- convert_model

def _old_format(sd_new, cfg, C):
    """The old (glow_old) layout of a fused state dict: each res_skip
    conv split by output rows into res_layers / skip_layers (weight norm
    is per output row, so (g, v) split the same way)."""
    sd_old = {k: v for k, v in sd_new.items() if ".res_skip_layers." not in k}
    for k in range(cfg.n_flows):
        for i in range(cfg.wn_n_layers):
            pre = f"WN.{k}.res_skip_layers.{i}"
            fields = [f for f in ("weight", "weight_g", "weight_v", "bias")
                      if f"{pre}.{f}" in sd_new]
            for f in fields:
                v = sd_new[f"{pre}.{f}"]
                if i < cfg.wn_n_layers - 1:
                    sd_old[f"WN.{k}.res_layers.{i}.{f}"] = v[:C].clone()
                    sd_old[f"WN.{k}.skip_layers.{i}.{f}"] = v[C:].clone()
                else:
                    sd_old[f"WN.{k}.skip_layers.{i}.{f}"] = v.clone()
    return sd_old


def _jax_train_params(seed):
    params = jwg.init_waveglow(jax.random.PRNGKey(seed), CFG)
    rng = np.random.RandomState(seed)
    for wn in params["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.02, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_convert_model_matches_jax(tmp_path, weight_norm):
    params = _jax_train_params(3)
    if not weight_norm:
        params = jax.tree_util.tree_map(
            np.asarray, jwg.remove_weightnorm(params))
    sd_new = t_exp.export_waveglow_state_dict(params, TCFG)
    sd_old = _old_format(sd_new, TCFG, TCFG.wn_n_channels)
    assert not any(".res_skip_layers." in k for k in sd_old)

    got = t_conv.import_old_waveglow_state_dict(sd_old, TCFG)
    want = j_conv.import_old_waveglow_state_dict(sd_old, CFG)
    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert got.keys() == want.keys()
    for name, g in got.items():
        if "res_skip_layers" in name and name.endswith("weight") \
                and weight_norm:
            np.testing.assert_array_max_ulp(g, want[name], 8)
        else:
            np.testing.assert_array_equal(g, want[name], err_msg=name)

    # the converter CLI: old file -> a state dict the CLIs' loader reads
    torch.save(sd_old, tmp_path / "old.pt")
    (tmp_path / "cfg.json").write_text(
        '{"waveglow_config": %s}' % str(TINY).replace("'", '"'))
    new = t_conv.main([str(tmp_path / "old.pt"), str(tmp_path / "new.pt"),
                       "-c", str(tmp_path / "cfg.json")])
    loaded = dict(_tree_leaves(
        t_imp.load_reference_waveglow_checkpoint(new, TCFG)))
    assert loaded.keys() == got.keys()
    for name, g in got.items():
        np.testing.assert_array_equal(loaded[name], g, err_msg=name)
    loaded_old = dict(_tree_leaves(
        t_conv.load_old_reference_waveglow_checkpoint(
            str(tmp_path / "old.pt"), TCFG)))
    for name, g in got.items():
        np.testing.assert_array_equal(loaded_old[name], g, err_msg=name)


def _pickled_old_module(sd_old, path):
    """Save `sd_old` as the reference's old checkpoint: {'model':
    glow_old.WaveGlow} whose submodules hold the state dict's tensors."""
    installed = t_imp._install_glow_shims()
    try:
        root = sys.modules["glow_old"].WaveGlow()
        for key, value in sd_old.items():
            mod = root
            *names, leaf = key.split(".")
            for name in names:
                if name not in mod._modules:
                    mod.add_module(name, torch.nn.Module())
                mod = mod._modules[name]
            mod.register_parameter(leaf, torch.nn.Parameter(value))
        torch.save({"model": root, "iteration": 0}, path)
    finally:
        t_imp._remove_glow_shims(installed)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_old_pickled_module_loads_as_in_jax(tmp_path, weight_norm):
    """The old format as the reference stored it, a pickled glow_old
    module, through both packages' loaders (JAX's reads only this form)."""
    params = _jax_train_params(4)
    if not weight_norm:
        params = jax.tree_util.tree_map(
            np.asarray, jwg.remove_weightnorm(params))
    sd_old = _old_format(t_exp.export_waveglow_state_dict(params, TCFG),
                         TCFG, TCFG.wn_n_channels)
    path = str(tmp_path / "old_module.pt")
    _pickled_old_module(sd_old, path)
    assert "glow_old" not in sys.modules
    with pytest.raises(pickle.UnpicklingError):  # not a bare state dict
        torch.load(path, weights_only=True)
    got = dict(_tree_leaves(
        t_conv.load_old_reference_waveglow_checkpoint(path, TCFG)))
    want = dict(_tree_leaves(
        j_conv.load_old_reference_waveglow_checkpoint(path, CFG)))
    direct = dict(_tree_leaves(
        t_conv.import_old_waveglow_state_dict(sd_old, TCFG)))
    assert got.keys() == want.keys() == direct.keys()
    for name, g in got.items():
        np.testing.assert_array_equal(g, direct[name], err_msg=name)
        if "res_skip_layers" in name and name.endswith("weight") \
                and weight_norm:  # the two packages' folds, as above
            np.testing.assert_array_max_ulp(g, want[name], 8)
        else:
            np.testing.assert_array_equal(g, want[name], err_msg=name)
    assert "glow_old" not in sys.modules


# ----------------------------------------- pickled-module WaveGlow export

@pytest.mark.parametrize("weight_norm", [True, False])
def test_build_waveglow_module_matches_jax(weight_norm):
    got = t_exp.build_waveglow_module(TCFG, weight_norm=weight_norm)
    want = j_exp.build_waveglow_module(CFG, weight_norm=weight_norm)
    assert type(got).__module__ == "glow" and type(got).__name__ == "WaveGlow"
    g_sd, w_sd = got.state_dict(), want.state_dict()
    assert list(g_sd) == list(w_sd)
    assert any(k.endswith("weight_g") for k in g_sd) == weight_norm
    for k in g_sd:
        assert g_sd[k].shape == w_sd[k].shape, k
    for attr in ("n_flows", "n_group", "n_early_every", "n_early_size",
                 "n_remaining_channels"):
        assert getattr(got, attr) == getattr(want, attr)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_save_reference_waveglow_checkpoint_round_trips(tmp_path,
                                                         weight_norm):
    """The port's file read by both packages' loaders, and the JAX
    package's file by the port's, all into the params written."""
    params = _jax_train_params(5)
    if not weight_norm:
        params = jax.tree_util.tree_map(
            np.asarray, jwg.remove_weightnorm(params))
        for inv in params["convinv"]:
            inv.pop("weight_inverse")
    ours, theirs = str(tmp_path / "t.pt"), str(tmp_path / "j.pt")
    assert "glow" not in sys.modules
    t_exp.save_reference_waveglow_checkpoint(ours, params, TCFG,
                                             iteration=7,
                                             learning_rate=3e-4)
    assert "glow" not in sys.modules  # installed only while saving
    j_exp.save_reference_waveglow_checkpoint(theirs, params, CFG)

    read = {
        "port<-port": t_imp.load_reference_waveglow_checkpoint(ours, TCFG),
        "jax<-port": j_imp.load_reference_waveglow_checkpoint(ours, CFG),
        "port<-jax": t_imp.load_reference_waveglow_checkpoint(theirs, TCFG),
    }
    for name, tree in read.items():
        leaves = dict(_tree_leaves(tree))
        assert any(k.endswith("/g") for k in leaves) == weight_norm, name
        _assert_trees_equal(tree, params)
    installed = t_imp._install_glow_shims()
    try:
        payload = torch.load(ours, weights_only=False)
    finally:
        t_imp._remove_glow_shims(installed)
    assert payload["iteration"] == 7 and payload["learning_rate"] == 3e-4
    assert payload["optimizer"] == {}
    assert type(payload["model"]).__name__ == "WaveGlow"
