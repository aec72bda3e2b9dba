"""The port's binary nnet3 reader and writer and its PPG entry functions
against the JAX package on the CPU.

Each package reads the Kaldi binary model the other writes: the arrays come
out identical (bit for bit) and the forward within 1e-5 (f32, summed in
another order).  Truncated and malformed files raise the declared types
(ValueError, KaldiIOError among them), never struct.error / IndexError /
KeyError.  The PPG functions (full, monophone, from a wav file) agree
within 1e-5 on the same seeded wav, with JAX's MFCC held to its numpy
backend (the port's MFCC is that backend, dither included).
"""

import struct

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import nnet3 as t_nnet3
from fac_via_ppg_torch.frontend import nnet3_binary as t_bin
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import nnet3 as j_nnet3
from fac_via_ppg_tpu.frontend import nnet3_binary as j_bin
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle


def _tdnn(mod):
    return mod.make_random_tdnn(input_dim=12, output_dim=30, hidden_dim=16,
                                num_layers=3, seed=5)


def _tdnn_component(mod):
    """A TdnnComponent net: integer-vector TimeOffsets, bool and float
    scalars, a dim-range node."""
    rng = np.random.RandomState(3)
    nodes = {
        "input": mod.Node("input", "input", dim=4),
        "tdnn": mod.Node("component", "tdnn", component="tdnn",
                         descriptor=mod.parse_descriptor("input")),
        "half": mod.Node("dim-range", "half",
                         descriptor=mod.parse_descriptor("tdnn"), dim=3,
                         dim_offset=2),
        "output": mod.Node("output", "output",
                           descriptor=mod.parse_descriptor("half")),
    }
    comps = {"tdnn": mod.Component("TdnnComponent", {
        "TimeOffsets": np.array([-1, 0, 2], np.int64),
        "LinearParams": (rng.randn(6, 12) * 0.2).astype(np.float32),
        "BiasParams": (rng.randn(6) * 0.1).astype(np.float32),
        "OrthonormalConstraint": -1.0, "UseNaturalGradient": "T"})}
    return mod.Nnet3(nodes, ["input", "tdnn", "half", "output"], comps)


NETS = {"substitute_tdnn": _tdnn, "tdnn_component": _tdnn_component}


def _same_net(got, want, desc_got, desc_want):
    assert got.node_order == want.node_order
    for name, a in want.nodes.items():
        b = got.nodes[name]
        assert (a.kind, a.dim, a.component, a.dim_offset) == (
            b.kind, b.dim, b.component, b.dim_offset)
        if a.descriptor is not None:
            assert desc_got(b.descriptor) == desc_want(a.descriptor)
    assert list(got.components) == list(want.components)
    for name, comp in want.components.items():
        other = got.components[name]
        assert other.kind == comp.kind and other.attrs.keys() == \
            comp.attrs.keys()
        for key, val in comp.attrs.items():
            if isinstance(val, np.ndarray):
                assert other.attrs[key].dtype == val.dtype, (name, key)
                np.testing.assert_array_equal(other.attrs[key], val)
            elif isinstance(val, float):  # stored as float32 or float64
                assert np.float32(other.attrs[key]) == np.float32(val), (
                    name, key)
            else:
                assert other.attrs[key] == val, (name, key)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_binary_round_trip_across_packages(tmp_path, net, writer):
    """One package writes the binary model, the other reads it: identical
    arrays and scalars, a forward within 1e-5 of the writer's."""
    path = str(tmp_path / "final.raw")
    if writer == "jax":
        j_bin.write_nnet3_binary(NETS[net](j_nnet3), path)
    else:
        t_bin.write_nnet3_binary(NETS[net](t_nnet3), path)
    with open(path, "rb") as f:
        assert f.read(2) == b"\x00B"
    net_t, net_j = t_nnet3.load_nnet3(path), j_nnet3.load_nnet3(path)
    _same_net(net_t, net_j, t_nnet3._descriptor_str, j_nnet3._descriptor_str)
    _same_net(net_t, NETS[net](t_nnet3), t_nnet3._descriptor_str,
              t_nnet3._descriptor_str)
    in_dim = net_t.nodes["input"].dim
    x = np.random.RandomState(7).randn(11, in_dim).astype(np.float32)
    got = net_t.forward(torch.from_numpy(x)).numpy()
    want = np.asarray(net_j.forward(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _blob(tmp_path):
    path = str(tmp_path / "net.raw")
    t_bin.write_nnet3_binary(_tdnn(t_nnet3), path)
    with open(path, "rb") as f:
        return f.read()


def _load(tmp_path, data):
    bad = str(tmp_path / "bad.raw")
    with open(bad, "wb") as f:
        f.write(data)
    return t_nnet3.load_nnet3(bad)


@pytest.mark.parametrize("cut", [0, 1, 2, 5, 0.1, 0.3, 0.5, 0.8, 0.97, -2])
def test_truncated_binary_raises_value_error(tmp_path, cut):
    """A binary model cut short anywhere (an empty file, a lone \\x00, the
    header, inside the graph, inside a matrix, inside </Nnet3>) raises
    ValueError, as the JAX package's reader does.  An int is a byte count
    (negative: from the end), a float a fraction of the file."""
    blob = _blob(tmp_path)
    n = int(cut * len(blob)) if isinstance(cut, float) else cut % len(blob)
    with pytest.raises(ValueError):
        _load(tmp_path, blob[:n])
    with pytest.raises(ValueError):
        j_nnet3.load_nnet3(str(tmp_path / "bad.raw"))


def _overwrite_count(blob):
    off = blob.index(b"<NumComponents>") + len(b"<NumComponents> ") + 1
    return blob[:off] + struct.pack("<i", 2 ** 30) + blob[off + 4:]


def _bad_bool(blob):
    """A TdnnComponent's <UseNaturalGradient> byte that is neither T nor F."""
    return blob.replace(b"<UseNaturalGradient> T", b"<UseNaturalGradient> Q")


@pytest.mark.parametrize("corrupt", ["magic", "count", "token", "bool",
                                     "int_vector", "fuzz"])
def test_malformed_binary_raises_declared_types(tmp_path, corrupt):
    """Corrupt headers, counts, tokens, bools and integer vectors raise
    ValueError / KaldiIOError; 150 seeded byte-level mutations (flips,
    zeroed, inserted, deleted bytes) parse or raise ValueError only."""
    blob = _blob(tmp_path)
    if corrupt == "fuzz":
        rng = np.random.RandomState(0x5EED)
        for _ in range(150):
            buf = bytearray(blob)
            i = rng.randint(len(buf))
            op = rng.randint(4)
            if op == 0:
                buf[i] ^= 1 << rng.randint(8)
            elif op == 1:
                buf[i] = 0
            elif op == 2:
                buf.insert(i, rng.randint(256))
            else:
                del buf[i]
            try:
                _load(tmp_path, bytes(buf))
            except ValueError:
                pass
        return
    if corrupt in ("bool", "int_vector"):
        path = str(tmp_path / "tdnn.raw")
        t_bin.write_nnet3_binary(_tdnn_component(t_nnet3), path)
        with open(path, "rb") as f:
            blob = f.read()
    bad = {
        "magic": lambda b: b"\x00Z" + b[2:],
        "count": _overwrite_count,
        "token": lambda b: b.replace(b"<ComponentName>", b"<ComponentNome>",
                                     1),
        "bool": _bad_bool,
        "int_vector": lambda b: b.replace(b"<TimeOffsets> \x04",
                                          b"<TimeOffsets> \x05", 1),
    }[corrupt](blob)
    assert bad != blob
    with pytest.raises(ValueError):
        _load(tmp_path, bad)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The substitute bundle at a tiny width with its AM also in binary,
    the JAX and port dependencies on the binary AM, and a seeded wav."""
    root = tmp_path_factory.mktemp("bundle")
    make_bundle(str(root), n_senones=24, n_phones=6, hidden_dim=16,
                num_layers=2)
    am_bin = str(root / "am" / "final.raw")
    j_bin.write_nnet3_binary(
        j_nnet3.load_nnet3(str(root / "am" / "final.raw.txt")), am_bin)
    paths = dict(nnet_path=am_bin, lda_path=str(root / "feats/final.mat"),
                 reduce_dim_path=str(root / "feats/reduce_dim.mat"),
                 splice_opts_path=str(root / "feats/splice_opts"))
    rng = np.random.RandomState(8)
    t = np.arange(11200) / 16000.0
    wav = (np.sin(2 * np.pi * 170 * t) * 7000 + rng.randn(len(t)) * 400)
    wav_path = str(root / "u.wav")
    wavfile.write(wav_path, 16000, wav.astype(np.int16))
    return (t_ppg.DependenciesPPG(**paths), j_ppg.DependenciesPPG(**paths),
            wav_path)


@pytest.mark.parametrize("fn", ["reduce_ppg_dim", "compute_monophone_ppg",
                                "compute_full_ppg_wrapper", "get_ppg"])
def test_ppg_functions_match_jax(bundle, monkeypatch, fn):
    """Each PPG entry function on the binary AM, the port on the CPU, both
    packages with their numpy MFCC (the same dither draws; the native
    library has its own generator), dither 1.0 seed 3: within 1e-5."""
    for ppg_mod, mfcc_mod in ((j_ppg, j_mfcc), (t_ppg, t_mfcc)):
        monkeypatch.setattr(
            ppg_mod, "compute_mfcc",
            lambda *a, _m=mfcc_mod, **k: _m.compute_mfcc(
                *a, backend="numpy", **k))
    deps_t, deps_j, wav_path = bundle
    np.testing.assert_array_equal(deps_t.monophone_trans,
                                  deps_j.monophone_trans)
    fs, wav = wavfile.read(wav_path)
    kw = dict(dither=1.0, seed=3)
    if fn == "reduce_ppg_dim":
        ppgs = np.random.RandomState(1).rand(17, 24).astype(np.float32)
        got = t_ppg.reduce_ppg_dim(ppgs, deps_t.monophone_trans)
        want = j_ppg.reduce_ppg_dim(ppgs, deps_j.monophone_trans)
    elif fn == "compute_monophone_ppg":
        got = t_ppg.compute_monophone_ppg(
            wav, fs, deps_t.nnet, deps_t.lda, deps_t.monophone_trans,
            device="cpu", **kw)
        want = j_ppg.compute_monophone_ppg(
            wav, fs, deps_j.nnet, deps_j.lda, deps_j.monophone_trans, **kw)
    elif fn == "compute_full_ppg_wrapper":
        got = t_ppg.compute_full_ppg_wrapper(wav, fs, deps_t.nnet,
                                             deps_t.lda, device="cpu", **kw)
        want = j_ppg.compute_full_ppg_wrapper(wav, fs, deps_j.nnet,
                                              deps_j.lda, **kw)
    else:
        got = t_ppg.get_ppg(wav_path, deps_t, device="cpu", **kw)
        want = j_ppg.get_ppg(wav_path, deps_j, **kw)
    assert got.shape == want.shape and got.shape[0] > 10
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_ppg_functions_default_to_the_card(bundle, monkeypatch):
    """device=None means CUDA: without a card get_ppg raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deps_t, _, wav_path = bundle
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ppg.get_ppg(wav_path, deps_t)
