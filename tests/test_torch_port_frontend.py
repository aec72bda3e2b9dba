"""The port's front end (MFCC, features, nnet3 AM, PPG, Kaldi I/O and the
substitute bundle) against the JAX package on the CPU, and the port's
independence of JAX.

Tolerances: MFCCs and LDA features atol 1e-4 (both numpy float64 paths;
the slack is for float32 storage); nnet3 forward atol 1e-5 in f32.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fac_via_ppg_torch import native as t_native
from fac_via_ppg_torch.frontend import kaldi_io as t_io
from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import nnet3 as t_nnet3
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle as t_bundle
from fac_via_ppg_tpu.frontend import kaldi_io as j_io
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import nnet3 as j_nnet3
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle as j_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(fs, seconds, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(fs * seconds)) / fs
    return 2000 * np.sin(2 * np.pi * 220 * t) + 300 * rng.randn(len(t))


def _opts(mod, snip_edges):
    return mod.MfccOptions(
        frame_opts=mod.FrameExtractionOptions(
            snip_edges=snip_edges, allow_downsample=True, dither=0.0),
        use_energy=False)


@pytest.mark.parametrize("fs,snip_edges", [(16000, False), (16000, True),
                                           (22050, False)])
def test_compute_mfcc_matches_jax_numpy(fs, snip_edges):
    wav = _wav(fs, 0.7, 1)
    ref = j_mfcc.compute_mfcc(wav, fs, _opts(j_mfcc, snip_edges),
                              backend="numpy")
    out = t_mfcc.compute_mfcc(wav, fs, _opts(t_mfcc, snip_edges),
                              backend="numpy")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


def test_mfcc_tables_match_jax():
    fo_t, fo_j = t_mfcc.FrameExtractionOptions(), j_mfcc.FrameExtractionOptions()
    np.testing.assert_array_equal(t_mfcc.feature_window(fo_t),
                                  j_mfcc.feature_window(fo_j))
    np.testing.assert_array_equal(t_mfcc.dct_matrix(13, 23),
                                  j_mfcc.dct_matrix(13, 23))
    np.testing.assert_array_equal(t_mfcc.lifter_coeffs(13, 22.0),
                                  j_mfcc.lifter_coeffs(13, 22.0))
    for n in (399, 400, 16000):
        assert t_mfcc.num_frames(n, fo_t) == j_mfcc.num_frames(n, fo_j)
        np.testing.assert_array_equal(t_mfcc.frame_indices(n, fo_t),
                                      j_mfcc.frame_indices(n, fo_j))
    wav = _wav(44100, 0.2, 2)
    np.testing.assert_allclose(
        t_mfcc.resample_waveform(wav, 44100, 16000),
        j_mfcc.resample_waveform(wav, 44100, 16000), atol=1e-6)


def test_dither_is_seeded():
    wav = _wav(16000, 0.3, 3)
    opts = t_mfcc.MfccOptions(frame_opts=t_mfcc.FrameExtractionOptions(
        snip_edges=False, dither=1.0), use_energy=False)
    a = t_mfcc.compute_mfcc(wav, 16000, opts, seed=5)
    np.testing.assert_array_equal(a, t_mfcc.compute_mfcc(wav, 16000, opts,
                                                         seed=5))
    assert not np.array_equal(a, t_mfcc.compute_mfcc(wav, 16000, opts,
                                                     seed=6))


def test_features_match_jax_numpy(monkeypatch):
    """MFCC -> CMN -> splice +-3 -> LDA, with both packages' MFCC held to
    their numpy backends (the native one agrees only to 1e-3)."""
    rng = np.random.RandomState(4)
    lda = np.linalg.qr(rng.randn(91, 40))[0].T.astype(np.float32)
    wav = _wav(16000, 0.9, 5)
    for ppg_mod, mfcc_mod in ((j_ppg, j_mfcc), (t_ppg, t_mfcc)):
        monkeypatch.setattr(
            ppg_mod, "compute_mfcc",
            lambda *a, _m=mfcc_mod, **k: _m.compute_mfcc(
                *a, backend="numpy", **k))
    ref = j_ppg.compute_feat_for_nnet_internal(wav, 16000, lda, dither=0.0)
    out = t_ppg.compute_feat_for_nnet_internal(wav, 16000, lda, dither=0.0)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


def _nets(**kw):
    args = dict(input_dim=40, output_dim=24, hidden_dim=16, num_layers=2,
                seed=9, **kw)
    return t_nnet3.make_random_tdnn(**args), j_nnet3.make_random_tdnn(**args)


def test_make_random_tdnn_draws_match_jax():
    net_t, net_j = _nets()
    assert net_t.node_order == net_j.node_order
    for name, comp in net_j.components.items():
        assert net_t.components[name].kind == comp.kind
        for k, v in comp.param_arrays().items():
            np.testing.assert_array_equal(
                net_t.components[name].attrs[k], v)


def test_nnet3_forward_batched_matches_jax():
    net_t, net_j = _nets()
    feats = np.random.RandomState(6).randn(3, 30, 40).astype(np.float32)
    out = net_t.forward(torch.from_numpy(feats)).numpy()
    for b in range(3):
        np.testing.assert_allclose(
            out[b], np.asarray(net_j.forward(jnp.asarray(feats[b]))),
            atol=1e-5, rtol=0)
    assert (net_t.left_context(), net_t.right_context()) == (
        net_j.left_context(), net_j.right_context())


def test_nnet3_text_round_trip_across_packages(tmp_path):
    """Each package reads what the other writes, to the same network."""
    net_t, net_j = _nets()
    t_nnet3.write_nnet3_text(net_t, str(tmp_path / "t.txt"))
    j_nnet3.write_nnet3_text(net_j, str(tmp_path / "j.txt"))
    assert filecmp.cmp(tmp_path / "t.txt", tmp_path / "j.txt", shallow=False)
    back_t = t_nnet3.load_nnet3(str(tmp_path / "j.txt"))
    back_j = j_nnet3.load_nnet3(str(tmp_path / "t.txt"))
    feats = np.random.RandomState(7).randn(20, 40).astype(np.float32)
    np.testing.assert_allclose(
        back_t.forward(torch.from_numpy(feats)).numpy(),
        np.asarray(back_j.forward(jnp.asarray(feats))), atol=1e-5, rtol=0)


def test_nnet3_descriptors_match_jax():
    for text in ("Append(Offset(a, -1), a, Offset(a, 2))",
                 "Sum(Scale(0.5, a), Offset(b, -3))",
                 "Round(a, 3)", "Const(0.25, 4)"):
        assert (t_nnet3.parse_descriptor(text).__dict__.keys()
                == j_nnet3.parse_descriptor(text).__dict__.keys())
        assert repr(t_nnet3.parse_descriptor(text)) == repr(
            j_nnet3.parse_descriptor(text))


COMPONENTS = [
    ("AffineComponent", lambda r: {"LinearParams": r.randn(5, 6),
                                   "BiasParams": r.randn(5)}),
    ("LinearComponent", lambda r: {"Params": r.randn(5, 6)}),
    ("RectifiedLinearComponent", lambda r: {}),
    ("SigmoidComponent", lambda r: {}),
    ("TanhComponent", lambda r: {}),
    ("SoftmaxComponent", lambda r: {}),
    ("LogSoftmaxComponent", lambda r: {}),
    ("NoOpComponent", lambda r: {}),
    ("DropoutComponent", lambda r: {"DropoutProportion": 0.3}),
    ("BatchNormComponent", lambda r: {"Dim": 6, "BlockDim": 3,
                                      "StatsMean": r.randn(3),
                                      "StatsVar": r.rand(3) + 0.5,
                                      "Epsilon": 1e-3, "TargetRms": 0.7}),
    ("NormalizeComponent", lambda r: {"InputDim": 6, "TargetRms": 1.0,
                                      "AddLogStddev": "T"}),
    ("PnormComponent", lambda r: {"InputDim": 6, "OutputDim": 3}),
    ("FixedScaleComponent", lambda r: {"Scales": r.randn(6)}),
    ("FixedBiasComponent", lambda r: {"Bias": r.randn(6)}),
    ("TdnnComponent", lambda r: {"TimeOffsets": np.array([-1, 0, 2]),
                                 "LinearParams": r.randn(4, 18),
                                 "BiasParams": r.randn(4)}),
    ("SumGroupComponent", lambda r: {"Sizes": np.array([2, 1, 3])}),
    ("ScaleAndOffsetComponent", lambda r: {"Scales": r.randn(6),
                                           "Offsets": r.randn(6)}),
    ("PermuteComponent", lambda r: {"ColumnMap": np.array([5, 0, 1, 4, 2, 3])}),
    ("ClipGradientComponent", lambda r: {}),
]


@pytest.mark.parametrize("kind,attrs", COMPONENTS, ids=[k for k, _ in COMPONENTS])
def test_apply_component_matches_jax(kind, attrs):
    rng = np.random.RandomState(8)
    a = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
             and v.dtype.kind == "f" else v) for k, v in attrs(rng).items()}
    x = rng.randn(7, 6).astype(np.float32)
    ref = j_nnet3.apply_component(j_nnet3.Component(kind, a), jnp.asarray(x))
    out = t_nnet3.apply_component(t_nnet3.Component(kind, a),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)


def test_compute_full_ppg_matches_jax():
    net_t, net_j = _nets()
    feats = np.random.RandomState(9).randn(37, 40).astype(np.float32)
    out = t_ppg.compute_full_ppg(net_t, feats, device="cpu")
    ref = j_ppg.compute_full_ppg(net_j, feats)
    assert out.shape == (37, 24)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_compute_full_ppg_defaults_to_the_card(monkeypatch):
    """device=None means CUDA: without a card it raises, not a quiet CPU
    run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net_t, _ = _nets()
    feats = np.zeros((5, 40), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ppg.compute_full_ppg(net_t, feats)


def test_substitute_bundle_is_identical_to_jax(tmp_path):
    kw = dict(n_senones=24, n_phones=4, hidden_dim=8, num_layers=1)
    t_bundle(str(tmp_path / "t"), **kw)
    j_bundle(str(tmp_path / "j"), **kw)
    for rel in ("am/final.raw.txt", "am/phones.txt", "feats/final.mat",
                "feats/reduce_dim.mat", "feats/splice_opts",
                "arpa_phonemes"):
        assert filecmp.cmp(tmp_path / "t" / rel, tmp_path / "j" / rel,
                           shallow=False), rel
    deps = t_ppg.DependenciesPPG(
        nnet_path=str(tmp_path / "t/am/final.raw.txt"),
        lda_path=str(tmp_path / "t/feats/final.mat"),
        reduce_dim_path=str(tmp_path / "t/feats/reduce_dim.mat"),
        splice_opts_path=str(tmp_path / "t/feats/splice_opts"))
    np.testing.assert_array_equal(
        deps.lda, j_io.read_matrix(str(tmp_path / "j/feats/final.mat")))
    np.testing.assert_array_equal(
        deps.monophone_trans,
        j_io.read_sparse_matrix(str(tmp_path / "j/feats/reduce_dim.mat")))
    assert (deps.left_context, deps.right_context) == ("3", "3")


def test_kaldi_io_round_trip_across_packages(tmp_path):
    rng = np.random.RandomState(10)
    mat = rng.randn(4, 7).astype(np.float32)
    t_io.write_matrix(str(tmp_path / "m"), mat)
    np.testing.assert_array_equal(j_io.read_matrix(str(tmp_path / "m")), mat)
    sparse = np.zeros((3, 9), np.float32)
    sparse[[0, 1, 2, 2], [1, 4, 0, 8]] = [1.0, 2.5, -1.0, 3.0]
    j_io.write_sparse_matrix(str(tmp_path / "s"), sparse)
    np.testing.assert_array_equal(t_io.read_sparse_matrix(str(tmp_path / "s")),
                                  sparse)


def test_port_imports_no_jax():
    """Importing the whole port must not pull in JAX or the JAX package."""
    code = (
        "import sys, pkgutil, importlib, fac_via_ppg_torch\n"
        "for m in pkgutil.walk_packages(fac_via_ppg_torch.__path__,"
        " 'fac_via_ppg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fac_via_ppg_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('native', 'eval.streaming', 'models.decode_graph',\n"
        "          'train.losses', 'train.optim', 'train.step',\n"
        "          'train.checkpoint', 'train.preemption', 'train.logger',\n"
        "          'train.plotting', 'train.profiling', 'data.prefetch',\n"
        "          'data.ppg_mel_dataset', 'data.mel2samp', 'utils.pitch',\n"
        "          'utils.tree', 'scripts.train_ppg2mel',\n"
        "          'scripts.train_waveglow', 'frontend.mfcc',\n"
        "          'frontend.ppg', 'frontend.kaldi_io',\n"
        "          'frontend.kaldi_models', 'frontend.decode',\n"
        "          'eval.featurize_bench', 'scripts.make_corpus',\n"
        "          'scripts.mel2samp_dump', 'train.precision',\n"
        "          'train.convert_model', 'train.export_torch',\n"
        "          'bench', 'eval.rtf', 'eval.roofline', 'eval.parity',\n"
        "          'eval.duration_check', 'utils.compilation_cache',\n"
        "          'io.utterance', 'parallel', 'parallel.mesh',\n"
        "          'parallel.sharding', 'parallel.spawn',\n"
        "          'scripts.multiproc', 'parallel.tp', 'graft_entry'):\n"
        "    assert 'fac_via_ppg_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---------------------------------------------------------- native MFCC

@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_native_mfcc_matches_jax_native_and_numpy(dither):
    """The port's own build of native/src/frontend.cc against the JAX
    package's build of it, at the same seed (the same generator: equal
    within float32 rounding), and against numpy at dither 0 (1e-3, the
    JAX package's stated agreement)."""
    wav = _wav(16000, 0.8, 6)

    def opts(mod):
        return mod.MfccOptions(frame_opts=mod.FrameExtractionOptions(
            snip_edges=False, allow_downsample=True, dither=dither),
            use_energy=False)

    got = t_mfcc.compute_mfcc(wav, 16000, opts(t_mfcc), seed=3,
                              backend="native")
    want = j_mfcc.compute_mfcc(wav, 16000, opts(j_mfcc), seed=3,
                               backend="native")
    assert got.shape == want.shape == (80, 13)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if dither == 0.0:
        ref = t_mfcc.compute_mfcc(wav, 16000, opts(t_mfcc), backend="numpy")
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got, t_mfcc.compute_mfcc(
            wav, 16000, opts(t_mfcc), seed=3, backend="native"))


def test_native_library_is_the_ports_own():
    """Built from the shared source into the port's git-ignored build
    directory, never into native/build/; served calls are counted."""
    assert t_native.available()
    assert str(t_native.SOURCE) == os.path.join(REPO, "native", "src",
                                                "frontend.cc")
    assert str(t_native.LIBRARY.parent) == os.path.join(
        REPO, "fac_via_ppg_torch", "build")
    assert t_native._lib._name == str(t_native.LIBRARY)
    n0 = t_native.calls
    t_mfcc.compute_mfcc(_wav(16000, 0.2, 7), 16000, _opts(t_mfcc, False))
    assert t_native.calls == n0 + 1  # "auto" took the library


def test_native_backend_raises_where_auto_takes_numpy(monkeypatch):
    """'auto' takes numpy only where the JAX package does (an option
    combination the library does not implement, or no library); 'native'
    raises in both cases."""
    wav = _wav(16000, 0.3, 8)
    odd = t_mfcc.MfccOptions(frame_opts=t_mfcc.FrameExtractionOptions(
        round_to_power_of_two=False, dither=0.0), use_energy=False)
    assert not t_native.supports(odd)
    with pytest.raises(ValueError, match="not implemented"):
        t_mfcc.compute_mfcc(wav, 16000, odd, backend="native")
    np.testing.assert_array_equal(
        t_mfcc.compute_mfcc(wav, 16000, odd),
        t_mfcc.compute_mfcc(wav, 16000, odd, backend="numpy"))
    opts = _opts(t_mfcc, False)
    monkeypatch.setattr(t_native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        t_mfcc.compute_mfcc(wav, 16000, opts, backend="native")
    np.testing.assert_array_equal(
        t_mfcc.compute_mfcc(wav, 16000, opts),
        t_mfcc.compute_mfcc(wav, 16000, opts, backend="numpy"))
    with pytest.raises(ValueError, match="unknown MFCC backend"):
        t_mfcc.compute_mfcc(wav, 16000, opts, backend="cuda")
