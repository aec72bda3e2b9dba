"""The port's device front end (frontend/mfcc.py::MfccTorch,
frontend/ppg.py::DeviceFeaturizer, PPGMelDataset(featurize_device=True),
eval/featurize_bench.py) against the JAX package on the CPU, at a tiny
substitute AM (24 senones, 6 phones, 1 x 8).

Tolerances: MFCC rtol 1e-3, atol 2e-2 (the JAX package's own MfccJax
against numpy bound); posteriors atol 5e-5 at dither 0 (the JAX package's
DeviceFeaturizer against its host path bound); mels of the two datasets
atol 1e-4 (the two packages' STFTs, as in test_torch_port_train_data.py),
and the port's device and host datasets' mels bit for bit.
"""

import functools

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from fac_via_ppg_torch.configs.hparams import create_hparams as t_hparams
from fac_via_ppg_torch.data import ppg_mel_dataset as t_ds
from fac_via_ppg_torch.eval import featurize_bench as t_bench
from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_tpu.configs.hparams import create_hparams as j_hparams
from fac_via_ppg_tpu.data import ppg_mel_dataset as j_ds
from fac_via_ppg_tpu.eval import featurize_bench as j_bench
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle

LENGTHS = (0.61, 0.40, 0.83)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundle")
    make_bundle(str(root), n_senones=24, n_phones=6, hidden_dim=8,
                num_layers=1)
    files = dict(
        nnet_path=str(root / "am" / "final.raw.txt"),
        lda_path=str(root / "feats" / "final.mat"),
        reduce_dim_path=str(root / "feats" / "reduce_dim.mat"),
        splice_opts_path=str(root / "feats" / "splice_opts"))
    return files, t_ppg.DependenciesPPG(**files), \
        j_ppg.DependenciesPPG(**files)


def _wavs(fs, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(fs * s)) * 3000).astype(np.float64)
            for s in LENGTHS]


def _mfcc_opts(mod, use_energy=False):
    return mod.MfccOptions(
        frame_opts=mod.FrameExtractionOptions(
            snip_edges=False, allow_downsample=True, dither=0.0),
        use_energy=use_energy)


@pytest.mark.parametrize("n_samples", [6999, 12345, 16001])
@pytest.mark.parametrize("use_energy", [False, True])
def test_mfcc_torch_matches_mfcc_jax(n_samples, use_energy):
    wav = np.random.RandomState(n_samples).randn(n_samples) * 3000
    want = np.asarray(j_mfcc.MfccJax(_mfcc_opts(j_mfcc, use_energy))(
        jnp.asarray(wav, jnp.float32), n_samples))
    got = t_mfcc.MfccTorch(_mfcc_opts(t_mfcc, use_energy),
                           device="cpu")(wav)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-2)
    host = t_mfcc.compute_mfcc(wav, 16000, _mfcc_opts(t_mfcc, use_energy),
                               backend="numpy")
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-3, atol=2e-2)


def test_mfcc_torch_dither_follows_its_generator():
    wav = np.random.RandomState(0).randn(8000) * 3000
    opts = t_mfcc.MfccOptions(frame_opts=t_mfcc.FrameExtractionOptions(
        snip_edges=False, dither=1.0), use_energy=False)
    m = t_mfcc.MfccTorch(opts, device="cpu")

    def run(seed):
        return m(wav, torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    # no generator: no dither, as MfccJax without a key
    plain = t_mfcc.MfccTorch(_mfcc_opts(t_mfcc), device="cpu")(wav)
    assert torch.equal(m(wav), plain)


@pytest.mark.parametrize("fs", [16000, 22050])
def test_device_featurizer_matches_jax_and_host_path(bundle, fs):
    """Ragged lengths, max_batch=2 (two chunks), and a 22.05 kHz input
    that resamples on the host."""
    _, t_deps, j_deps = bundle
    wavs = _wavs(fs)
    got = t_ppg.DeviceFeaturizer(t_deps, dither=0.0, device="cpu")(
        wavs, fs, max_batch=2)
    want = j_ppg.DeviceFeaturizer(j_deps, dither=0.0)(wavs, fs, max_batch=2)
    host = [t_ppg.compute_full_ppg_wrapper(w, fs, t_deps.nnet, t_deps.lda,
                                           10, dither=0.0, device="cpu")
            for w in wavs]
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [h.shape for h in host]
    assert [g.shape[0] for g in got] == [61, 40, 83]
    for g, w, h in zip(got, want, host):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)
        np.testing.assert_allclose(g, h, atol=5e-5, rtol=0)
        np.testing.assert_allclose(g.sum(axis=1), 1.0, atol=1e-4)


def test_device_featurizer_lda_without_bias_column(bundle):
    """A (40, 91) LDA (no offset column) takes the plain product."""
    _, t_deps, j_deps = bundle
    wavs = _wavs(16000, seed=4)[:2]
    for deps in (t_deps, j_deps):
        deps.lda_full = deps.lda
        deps.lda = deps.lda[:, :91]
    try:
        got = t_ppg.DeviceFeaturizer(t_deps, dither=0.0, device="cpu")(
            wavs, 16000)
        want = j_ppg.DeviceFeaturizer(j_deps, dither=0.0)(wavs, 16000)
    finally:
        for deps in (t_deps, j_deps):
            deps.lda = deps.lda_full
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)


def test_device_featurizer_dither_is_seeded(bundle):
    _, t_deps, _ = bundle
    wavs = _wavs(16000)
    feat = t_ppg.DeviceFeaturizer(t_deps, dither=1.0, device="cpu")
    a = feat(wavs, 16000, seed=1, max_batch=2)
    b = feat(wavs, 16000, seed=1, max_batch=2)
    c = feat(wavs, 16000, seed=2, max_batch=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(not np.array_equal(x, y) for x, y in zip(a, c))


def test_device_featurizer_refuses_upsampling(bundle):
    _, t_deps, _ = bundle
    with pytest.raises(ValueError, match="Sample rate"):
        t_ppg.DeviceFeaturizer(t_deps, device="cpu")(_wavs(8000), 8000)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(9)
    paths = []
    for i, s in enumerate(LENGTHS):
        t = np.arange(int(16000 * s)) / 16000.0
        sig = np.sin(2 * np.pi * (140 + 40 * i) * t) * 0.5
        wav = (sig * 12000 + 300 * rng.randn(len(t))).astype(np.int16)
        paths.append(str(root / f"utt{i}.wav"))
        wavfile.write(paths[-1], 16000, wav)
    filelist = str(root / "files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return filelist


def test_ppg_mel_dataset_featurize_device_matches_jax(bundle, corpus,
                                                      monkeypatch):
    """Both datasets with featurize_device=True, both featurizers' dither
    set to 0."""
    files, t_deps, j_deps = bundle
    monkeypatch.setattr(t_ds, "DeviceFeaturizer", functools.partial(
        t_ppg.DeviceFeaturizer, dither=0.0))
    monkeypatch.setattr(j_ppg, "DeviceFeaturizer", functools.partial(
        j_ppg.DeviceFeaturizer, dither=0.0))
    kw = dict(training_files=corpus, featurize_device=True)
    port = t_ds.PPGMelDataset(corpus, t_hparams(**kw), deps=t_deps,
                              device="cpu")
    ref = j_ds.PPGMelDataset(corpus, j_hparams(**kw), deps=j_deps)
    host = t_ds.PPGMelDataset(corpus, t_hparams(training_files=corpus),
                              deps=t_deps, device="cpu")
    assert port.data_utterance_paths == ref.data_utterance_paths
    assert len(port) == len(ref) == 3
    for i in range(3):
        (p_ppg, p_mel), (r_ppg, r_mel) = port[i], ref[i]
        assert p_ppg.shape == r_ppg.shape == host[i][0].shape
        np.testing.assert_allclose(p_ppg, r_ppg, atol=5e-5, rtol=0)
        np.testing.assert_allclose(p_mel, r_mel, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(p_mel, host[i][1])


def test_ppg_mel_dataset_featurize_device_refuses_mixed_rates(
        bundle, corpus, tmp_path):
    _, t_deps, _ = bundle
    odd = str(tmp_path / "odd.wav")
    wavfile.write(odd, 22050, np.zeros(22050, np.int16))
    filelist = str(tmp_path / "mixed.txt")
    with open(corpus) as f:
        first = f.readline().strip()
    with open(filelist, "w") as f:
        f.write(f"{first}\n{odd}\n")
    with pytest.raises(ValueError, match="mixed corpus sample rates"):
        t_ds.PPGMelDataset(filelist, t_hparams(featurize_device=True),
                           deps=t_deps, device="cpu")


def test_featurize_bench_tiny(bundle):
    _, t_deps, j_deps = bundle
    out = t_bench.run_bench(n_utts=4, seconds=0.5, deps=t_deps,
                            device="cpu")
    assert out["device"] == "cpu"
    assert out["host_utts_per_s"] > 0 and out["device_utts_per_s"] > 0
    assert out["max_abs_err"] < 5e-5
    assert len(out["host_s_runs"]) == len(out["device_s_runs"]) == \
        t_bench.REPEATS
    assert out["device_s"] == float(np.median(out["device_s_runs"]))
    # the same corpus as the JAX package's harness
    for a, b in zip(t_bench.synth_corpus(4, 0.5), j_bench.synth_corpus(4, 0.5)):
        np.testing.assert_array_equal(a, b)
