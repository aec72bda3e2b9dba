"""The port's training data path against the JAX package on the CPU: the
collate and EpochBatcher (exactly), the delta / F0 features, PPGMelDataset
on 3 seeded wavs with a substitute AM (PPG and mel atol 1e-4; both
packages' MFCC held to their numpy backends, whose seeded dither draws
agree), Mel2Samp (segments exactly, mel atol 1e-5) and the prefetcher.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fac_via_ppg_tpu.configs.hparams import create_hparams as j_hparams
from fac_via_ppg_tpu.data import mel2samp as j_m2s
from fac_via_ppg_tpu.data import ppg_mel_dataset as j_ds
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.utils import pitch as j_pitch

from fac_via_ppg_torch.configs.hparams import create_hparams as t_hparams
from fac_via_ppg_torch.data import mel2samp as t_m2s
from fac_via_ppg_torch.data import ppg_mel_dataset as t_ds
from fac_via_ppg_torch.data.prefetch import prefetch, to_device
from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle
from fac_via_ppg_torch.utils import pitch as t_pitch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small ops: the suite runs several
    workers on the CPU, and oversubscribed threads slow it manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, lengths, dim=7):
    rng = np.random.RandomState(seed)
    return [(rng.rand(t_in, dim).astype(np.float32),
             rng.randn(t_out, 5).astype(np.float32))
            for t_in, t_out in lengths]


@pytest.mark.parametrize("pad_to", [1, 8, 32])
def test_collate_matches_jax_exactly(pad_to):
    batch = _pairs(0, [(5, 7), (9, 11), (3, 4), (9, 10)])
    got = t_ds.ppg_acoustics_collate(batch, pad_to=pad_to)
    want = j_ds.ppg_acoustics_collate(batch, pad_to=pad_to)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_batcher_order_matches_jax(drop_last):
    data = _pairs(1, [(4 + i % 5, 6 + i % 3) for i in range(11)])
    kw = dict(drop_last=drop_last, pad_to=4)
    port = t_ds.EpochBatcher(data, 3, 7, t_ds.ppg_acoustics_collate, **kw)
    jax_ = j_ds.EpochBatcher(data, 3, 7, j_ds.ppg_acoustics_collate, **kw)
    assert len(port) == len(jax_)
    for _ in range(3):  # the order changes with the epoch, in step
        got, want = list(port), list(jax_)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert port.epoch == jax_.epoch == 3


def test_dynamic_features_and_append_ppg_match_jax():
    rng = np.random.RandomState(2)
    m = rng.randn(13, 3)
    np.testing.assert_array_equal(
        t_ds.compute_delta_acc_feat(m, True, True),
        j_ds.compute_delta_acc_feat(m, True, True))
    feats = rng.rand(20, 6).astype(np.float32)
    f0 = np.abs(rng.randn(22)) * 100
    np.testing.assert_array_equal(t_ds.append_ppg(feats, f0),
                                  j_ds.append_ppg(feats, f0))
    with pytest.raises(ValueError, match="delta-delta"):
        t_ds.compute_delta_acc_feat(m, False, True)
    ppg = rng.rand(9, 4).astype(np.float32)
    np.testing.assert_array_equal(t_ds.utt_to_sequence(ppg),
                                  j_ds.utt_to_sequence(ppg))


def test_pitch_copy_matches_jax():
    t = np.arange(8000) / 16000.0
    wav = np.sin(2 * np.pi * 140 * t) * 8000 + np.random.RandomState(3) \
        .randn(8000) * 50
    np.testing.assert_array_equal(
        t_pitch.estimate_f0(wav, 16000, frame_shift_ms=10.0),
        j_pitch.estimate_f0(wav, 16000, frame_shift_ms=10.0))


# ---------------------------------------------------------- PPGMelDataset

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(4)
    paths = []
    for i in range(3):
        t = np.arange(int(16000 * (0.3 + 0.05 * i))) / 16000.0
        sig = np.sin(2 * np.pi * (150 + 30 * i) * t) * 0.5
        wav = (sig * 12000 + 200 * rng.randn(len(t))).astype(np.int16)
        p = str(root / f"utt{i}.wav")
        wavfile.write(p, 16000, wav)
        paths.append(p)
    filelist = str(root / "files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    make_bundle(str(root / "bundle"), n_senones=24, n_phones=6,
                hidden_dim=8, num_layers=1)
    files = dict(
        nnet_path=str(root / "bundle" / "am" / "final.raw.txt"),
        lda_path=str(root / "bundle" / "feats" / "final.mat"),
        reduce_dim_path=str(root / "bundle" / "feats" / "reduce_dim.mat"),
        splice_opts_path=str(root / "bundle" / "feats" / "splice_opts"))
    return filelist, files, root


@pytest.fixture
def numpy_mfcc(monkeypatch):
    """Both packages' MFCC on their numpy backends (the same seeded
    dither draws; the native library draws its own)."""
    for ppg_mod, mfcc_mod in ((j_ppg, j_mfcc), (t_ppg, t_mfcc)):
        monkeypatch.setattr(
            ppg_mod, "compute_mfcc",
            lambda *a, _m=mfcc_mod, **k: _m.compute_mfcc(
                *a, backend="numpy", **k))


@pytest.mark.parametrize("full_ppg", [True, False])
def test_ppg_mel_dataset_matches_jax(corpus, numpy_mfcc, full_ppg):
    filelist, files, _ = corpus
    kw = dict(training_files=filelist, is_full_ppg=full_ppg)
    port = t_ds.PPGMelDataset(filelist, t_hparams(**kw),
                              deps=t_ppg.DependenciesPPG(**files),
                              device="cpu")
    ref = j_ds.PPGMelDataset(filelist, j_hparams(**kw),
                             deps=j_ppg.DependenciesPPG(**files))
    assert port.data_utterance_paths == ref.data_utterance_paths
    assert len(port) == len(ref) == 3
    for i in range(3):
        (p_ppg, p_mel), (r_ppg, r_mel) = port[i], ref[i]
        assert p_ppg.shape == r_ppg.shape and p_mel.shape == r_mel.shape
        assert p_ppg.shape[1] == (24 if full_ppg else 6)
        np.testing.assert_allclose(p_ppg, r_ppg, atol=1e-4, rtol=0)
        np.testing.assert_allclose(p_mel, r_mel, atol=1e-4, rtol=0)


def test_ppg_mel_dataset_f0_cache_and_subsampling(corpus, numpy_mfcc):
    """is_append_f0 appends log-F0 + delta + acc; the pickle cache
    round-trips; ppg_subsampling_factor takes every k-th row."""
    filelist, files, root = corpus
    cache = str(root / "feats.pkl")
    deps = t_ppg.DependenciesPPG(**files)
    ds = t_ds.PPGMelDataset(filelist, t_hparams(
        is_append_f0=True, is_cache_feats=True, feats_cache_path=cache),
        deps=deps, device="cpu")
    assert ds[0][0].shape[1] == 24 + 3
    again = t_ds.PPGMelDataset(filelist, t_hparams(
        is_append_f0=True, load_feats_from_disk=True,
        feats_cache_path=cache, ppg_subsampling_factor=2), device="cpu")
    np.testing.assert_array_equal(again[1][0], ds[1][0][::2])
    np.testing.assert_array_equal(again[1][1], ds[1][1])
    with pytest.raises(ValueError, match="do not rewrite"):
        t_ds.PPGMelDataset(filelist, t_hparams(
            is_cache_feats=True, load_feats_from_disk=True), device="cpu")


def test_unported_device_featurizer_and_missing_card_raise(corpus):
    """featurize_device=True now runs the device front end (on the CPU
    here): the same utterances and frame counts as the host path; the
    dataset still raises where CUDA is asked for and absent."""
    filelist, files, _ = corpus
    deps = t_ppg.DependenciesPPG(**files)
    dev = t_ds.PPGMelDataset(filelist, t_hparams(featurize_device=True),
                             deps=deps, device="cpu")
    host = t_ds.PPGMelDataset(filelist, t_hparams(), deps=deps,
                              device="cpu")
    assert len(dev) == len(host) == 3
    for i in range(3):
        assert dev[i][0].shape == host[i][0].shape
        np.testing.assert_array_equal(dev[i][1], host[i][1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_ds.PPGMelDataset(filelist, t_hparams(),
                               deps=t_ppg.DependenciesPPG(**files))


# --------------------------------------------------------------- Mel2Samp

def test_mel2samp_matches_jax(tmp_path):
    """Seeded file order, crops (long files) and zero-padding (short
    ones) exactly, in JAX's draw order; the mel within 1e-5."""
    rng = np.random.RandomState(5)
    paths = []
    for i, n in enumerate([3000, 1500, 2600, 900]):
        p = str(tmp_path / f"w{i}.wav")
        wavfile.write(p, 16000, (rng.randn(n) * 3000).astype(np.int16))
        paths.append(p)
    filelist = str(tmp_path / "files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    cfg = dict(training_files=filelist, segment_length=2048,
               filter_length=256, hop_length=64, win_length=256,
               sampling_rate=16000, mel_fmin=0.0, mel_fmax=8000.0,
               n_mel_channels=16)
    port, ref = t_m2s.Mel2Samp(**cfg), j_m2s.Mel2Samp(**cfg)
    assert port.audio_files == ref.audio_files
    items = []
    for _ in range(2):  # the second pass draws new crops from the cache
        for i in range(len(ref)):
            (pm, pa), (rm, ra) = port[i], ref[i]
            np.testing.assert_array_equal(pa, ra)
            assert pa.shape == (2048,)
            np.testing.assert_allclose(pm, rm, atol=1e-5, rtol=0)
            items.append((pm, pa))
    mels, audio = t_m2s.mel2samp_collate(items[:3])
    want = j_m2s.mel2samp_collate(items[:3])
    np.testing.assert_array_equal(mels, want[0])
    np.testing.assert_array_equal(audio, want[1])


# --------------------------------------------------------------- prefetch

def test_prefetch_keeps_order_and_places_on_the_cpu():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i)
               for i in range(7)]
    got = list(prefetch(iter(batches), to_device(torch.device("cpu"),
                                                  {0: torch.bfloat16})))
    assert len(got) == 7
    for i, (a, b) in enumerate(got):
        assert a.dtype == torch.bfloat16 and a.device.type == "cpu"
        assert torch.equal(a.float(), torch.full((2, 3), float(i)))
        assert b.tolist() == [i, i + 1]


def test_prefetch_raises_the_workers_error():
    def source():
        yield 1
        raise OSError("disk gone")

    it = iter(prefetch(source(), depth=1))
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
