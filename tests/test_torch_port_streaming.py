"""The port's streaming converter (`eval/streaming.py`) on the CPU, at tiny
widths: every behaviour tests/test_streaming.py checks of the JAX
package's (staged and fused pipelines, micro-batching, prewarm and
pipeline depth transparent, error isolation, a lazy source, the off-grid
warning), the whole slice against the JAX converter, and the CLI.

The tests are named `test_torch_streaming_*`: tests/conftest.py marks the
JAX tests' names slow by base name.

Parity: both packages' converters (fused, batch 2, pipeline depth 1,
sigma 0, one front-end thread) over the same 3 wavs, on the same weights
and native MFCC features, with the prenet keep-masks of each JAX launch
recorded and injected into the port's launch of the same batch.  PCM
within 2 int16 LSB (f32 throughout, other summation orders).
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.eval import streaming as ts
from fac_via_ppg_torch.frontend import mfcc as t_mfcc
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.models import init_tacotron2, init_waveglow
from fac_via_ppg_torch.models.waveglow import remove_weightnorm
from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle
from fac_via_ppg_torch.train.export_torch import (
    export_waveglow_state_dict,
    save_reference_tacotron2_checkpoint,
)
from fac_via_ppg_tpu.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_tpu.eval.streaming import StreamingAccentConverter as JConv
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from tests.torch_port_helpers import TINY_T2, record_prenet_masks

WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
# max_decoder_steps 18: a config of its own, so the JAX package's jitted
# program is traced here, with the mask recorder in place
T2 = dict(TINY_T2, max_decoder_steps=18)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tiny bundle, seeded port models (WaveGlow with nonzero end
    convs) and their JAX copies."""
    root = tmp_path_factory.mktemp("stream")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    paths = dict(
        nnet_path=str(root / "bundle/am/final.raw.txt"),
        lda_path=str(root / "bundle/feats/final.mat"),
        reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
        splice_opts_path=str(root / "bundle/feats/splice_opts"))
    g = torch.Generator().manual_seed(0)
    t2_cfg, wg_cfg = t_hp.Tacotron2Config(**T2), t_hp.WaveGlowConfig(**WG)
    tp, tst = init_tacotron2(t2_cfg, g)
    wg = init_waveglow(wg_cfg, g)
    for wn in wg["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.05
    return dict(root=root, paths=paths, deps=t_ppg.DependenciesPPG(**paths),
                t2=(t2_cfg, tp, tst), wg=(wg_cfg, wg),
                wg_serve=remove_weightnorm(wg))


def _wavs(dirname, n, base=4800, step=0, f0=200, df=0):
    out = []
    for i in range(n):
        t = np.arange(base + step * i) / 16000.0
        wav = np.sin(2 * np.pi * (f0 + df * i) * t) * 9000
        path = str(dirname / f"u{i}.wav")
        wavfile.write(path, 16000, wav.astype(np.int16))
        out.append(path)
    return out


def _conv(env, **kw):
    t2_cfg, tp, tst = env["t2"]
    kw.setdefault("denoiser_strength", 0.005)
    return ts.StreamingAccentConverter(
        t2_cfg, tp, tst, env["wg"][0], env["wg_serve"], deps=env["deps"],
        device="cpu", **kw)


def _check(results, n):
    assert len(results) == n
    for r in results:
        assert r.audio.ndim == 1 and len(r.audio) > 0
        assert np.isfinite(r.audio).all()
        assert r.audio_seconds > 0 and r.wall_seconds > 0
        assert r.latency_seconds >= r.wall_seconds - 1e-6


@pytest.mark.parametrize("fused", [False, True])
def test_torch_streaming_pipeline(env, tmp_path, fused):
    wavs = _wavs(tmp_path, 2)
    _check(list(_conv(env, fused=fused).run(wavs)), 2)


def test_torch_streaming_micro_batched(env, tmp_path):
    """batch_size=3 over 5 utterances (one full batch + a padded partial
    flush), two front-end threads."""
    wavs = _wavs(tmp_path, 5, step=320, f0=180, df=30)
    results = list(_conv(env, fused=True, batch_size=3,
                         frontend_threads=2).run(wavs))
    _check(results, 5)
    assert sorted(r.wav_path for r in results) == sorted(wavs)
    with pytest.raises(ValueError):
        _conv(env, fused=False, batch_size=2)
    with pytest.raises(ValueError, match="cond_impl"):
        _conv(env, fused=False, cond_impl="int8")


def test_torch_streaming_prewarm_is_transparent(env, tmp_path):
    """prewarm() (on the card: the decode graphs' capture) runs a dummy
    batch on its own generator and leaves the served audio unchanged."""
    wavs = _wavs(tmp_path, 3, df=20)
    cold = _conv(env, fused=True, batch_size=3)
    baseline = {r.wav_path: r.audio for r in
                cold.run(wavs, torch.Generator().manual_seed(7))}
    warm = _conv(env, fused=True, batch_size=3)
    warm.prewarm(utt_seconds=0.3)
    served = list(warm.run(wavs, torch.Generator().manual_seed(7)))
    assert len(served) == 3
    for r in served:
        np.testing.assert_array_equal(r.audio, baseline[r.wav_path])
    _conv(env, fused=False).prewarm()  # staged: a no-op


def test_torch_streaming_pipeline_depth_is_transparent(env, tmp_path):
    """Micro-batches in flight (pipeline_depth > 1) serve exactly the
    synchronous loop's audio in the same order: the launch order, and so
    the generator's order of use, does not depend on the depth."""
    wavs = _wavs(tmp_path, 7, step=160, f0=190, df=25)

    def run(depth):
        conv = _conv(env, fused=True, batch_size=2, pipeline_depth=depth)
        return list(conv.run(wavs, torch.Generator().manual_seed(11)))

    sync = run(1)
    assert [r.wav_path for r in sync] == wavs  # 3 full batches + partial
    for depth in (2, 3):
        piped = run(depth)
        assert [r.wav_path for r in piped] == wavs
        for a, b in zip(sync, piped):
            np.testing.assert_array_equal(a.audio, b.audio)
            assert b.latency_seconds >= b.wall_seconds - 1e-6


def test_torch_streaming_error_isolation(env, tmp_path):
    """A malformed utterance: on_error='skip' yields an error-annotated
    empty result and serves the rest; 'raise' names the bad file."""
    wavs = _wavs(tmp_path, 5, df=20)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a RIFF file")
    wavs.insert(2, bad)
    results = list(_conv(env, fused=True, batch_size=2,
                         on_error="skip").run(wavs))
    assert len(results) == 6
    failed = [r for r in results if r.error is not None]
    assert len(failed) == 1 and failed[0].wav_path == bad
    assert failed[0].audio.size == 0
    for r in results:
        if r.error is None:
            assert r.audio.size > 0 and np.isfinite(r.audio).all()
    with pytest.raises(RuntimeError, match="bad.wav"):
        list(_conv(env, fused=True, batch_size=2, on_error="raise")
             .run(wavs))
    with pytest.raises(ValueError):
        _conv(env, fused=True, on_error="typo")


def test_torch_streaming_source_is_lazy(env, tmp_path):
    """A generator source is not drained up front: production stays
    bounded by the queue depths while results stream out."""
    wavs = _wavs(tmp_path, 10)
    produced = []

    def live_source():
        for p in wavs:
            produced.append(p)
            yield p

    gen = _conv(env, fused=True, queue_depth=2,
                denoiser_strength=0.0).run(live_source())
    first = next(gen)
    assert first.audio.size > 0
    # path_q(2) + the worker's one + feat_q(2) + the consumed one
    assert len(produced) <= 8, f"drained eagerly: {len(produced)}/10"
    rest = list(gen)
    assert len(rest) == 9 and len(produced) == 10


def test_torch_streaming_off_grid_batch_size_warns(env):
    """An off-grid micro-batch (> 8, not a multiple of 8) warns at
    construction and says how it is padded; grid sizes do not warn."""
    for b, pad, expect in ((12, True, True), (8, True, False),
                           (12, False, True)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            conv = _conv(env, fused=True, batch_size=b, pad_to_grid=pad)
        assert conv.fused.pad_to_grid is pad
        msgs = [str(w.message) for w in rec]
        assert any("tile grid" in m for m in msgs) == expect, (b, msgs)
        if expect and pad:
            assert any("auto-padded to 16" in m for m in msgs)
        elif expect:
            assert any("pad_to_grid=False" in m for m in msgs)


def test_torch_streaming_matches_jax(env, tmp_path, monkeypatch):
    """The whole slice against the JAX converter: wav -> native MFCC ->
    AM -> batched decode -> WaveGlow -> denoiser -> PCM, per batch."""
    wavs = _wavs(tmp_path, 3, base=6400, step=800, f0=150, df=40)
    for mod, mf in ((j_ppg, j_mfcc), (t_ppg, t_mfcc)):
        monkeypatch.setattr(
            mod, "compute_mfcc",
            lambda *a, _mf=mf, **k: _mf.compute_mfcc(*a, backend="native",
                                                     **k))
    t2_cfg, tp, tst = env["t2"]

    def to_jax(tree):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)

    jconv = JConv(Tacotron2Config(**T2), to_jax(tp), to_jax(tst),
                  WaveGlowConfig(**WG), to_jax(env["wg_serve"]),
                  deps=j_ppg.DependenciesPPG(**env["paths"]), sigma=0.0,
                  fused=True, batch_size=2, pipeline_depth=1)
    masks = record_prenet_masks(monkeypatch)
    per_launch = []
    j_launch = jconv.fused.launch_feature_pairs

    def record(pairs, key, **kw):
        n0 = len(masks)
        handle = j_launch(pairs, key, **kw)
        jax.effects_barrier()
        per_launch.append(masks[n0:])
        return handle

    jconv.fused.launch_feature_pairs = record
    want = list(jconv.run(wavs))
    assert len(per_launch) == 2 and all(per_launch)

    tconv = _conv(env, fused=True, batch_size=2, pipeline_depth=1,
                  sigma=0.0)
    t_launch = tconv.fused.launch_feature_pairs
    injected = iter(per_launch)
    tconv.fused.launch_feature_pairs = (
        lambda pairs, gen, **kw: t_launch(pairs, gen,
                                          dropout_masks=next(injected), **kw))
    got = list(tconv.run(wavs))
    assert [r.wav_path for r in got] == [r.wav_path for r in want] == wavs
    for g, w in zip(got, want):
        a = np.round(g.audio * 32767).astype(np.int32)
        b = np.round(np.asarray(w.audio) * 32767).astype(np.int32)
        assert len(a) == len(b) > 0
        assert np.abs(a - b).max() <= 2
        assert np.abs(b).max() > 100  # not silence


def test_torch_streaming_cli_on_cpu(env, tmp_path, monkeypatch, capsys):
    """main(argv, device="cpu") on reference-format checkpoints: a wav per
    input, the per-wav lines, the stream RTF and the latency line."""
    t2_cfg, tp, tst = env["t2"]
    t2_pt, wg_pt = str(tmp_path / "t2.pt"), str(tmp_path / "wg.pt")
    save_reference_tacotron2_checkpoint(t2_pt, tp, tst, t2_cfg)
    torch.save(export_waveglow_state_dict(env["wg"][1], env["wg"][0]), wg_pt)
    wavs = _wavs(tmp_path, 3, df=30)
    filelist = tmp_path / "wavs.txt"
    filelist.write_text("\n".join(wavs) + "\n")
    hp = t_hp.create_hparams_stage(**T2)
    monkeypatch.setattr(ts, "create_hparams_stage", lambda: hp)
    monkeypatch.setattr(ts, "WaveGlowConfig",
                        lambda: t_hp.WaveGlowConfig(**WG))
    monkeypatch.setattr(ts.ppg_mod, "DependenciesPPG", lambda: env["deps"])
    out = tmp_path / "out"
    ts.main(["--ppg2mel_model", t2_pt, "--waveglow_model", wg_pt,
             "--filelist", str(filelist), "--output_dir", str(out),
             "--fused", "--batch_size", "2", "--frontend_threads", "2"],
            device="cpu")
    printed = capsys.readouterr().out
    for w in wavs:
        name = w.rsplit("/", 1)[1].replace(".wav", "_ac.wav")
        fs, audio = wavfile.read(out / name)
        assert fs == 16000 and audio.dtype == np.int16
        assert len(audio) > 0 and audio.std() > 0
        assert f"{out / name}: " in printed
    assert "stream RTF" in printed and "latency p50" in printed


def test_torch_streaming_defaults_to_cuda(env, monkeypatch, tmp_path):
    """device=None means CUDA: without a card the converter and the CLI
    raise before serving anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t2_cfg, tp, tst = env["t2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.StreamingAccentConverter(t2_cfg, tp, tst, env["wg"][0],
                                    env["wg_serve"], deps=env["deps"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.main(["--ppg2mel_model", "none.pt", "--waveglow_model", "none.pt",
                 "--filelist", "none.txt", "--output_dir",
                 str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
