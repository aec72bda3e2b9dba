"""The port's synthesis surface against the JAX package on the CPU, at tiny
widths: the hparams registry, the mel front end (filterbank, TacotronSTFT,
Griffin-Lim), the reference-format Tacotron2 checkpoints, the inference
helpers, FusedSynthesizer's int8 and auto cond modes and the synthesis
CLI (scripts/generate_synthesis.py).

Inputs are seeded numpy arrays fed to both packages; randomness is
injected: the prenet keep-masks recorded from the JAX run, the WaveGlow
noise from `int8_snr.matched_noise`.  Tolerances: filterbank 1e-6;
log-mels, Griffin-Lim, mels and audio 1e-4 (f32 arithmetic in another
order); checkpoints bit for bit; fused PCM within 2 int16 steps (f32 PCM
scaled by 32767, then truncated); the auto gate's SNR within 0.1 dB.
"""

import functools
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.dsp import mel as t_mel
from fac_via_ppg_torch.dsp import stft as t_stft
from fac_via_ppg_torch.eval import int8_snr as t_snr
from fac_via_ppg_torch.eval.fused import FusedSynthesizer as TFused
from fac_via_ppg_torch.frontend import nnet3 as t_nnet3
from fac_via_ppg_torch.frontend import ppg as t_ppg
from fac_via_ppg_torch.frontend.nnet3_binary import write_nnet3_binary
from fac_via_ppg_torch.models import init_tacotron2 as t_init_tacotron2
from fac_via_ppg_torch.models import init_waveglow as t_init_waveglow
from fac_via_ppg_torch.models.waveglow import \
    remove_weightnorm as t_remove_weightnorm
from fac_via_ppg_torch.scripts import generate_synthesis as gs
from fac_via_ppg_torch.train import export_torch as t_export
from fac_via_ppg_torch.train import import_torch as t_import
from fac_via_ppg_torch.utils import inference as t_inf
from fac_via_ppg_tpu.configs import hparams as j_hp
from fac_via_ppg_tpu.dsp import mel as j_mel
from fac_via_ppg_tpu.dsp import stft as j_stft
from fac_via_ppg_tpu.eval import fused as j_fused
from fac_via_ppg_tpu.eval import int8_snr as j_snr
from fac_via_ppg_tpu.frontend import mfcc as j_mfcc
from fac_via_ppg_tpu.frontend import ppg as j_ppg
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.scripts.make_substitute_am import make_bundle
from fac_via_ppg_tpu.train import export_torch as j_export
from fac_via_ppg_tpu.train import import_torch as j_import
from fac_via_ppg_tpu.utils import inference as j_inf
from tests.torch_port_helpers import TINY_T2, record_prenet_masks

# max_decoder_steps 14: a config of its own, so the JAX package's cached
# jitted decoder is traced here, with the mask recorder in place
T2 = dict(TINY_T2, max_decoder_steps=14)
WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
MAX_FRAMES = 8


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, t in got.items():
        w = want[name]
        assert t.dtype == w.dtype and t.shape == w.shape, name
        assert torch.equal(t, w), name


@pytest.fixture(scope="module")
def models():
    """Tiny seeded Tacotron2 (gate held off) and WaveGlow (remove_weightnorm
    form, nonzero end convs), drawn by the port and handed to the JAX
    package as the same arrays; the port's trees are
    weights.*_from_jax of the JAX ones."""
    g = torch.Generator().manual_seed(0)
    tp, ts = t_init_tacotron2(t_hp.Tacotron2Config(**T2), g)
    tp["decoder"]["gate_layer"]["bias"].fill_(-30.0)
    wg = t_init_waveglow(t_hp.WaveGlowConfig(**WG), g)
    for wn in wg["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.05
    wg = t_remove_weightnorm(wg)

    def to_jax(tree):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)

    t2_params, t2_state, wg = to_jax(tp), to_jax(ts), to_jax(wg)
    return dict(t2=(j_hp.Tacotron2Config(**T2), t2_params, t2_state),
                wg=(j_hp.WaveGlowConfig(**WG), wg),
                t_t2=weights.tacotron2_from_jax(t2_params, t2_state),
                t_wg=weights.waveglow_from_jax(wg))


# ------------------------------------------------------------------ hparams

@pytest.mark.parametrize("fn", ["create_hparams", "create_hparams_stage"])
def test_hparams_match_jax(fn):
    """The same dict, defaults and overrides, and the same ValueError on an
    unknown key."""
    kw = dict(seed=3, max_decoder_steps=77, compute_dtype="bfloat16")
    assert vars(getattr(t_hp, fn)()) == vars(getattr(j_hp, fn)())
    assert vars(getattr(t_hp, fn)(**kw)) == vars(getattr(j_hp, fn)(**kw))
    for mod in (t_hp, j_hp):
        with pytest.raises(ValueError, match="not supported"):
            getattr(mod, fn)(no_such_key=1)
    hp = getattr(t_hp, fn)(**TINY_T2)
    assert t_hp.Tacotron2Config.from_hparams(hp) == t_hp.Tacotron2Config(
        **TINY_T2)


# ------------------------------------------------------------ mel and STFT

@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (16000, 1024, 80, 0.0, 8000.0), (22050, 512, 40, 55.0, None)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    got = t_mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    want = j_mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _audio(n, seed, batch=2):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return np.stack([0.4 * np.sin(2 * np.pi * (180 + 60 * b) * t)
                     + 0.05 * rng.randn(n) for b in range(batch)]
                    ).astype(np.float32)


def test_tacotron_stft_matches_jax():
    """log-mel spectrogram, magnitude and the dynamic-range pair."""
    kw = dict(filter_length=1024, hop_length=160, win_length=1024,
              n_mel_channels=80, sampling_rate=16000, mel_fmin=0.0,
              mel_fmax=8000.0)
    y = _audio(8000, 4)
    ts, js = t_stft.TacotronSTFT(**kw), j_stft.TacotronSTFT(**kw)
    np.testing.assert_array_equal(ts.mel_basis, js.mel_basis)
    got = ts.mel_spectrogram(torch.from_numpy(y)).numpy()
    want = np.asarray(js.mel_spectrogram(jnp.asarray(y)))
    assert got.shape == want.shape == (2, 80, 51)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        ts.stft_fn.magnitude(torch.from_numpy(y)).numpy(),
        np.asarray(js.stft_fn.magnitude(jnp.asarray(y))), atol=1e-4, rtol=0)
    x = torch.from_numpy(np.abs(y) + 1e-7)
    np.testing.assert_allclose(
        ts.spectral_normalize(x).numpy(),
        np.asarray(js.spectral_normalize(jnp.asarray(x.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        ts.spectral_de_normalize(x).numpy(),
        np.asarray(js.spectral_de_normalize(jnp.asarray(x.numpy()))),
        rtol=1e-6)


def test_griffin_lim_matches_jax():
    """8 iterations from the JAX package's own initial phases."""
    stft_t, stft_j = t_stft.STFT(256, 64, 256), j_stft.STFT(256, 64, 256)
    mag = np.asarray(stft_j.transform(jnp.asarray(_audio(4000, 5)))[0])
    seed = 3
    angles = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), mag.shape, minval=-np.pi, maxval=np.pi
    ).astype(jnp.float32))
    want = np.asarray(j_stft.griffin_lim(jnp.asarray(mag), stft_j, 8, seed))
    got = t_stft.griffin_lim(torch.from_numpy(mag), stft_t, 8,
                             angles=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    g = torch.Generator().manual_seed(0)
    assert t_stft.griffin_lim(torch.from_numpy(mag), stft_t, 1,
                              generator=g).shape == got.shape


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tacotron2_checkpoint_across_packages(models, tmp_path, writer):
    """A reference-format Tacotron2 .pt written by one package loads in the
    other tensor for tensor; the port's tree is weights.tacotron2_from_jax
    of the JAX import; iteration and learning rate survive."""
    cfg, params, state = models["t2"]
    tcfg = t_hp.Tacotron2Config(**T2)
    path = str(tmp_path / "t2.pt")
    if writer == "jax":
        j_export.save_reference_tacotron2_checkpoint(
            path, params, state, cfg, iteration=12, learning_rate=3e-4)
    else:
        t_export.save_reference_tacotron2_checkpoint(
            path, *models["t_t2"], tcfg, iteration=12, learning_rate=3e-4)
    tp, ts, it, lr = t_import.load_reference_tacotron2_checkpoint(path, tcfg)
    jp, js, it_j, lr_j = j_import.load_reference_tacotron2_checkpoint(path,
                                                                      cfg)
    assert (it, lr) == (it_j, lr_j) == (12, 3e-4)
    want_p, want_s = weights.tacotron2_from_jax(jp, js)
    _assert_same_tree(tp, want_p)
    _assert_same_tree(ts, want_s)
    _assert_same_tree(tp, models["t_t2"][0])
    _assert_same_tree(ts, models["t_t2"][1])
    got = t_inf.load_tacotron2_model(path, tcfg)
    _assert_same_tree(got[0], tp)


def _write_wavs(root, lens, seed=6):
    rng = np.random.RandomState(seed)
    paths = []
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        x = np.sin(2 * np.pi * (150 + 40 * i) * t) * 9000 + rng.randn(n) * 300
        paths.append(str(root / f"u{i}.wav"))
        wavfile.write(paths[-1], 16000, x.astype(np.int16))
    return paths


def test_calibration_mel_from_wavs_matches_jax(tmp_path):
    paths = _write_wavs(tmp_path, (9600, 6400, 8000))
    cfg = t_hp.WaveGlowConfig(**WG)
    got = t_snr.calibration_mel_from_wavs(paths, cfg, max_utts=2,
                                          device="cpu")
    want = j_snr.calibration_mel_from_wavs(paths, j_hp.WaveGlowConfig(**WG),
                                           max_utts=2)
    assert tuple(got.shape) == tuple(want.shape) == (2, 80, 41)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text('{"waveglow_config": {"n_flows": 4, '
                        '"WN_config": {"n_channels": 32}}}')
    assert t_snr.waveglow_config_from_json(str(cfg_path)) == \
        t_hp.WaveGlowConfig(n_flows=4, wn_n_channels=32)


# ---------------------------------------------------------------- inference

@pytest.fixture(scope="module")
def jax_mels(models):
    """JAX get_inference on one seeded PPG, unpadded and padded to 16
    frames, with the prenet keep-masks of each run recorded."""
    cfg, params, state = models["t2"]
    seq = np.random.RandomState(11).rand(30, 16).astype(np.float32)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        masks = record_prenet_masks(mp)
        for is_clip, pad in ((False, 0), (True, 0), (False, 16)):
            n0 = len(masks)
            mel = j_inf.get_inference(seq, cfg, params, state,
                                      jax.random.PRNGKey(4), is_clip, pad)
            mel = np.asarray(mel)
            jax.effects_barrier()
            out[(is_clip, pad)] = (mel, masks[n0:])
    return seq, out


@pytest.mark.parametrize("is_clip,pad", [(False, 0), (True, 0), (False, 16)])
def test_get_inference_matches_jax(models, jax_mels, is_clip, pad):
    seq, runs = jax_mels
    want, masks = runs[(is_clip, pad)]
    got = t_inf.get_inference(seq, t_hp.Tacotron2Config(**T2),
                              *models["t_t2"],
                              is_clip=is_clip, pad_to_frames=pad,
                              masks=iter(masks))
    assert tuple(got.shape) == want.shape
    assert want.shape[2] > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pad", [0, 16])
def test_waveglow_audio_matches_jax(models, pad):
    """sigma 0: the audio within 1e-4; as int16 within one step."""
    wg_cfg, wg = models["wg"]
    mel = (np.random.RandomState(12).randn(1, 80, 21) * 0.5 - 4).astype(
        np.float32)
    want = np.asarray(j_inf.waveglow_audio(mel, wg_cfg, wg, 0.0,
                                           pad_to_frames=pad))
    tcfg = t_hp.WaveGlowConfig(**WG)
    got = t_inf.waveglow_audio(torch.from_numpy(mel), tcfg, models["t_wg"],
                               0.0, pad_to_frames=pad)
    assert tuple(got.shape) == want.shape == (1, 21 * 160)
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    pcm = t_inf.waveglow_audio(torch.from_numpy(mel), tcfg, models["t_wg"],
                               0.0, is_int16_output=True, pad_to_frames=pad)
    want16 = (32768.0 * want).astype("int16")
    assert pcm.dtype == np.int16
    assert np.abs(pcm.astype(np.int32) - want16).max() <= 1


# ------------------------------------------------------- fused cond modes

@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny substitute bundle with its AM in binary (written by the
    port), the matching dependency paths and three seeded wavs."""
    root = tmp_path_factory.mktemp("synth")
    make_bundle(str(root / "bundle"), n_senones=16, n_phones=4,
                hidden_dim=8, num_layers=1)
    write_nnet3_binary(
        t_nnet3.load_nnet3(str(root / "bundle/am/final.raw.txt")),
        str(root / "bundle/am/final.raw"))
    paths = dict(
        nnet_path=str(root / "bundle/am/final.raw"),
        lda_path=str(root / "bundle/feats/final.mat"),
        reduce_dim_path=str(root / "bundle/feats/reduce_dim.mat"),
        splice_opts_path=str(root / "bundle/feats/splice_opts"))
    (root / "utts").mkdir()
    return root, paths, _write_wavs(root / "utts", (9600, 6400, 8000))


def test_fused_int8_matches_jax(models, bundle, monkeypatch):
    """cond_impl="int8" (the port on its flow path) against the JAX
    package's int8 fused program, sigma 0.6, f32, with the JAX run's
    prenet keep-masks and one shared set of WaveGlow draws injected."""
    _, paths, wavs = bundle
    monkeypatch.setattr(
        j_ppg, "compute_mfcc",
        lambda *a, **k: j_mfcc.compute_mfcc(*a, backend="numpy", **k))
    wg_cfg, wg = models["wg"]
    noise = j_snr.matched_noise(wg_cfg, 2, MAX_FRAMES, seed=13)
    monkeypatch.setattr(j_fused, "waveglow_infer",
                        functools.partial(jwg.waveglow_infer, noise=noise))
    cfg, params, state = models["t2"]
    jf = j_fused.FusedSynthesizer(
        cfg, params, state, wg_cfg, wg, deps=j_ppg.DependenciesPPG(**paths),
        sigma=0.6, serving_dtype=None, max_frames=MAX_FRAMES,
        cond_impl="int8")
    pairs = [jf.featurize(p, dither=0.0) for p in wavs[:2]]
    masks = record_prenet_masks(monkeypatch)
    want = jf.synthesize_feature_pairs(pairs, jax.random.PRNGKey(5))
    jax.effects_barrier()

    tf = TFused(t_hp.Tacotron2Config(**T2), *models["t_t2"],
                t_hp.WaveGlowConfig(**WG), models["t_wg"],
                deps=t_ppg.DependenciesPPG(**paths), sigma=0.6,
                serving_dtype=None, max_frames=MAX_FRAMES, cond_impl="int8",
                device="cpu")
    assert tf.cond_impl == tf.requested_cond_impl == "int8"
    assert tf._wn_impl == "flow" and tf.calibration_snr_db is None
    got = tf.synthesize_feature_pairs(pairs, dropout_masks=masks,
                                      noise=noise)
    assert len(got) == len(want) == 2
    for o, r in zip(got, want):
        assert o.dtype == np.int16 and len(o) == len(r) == MAX_FRAMES * 160
        assert np.abs(r.astype(np.int32)).max() > 100  # not silence
        assert np.abs(o.astype(np.int32) - r.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("budget,decision", [(0.0, "int8"), (200.0, "dense")])
def test_fused_auto_reaches_jax_decision(models, bundle, budget, decision):
    """cond_impl="auto" on one calibration mel: the JAX package's decision,
    its SNR within 0.1 dB, the same printed line's attributes.  The SNR
    measures bf16 rounding noise, which the two packages place
    differently (the port on its flow path), so the mel is long enough
    (2 x 48 frames) for the two estimates to settle."""
    wg_cfg, wg = models["wg"]
    cfg, params, state = models["t2"]
    mel = (np.random.RandomState(14).randn(2, 80, 48) * 0.5 - 5.0).astype(
        np.float32)
    jf = j_fused.FusedSynthesizer(
        cfg, params, state, wg_cfg, wg,
        deps=j_ppg.DependenciesPPG(**bundle[1]), sigma=0.6,
        serving_dtype=None, cond_impl="auto", calibration_mel=mel,
        snr_budget_db=budget)
    deps = t_ppg.DependenciesPPG(**bundle[1])
    tf = TFused(t_hp.Tacotron2Config(**T2), *models["t_t2"],
                t_hp.WaveGlowConfig(**WG), models["t_wg"], deps=deps,
                sigma=0.6, serving_dtype=None, cond_impl="auto",
                calibration_mel=mel, snr_budget_db=budget, device="cpu")
    assert jf.cond_impl == tf.cond_impl == decision
    assert tf.requested_cond_impl == "auto" and tf.snr_budget_db == budget
    assert abs(tf.calibration_snr_db - jf.calibration_snr_db) <= 0.1
    assert tf._wn_impl == ("flow" if decision == "int8" else "layer")
    with pytest.raises(ValueError, match="calibration_mel"):
        TFused(t_hp.Tacotron2Config(**T2), *models["t_t2"],
               t_hp.WaveGlowConfig(**WG), models["t_wg"], deps=deps,
               cond_impl="auto", device="cpu")


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def cli_inputs(models, bundle):
    """Reference-format checkpoints of the tiny models (Tacotron2 written
    by the JAX package, WaveGlow a port state dict)."""
    root, paths, wavs = bundle
    cfg, params, state = models["t2"]
    t2_pt = str(root / "t2.pt")
    j_export.save_reference_tacotron2_checkpoint(t2_pt, params, state, cfg)
    wg_pt = str(root / "wg.pt")
    torch.save(t_export.export_waveglow_state_dict(
        models["t_wg"], t_hp.WaveGlowConfig(**WG)), wg_pt)
    filelist = root / "utts.txt"
    filelist.write_text("\n".join(wavs[:2]) + "\n")
    return root, paths, wavs, t2_pt, wg_pt, str(filelist)


@pytest.mark.parametrize("route", ["staged", "fused", "dir", "txt_auto",
                                   "int8_needs_fused"])
def test_cli_routes_on_cpu(cli_inputs, monkeypatch, capsys, tmp_path, route):
    """main(argv, device="cpu") at tiny widths on the binary AM: each route
    writes its int16 16 kHz wavs and debug.log; --cond_impl auto prints its
    decision; int8 on one wav without --fused exits."""
    root, paths, wavs, t2_pt, wg_pt, filelist = cli_inputs
    hp = t_hp.create_hparams_stage(**T2)
    monkeypatch.setattr(gs, "create_hparams_stage", lambda **kw: hp)
    monkeypatch.setattr(gs, "WaveGlowConfig",
                        lambda: t_hp.WaveGlowConfig(**WG))
    deps = t_ppg.DependenciesPPG(**paths)
    monkeypatch.setattr(gs.ppg_mod, "DependenciesPPG", lambda: deps)
    out = tmp_path / "out"
    argv = ["--ppg2mel_model", t2_pt, "--waveglow_model", wg_pt,
            "--output_dir", str(out), "--teacher_utterance_path"]
    argv += {"staged": [wavs[0]], "fused": [wavs[0], "--fused"],
             "dir": [str(root / "utts"), "--batch_size", "2"],
             "txt_auto": [filelist, "--cond_impl", "auto",
                          "--snr_budget_db", "0"],
             "int8_needs_fused": [wavs[0], "--cond_impl", "int8"]}[route]
    if route == "int8_needs_fused":
        with pytest.raises(SystemExit, match="needs --fused"):
            gs.main(argv, device="cpu")
        return
    summary = gs.main(argv, device="cpu")
    names = {"staged": ["ac.wav"], "fused": ["ac.wav"],
             "dir": ["ac_u0.wav", "ac_u1.wav", "ac_u2.wav"],
             "txt_auto": ["ac_u0.wav", "ac_u1.wav"]}[route]
    assert summary["outputs"] == [str(out / n) for n in names]
    for name in names:
        fs, audio = wavfile.read(out / name)
        assert fs == 16000 and audio.dtype == np.int16
        assert len(audio) > 0 and audio.std() > 0
    assert os.path.getsize(out / "debug.log") > 0
    if route in ("dir", "txt_auto"):
        assert [b["rows"] for b in summary["batches"]] == (
            [2, 1] if route == "dir" else [2])
    if route == "fused" or route == "dir":
        # the fused program runs every frame: the gate bias is held off
        for name in names:
            assert len(wavfile.read(out / name)[1]) == 14 * 160
    if route == "txt_auto":
        printed = capsys.readouterr().out
        assert "cond_impl=auto" in printed and "serving cond_impl=" in printed
        assert summary["cond_impl"] == "int8"
        assert summary["calibration_snr_db"] is not None


def test_cli_runs_on_the_card_by_default(cli_inputs, monkeypatch, tmp_path):
    """device=None means CUDA: without a card the CLI raises before it
    reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gs.main(["--ppg2mel_model", "none.pt", "--waveglow_model", "none.pt",
                 "--teacher_utterance_path", "x.wav", "--output_dir",
                 str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
