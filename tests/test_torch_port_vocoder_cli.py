"""The port's batched vocoder CLI (scripts/waveglow_inference.py) and its
checkpoint loader against the JAX package's, on the CPU.

The JAX package writes the reference `.pt` checkpoint
(train/export_torch); the port reads it.  The JAX CLI reads an orbax
checkpoint of the same params.  At tests/test_waveglow_inference_cli.py's
TINY config, with nonzero end convs: with zero ones and sigma 0 both
would write silence.  Tolerances: loaded weights folded from (g, v) within
8 ulp (XLA and torch sum the norm's squares in different orders; the
other leaves bit for bit); wavs within 1 int16 step (f32, the same
arithmetic in another order, then truncated to int16).
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWaveGlowConfig
from fac_via_ppg_torch.scripts import waveglow_inference as t_cli
from fac_via_ppg_torch.utils.inference import load_waveglow_model
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.scripts import waveglow_inference as j_cli
from fac_via_ppg_tpu.train.checkpoint import save_checkpoint
from fac_via_ppg_tpu.train.export_torch import (
    export_waveglow_state_dict,
    save_reference_waveglow_checkpoint,
)
from fac_via_ppg_tpu.train.import_torch import (
    import_waveglow_state_dict,
    load_reference_waveglow_checkpoint,
)

TINY = {
    "n_mel_channels": 80, "hop_length": 160, "n_flows": 2, "n_group": 8,
    "n_early_every": 4, "n_early_size": 2,
    "WN_config": {"n_layers": 2, "n_channels": 16, "kernel_size": 3},
}
CFG, TCFG = WaveGlowConfig.from_dict(TINY), TWaveGlowConfig.from_dict(TINY)


def _train_params(seed=0):
    """JAX train-form params (weight norm (g, v)) with nonzero end convs."""
    params = jwg.init_waveglow(jax.random.PRNGKey(seed), CFG)
    rng = np.random.RandomState(seed)
    for wn in params["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.02, jnp.float32)
    return params


def _write_pt(path, params, form):
    if form == "module":
        save_reference_waveglow_checkpoint(str(path), params, CFG)
    else:
        torch.save(export_waveglow_state_dict(params, CFG), str(path))


@pytest.mark.parametrize("form", ["module", "state_dict"])
def test_loader_reads_jax_exported_checkpoint(tmp_path, form):
    """The port's loader against the JAX package's importer followed by
    its remove_weightnorm, leaf by leaf."""
    params = _train_params()
    path = tmp_path / "waveglow.pt"
    _write_pt(path, params, form)
    ours = load_waveglow_model(str(path), TCFG)
    if form == "module":
        theirs = load_reference_waveglow_checkpoint(str(path), CFG)
    else:  # the JAX loader reads module files only; its importer the dict
        theirs = import_waveglow_state_dict(
            torch.load(str(path), weights_only=True), CFG)
    theirs = jwg.remove_weightnorm(theirs)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    got, want = dict(leaves(ours)), dict(leaves(theirs))
    assert got.keys() == want.keys()
    for name, t in got.items():
        w = np.asarray(want[name])
        assert t.dtype == torch.float32 and tuple(t.shape) == w.shape, name
        if name.endswith("weight_inverse"):
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-6)
        elif "/wn/" in name and name.endswith("weight") and "/end/" not in name:
            np.testing.assert_array_max_ulp(t.numpy(), w, 8)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


def _corpus(tmp_path, lens, pt_every=2):
    """Mel files of the given lengths (randn * 0.5 - 5), every
    `pt_every`-th as the reference's torch-saved .pt, the rest .npy."""
    rs = np.random.RandomState(0)
    files = []
    for i, frames in enumerate(lens):
        mel = (rs.randn(80, frames) * 0.5 - 5).astype(np.float32)
        if i % pt_every == 0:
            path = tmp_path / f"mel{i}.pt"
            torch.save(torch.from_numpy(mel), path)
        else:
            path = tmp_path / f"mel{i}.npy"
            np.save(path, mel)
        files.append(path)
    filelist = tmp_path / "mels.txt"
    filelist.write_text("\n".join(map(str, files)) + "\n")
    return filelist, files


def test_cli_flow_matches_jax_cli(tmp_path):
    """main(device="cpu", wn_impl="flow") against the JAX CLI
    (wn_impl="xla"): mixed lengths in 16-frame buckets, .pt and .npy
    mels, sigma 0, denoiser 0.01, f32.  Every wav as long as JAX's, every
    sample within one int16 step."""
    params = _train_params(1)
    save_checkpoint(str(tmp_path / "ckpt"), params, {}, 1e-4, 0)
    _write_pt(tmp_path / "waveglow.pt", params, "module")
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"waveglow_config": TINY}))
    lens = [24, 30, 17, 24, 33]
    filelist, files = _corpus(tmp_path, lens)

    kw = dict(batch_size=2, config_path=str(config), mel_bucket=16)
    j_cli.main(str(filelist), str(tmp_path / "ckpt"), str(tmp_path / "j"),
               0.0, 0.01, wn_impl="xla", **kw)
    n0 = t_cli.wn_flow.launches
    summary = t_cli.main(str(filelist), str(tmp_path / "waveglow.pt"),
                         str(tmp_path / "t"), 0.0, 0.01, wn_impl="flow",
                         device="cpu", **kw)
    assert t_cli.wn_flow.launches == n0     # the CPU takes the plain net
    assert sum(b["rows"] for b in summary["batches"]) == len(lens)
    assert summary["audio_s"] == pytest.approx(sum(lens) * 160 / 16000)
    for f, frames in zip(files, lens):
        name = f.name + "_synthesis.wav"
        sr_t, got = wavfile.read(tmp_path / "t" / name)
        sr_j, want = wavfile.read(tmp_path / "j" / name)
        assert sr_t == sr_j == 16000 and got.dtype == np.int16
        assert len(got) == len(want) == frames * CFG.hop_length
        assert np.abs(want).max() > 0
        assert np.abs(got.astype(np.int32) - want).max() <= 1, name


def test_cli_bf16_int8_auto_runs(tmp_path):
    """bf16, --cond_impl auto (the gate calibrates on the first mels),
    --pad_batches full: int16 wavs of the right length, not silent."""
    _write_pt(tmp_path / "waveglow.pt", _train_params(2), "state_dict")
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"waveglow_config": TINY}))
    lens = [20, 20, 20]
    filelist, files = _corpus(tmp_path, lens, pt_every=3)
    summary = t_cli.main(str(filelist), str(tmp_path / "waveglow.pt"),
                         str(tmp_path / "out"), 0.6, 0.005, batch_size=2,
                         compute_dtype="bfloat16", cond_impl="auto",
                         snr_budget_db=0.0, config_path=str(config),
                         pad_batches="full", device="cpu")
    assert [b["rows"] for b in summary["batches"]] == [2, 2]
    for f in files:
        sr, wav = wavfile.read(tmp_path / "out" / (f.name + "_synthesis.wav"))
        assert sr == 16000 and wav.dtype == np.int16
        assert len(wav) == 20 * CFG.hop_length
        assert np.isfinite(wav.astype(np.float64)).all() and wav.std() > 0


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """device=None means CUDA: without a card the CLI raises before it
    reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(str(tmp_path / "none.txt"), str(tmp_path / "none.pt"),
                   str(tmp_path / "out"), 0.6, 0.0)


def test_bucket_mels_matches_jax():
    mels = [("a", np.arange(10, dtype=np.float32).reshape(2, 5)),
            ("b", np.ones((2, 8), np.float32)),
            ("c", np.ones((2, 3), np.float32))]
    for bucket in (0, 8):
        got, want = t_cli.bucket_mels(mels, bucket), \
            j_cli.bucket_mels(mels, bucket)
        assert [(f, t) for f, _, t in got] == [(f, t) for f, _, t in want]
        for (_, m_t, _), (_, m_j, _) in zip(got, want):
            np.testing.assert_array_equal(m_t, m_j)
