"""Trained-checkpoint fidelity loop (the BASELINE acceptance), the port of
fac_via_ppg_tpu/eval/trained_parity.py.

The BASELINE fidelity target, mel-MSE <= 1e-3 against the reference
implementation, is defined on trained checkpoints.  Given a Tacotron2 and
a WaveGlow checkpoint (the reference's `.pt` / `.pth`, or the port's
trainers' `torch.save` files) and wavs:

  1. load both into the port (train/import_torch, train/checkpoint),
  2. export both to the reference's formats (train/export_torch),
  3. run the reference's own serve path as the oracle, on the CPU, over
     the exported weights (generate_synthesis.py:86-98:
     Tacotron2.inference, model.py:489-535 -> WaveGlow.infer,
     glow.py:252-293 -> Denoiser, denoiser.py:35-68), read from its
     sources (FACPPG_REFERENCE_SRC, eval/reference_oracle.py),
  4. run the port's serve path on the same utterances, on the card (the
     CPU with device="cpu"),
  5. report per-utterance mel-MSE, stop-step agreement, the pointwise
     audio error and an audio log-spectral distance.

The prenet dropout is off on both sides (the decoder's only randomness,
reference model.py:134) and the vocoder's gaussian draws are the
reference's own, so the comparison is pointwise.  The PPGs are the port's
(the reference's pykaldi front end does not run here); the comparison is
of the models' serve path.  Without the reference's sources
ReferenceUnavailable is raised before any work.

CLI (full size; on the card unless --cpu):
  python -m fac_via_ppg_torch.eval.trained_parity \\
      --ppg2mel_model t2.pt --waveglow_model wg.pt \\
      --filelist wavs.txt [--output out.json]
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from fac_via_ppg_torch.configs.hparams import (
    Tacotron2Config,
    WaveGlowConfig,
    create_hparams_stage,
)
from fac_via_ppg_torch.frontend import ppg as ppg_mod
from fac_via_ppg_torch.models.tacotron2 import tacotron2_inference
from fac_via_ppg_torch.models.waveglow import flow_channels, waveglow_infer
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.inference import _device_of


def _log_spectral_distance(a: np.ndarray, b: np.ndarray,
                           n_fft: int = 1024, hop: int = 160) -> float:
    """RMS distance between log-magnitude STFTs (dB) over the overlapping
    samples: the harness's audio-domain measure beside the pointwise max
    error."""
    n = min(len(a), len(b))
    fa = np.abs(np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
        a[:n], n_fft)[::hop] * np.hanning(n_fft), axis=-1))
    fb = np.abs(np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
        b[:n], n_fft)[::hop] * np.hanning(n_fft), axis=-1))
    la, lb = (20 * np.log10(np.maximum(x, 1e-8)) for x in (fa, fb))
    return float(np.sqrt(np.mean((la - lb) ** 2)))


def _matched_noise(wg_cfg: WaveGlowConfig, n_frames: int, seed: int):
    """The gaussians the reference's WaveGlow.infer draws after
    torch.manual_seed(seed) (glow.py:252-293): one (1, remaining, G) draw,
    then one per early output, in draw order, as numpy for
    waveglow_infer(noise=...).  A CPU generator seeded alike draws the
    same values without touching the global one."""
    G = n_frames * wg_cfg.hop_length // wg_cfg.n_group
    shapes = [(1, flow_channels(wg_cfg)[-1], G)] + [
        (1, wg_cfg.n_early_size, G)
        for k in reversed(range(wg_cfg.n_flows))
        if k % wg_cfg.n_early_every == 0 and k > 0
    ]
    g = torch.Generator().manual_seed(seed)
    return [torch.empty(s).normal_(generator=g).numpy() for s in shapes]


def dropout_free_prenets(t2_params: dict):
    """(params, masks) under which tacotron2_inference runs its prenets
    without dropout, through its keep-mask hook: every unit kept, and
    each prenet layer's weight and bias halved, so that a layer's
    2 * relu(y / 2) is relu(y) bit for bit (relu is positively
    homogeneous, halving and doubling are exact).  `masks` keeps every
    unit of the encoder's prenet; the decoder keeps every unit of the
    steps the iterator does not reach."""
    def halve(prenet):
        return {**prenet, "layers": [
            {k: v * 0.5 for k, v in layer.items()}
            for layer in prenet["layers"]]}

    enc, dec = t2_params["encoder"], t2_params["decoder"]
    params = {**t2_params,
              "encoder": {**enc, "prenet": halve(enc["prenet"])},
              "decoder": {**dec, "prenet": halve(dec["prenet"])}}
    keep = torch.tensor(True)
    return params, iter([keep] * len(enc["prenet"]["layers"]))


def reference_serve(oracle, ref_t2, ref_wg, ref_denoiser, ppg: np.ndarray,
                    sigma: float, strength: float, seed: int):
    """The reference's serve path (generate_synthesis.py:86-98) on the
    CPU: (postnet mel, audio) as numpy."""
    with oracle.on_cpu(), torch.no_grad():
        _, mel_post, _, _ = ref_t2.inference(torch.tensor(ppg))
        torch.manual_seed(seed)
        audio = ref_wg.infer(mel_post, sigma=sigma)
        if ref_denoiser is not None and strength > 0:
            audio = ref_denoiser(audio, strength)[:, 0]
    return mel_post.numpy(), audio.numpy()


def framework_serve(t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
                    denoiser, ppg: np.ndarray, sigma: float,
                    strength: float, noise):
    """The port's serve path on the device of `t2_params`, the prenets'
    dropout off (dropout_free_prenets) and the vocoder's noise injected
    (`noise(frames)` in waveglow_infer's order): (postnet mel (1, 80,
    frames), audio, frames), numpy on the host."""
    dev = _device_of(t2_params)
    params, masks = dropout_free_prenets(t2_params)
    with torch.no_grad():
        _, mel_post, _, _, t_end = tacotron2_inference(
            t2_cfg, params, t2_state,
            torch.as_tensor(np.asarray(ppg, np.float32), device=dev),
            masks=masks)
        mel_post = mel_post[:, :, :t_end]
        audio = waveglow_infer(wg_cfg, wg_params, mel_post.to(
            _device_of(wg_params)), sigma, noise=noise(t_end))
        if denoiser is not None and strength > 0:
            audio = denoiser(audio, strength=strength)[:, 0]
    return mel_post.cpu().numpy(), audio.cpu().numpy(), t_end


def _load_waveglow_train_form(path: str, cfg: WaveGlowConfig) -> dict:
    """A WaveGlow checkpoint in its train form: the reference's `.pt` /
    `.pth`, or the port's trainer's (train/checkpoint.py)."""
    if path.endswith((".pt", ".pth")):
        from fac_via_ppg_torch.train.import_torch import (
            load_reference_waveglow_checkpoint,
        )

        return load_reference_waveglow_checkpoint(path, cfg)
    from fac_via_ppg_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(path)["params"]


def _reference_models(oracle, t2_params, t2_state, t2_cfg, t2_kw,
                      wg_train, wg_cfg, denoiser_strength):
    """Both models exported to the reference's formats and loaded by its
    own code: (Tacotron2, WaveGlow with weight norm folded, Denoiser or
    None)."""
    from fac_via_ppg_torch.train.export_torch import (
        save_reference_tacotron2_checkpoint,
        save_reference_waveglow_checkpoint,
    )

    with tempfile.TemporaryDirectory() as td:
        t2_pt, wg_pt = os.path.join(td, "t2.pt"), os.path.join(td, "wg.pt")
        save_reference_tacotron2_checkpoint(t2_pt, t2_params, t2_state,
                                            t2_cfg, iteration=0,
                                            learning_rate=0.0)
        save_reference_waveglow_checkpoint(wg_pt, wg_train, wg_cfg)
        with oracle.on_cpu():
            return _load_reference_models(oracle, t2_pt, wg_pt, t2_kw,
                                          denoiser_strength)


def _load_reference_models(oracle, t2_pt, wg_pt, t2_kw, denoiser_strength):
    """_reference_models' loading half, the reference's own code, which
    runs under oracle.on_cpu()."""
    hparams_mod = oracle.load_reference_module("common.hparams")
    ref_t2 = oracle.reference_tacotron2_module().Tacotron2(
        hparams_mod.create_hparams_stage(**t2_kw))
    payload = torch.load(t2_pt, map_location="cpu", weights_only=False)
    ref_t2.load_state_dict(payload["state_dict"], strict=True)
    ref_t2.eval()
    glow = oracle.load_reference_module("waveglow.glow")
    prev = sys.modules.get("glow")
    sys.modules["glow"] = glow
    try:
        ref_wg = torch.load(wg_pt, map_location="cpu",
                            weights_only=False)["model"]
    finally:
        if prev is not None:
            sys.modules["glow"] = prev
        else:
            del sys.modules["glow"]
    # the reference's serve path folds weight norm first, as
    # utils.py:177-181 calls it
    ref_wg = ref_wg.remove_weightnorm(ref_wg)
    ref_wg.eval()
    ref_den = None
    if denoiser_strength > 0:
        with torch.no_grad():
            ref_den = oracle.load_reference_module(
                "waveglow.denoiser").Denoiser(ref_wg, mode="zeros")
    return ref_t2, ref_wg, ref_den


def run_trained_parity(
    t2_ckpt: str, wg_ckpt: str, wav_paths: List[str],
    t2_kw: Optional[dict] = None, wg_cfg: Optional[WaveGlowConfig] = None,
    deps: Optional[ppg_mod.DependenciesPPG] = None,
    sigma: float = 0.6, denoiser_strength: float = 0.005,
    max_decoder_steps: Optional[int] = None, device=None,
) -> Dict:
    """Both implementations' serve paths on the same checkpoints and
    utterances, and their fidelity metrics.

    `t2_kw` -- size overrides applied to both sides' Tacotron2 (empty: the
    full-size stage configuration); `wg_cfg` -- the WaveGlow's (None: the
    reference's sizes).  `device` None means the card for the port's
    side; the reference runs on the CPU."""
    from fac_via_ppg_torch.eval import reference_oracle as oracle
    from fac_via_ppg_torch.models.denoiser import Denoiser
    from fac_via_ppg_torch.models.waveglow import remove_weightnorm
    from fac_via_ppg_torch.utils.inference import load_tacotron2_model
    from fac_via_ppg_torch.weights import fold_waveglow, move

    # before any work: without the reference there is no comparison
    oracle.load_reference_module("common.hparams")
    dev = resolve_device(device)
    t2_kw = dict(t2_kw or {})
    if max_decoder_steps is not None:
        t2_kw["max_decoder_steps"] = max_decoder_steps
    t2_cfg = Tacotron2Config.from_hparams(create_hparams_stage(**t2_kw))
    wg_cfg = wg_cfg or WaveGlowConfig()
    t2_params, t2_state = load_tacotron2_model(t2_ckpt, t2_cfg)
    wg_train = _load_waveglow_train_form(wg_ckpt, wg_cfg)
    ref_t2, ref_wg, ref_den = _reference_models(
        oracle, t2_params, t2_state, t2_cfg, t2_kw, wg_train, wg_cfg,
        denoiser_strength)
    t2_params, t2_state = move(t2_params, dev), move(t2_state, dev)
    wg_params = move(remove_weightnorm(fold_waveglow(wg_train)), dev)
    denoiser = Denoiser(wg_cfg, wg_params)

    deps = deps or ppg_mod.DependenciesPPG()
    per_utt = []
    for i, wav_path in enumerate(wav_paths):
        ppg = ppg_mod.get_ppg(wav_path, deps, dither=0.0, device=dev)
        ppg_b = ppg.T[None].astype(np.float32)
        seed = 16807 + i
        mine_mel, mine_audio, t_end = framework_serve(
            t2_cfg, t2_params, t2_state, wg_cfg, wg_params, denoiser,
            ppg_b, sigma, denoiser_strength,
            noise=lambda f, s=seed: _matched_noise(wg_cfg, f, s))
        ref_mel, ref_audio = reference_serve(
            oracle, ref_t2, ref_wg, ref_den, ppg_b, sigma,
            denoiser_strength, seed)
        n_ref = ref_mel.shape[-1]
        n = min(t_end, n_ref)
        entry = {
            "wav": wav_path,
            "frames": t_end,
            "frames_reference": n_ref,
            "stop_step_match": bool(t_end == n_ref),
            "mel_mse": float(np.mean(
                (mine_mel[..., :n] - ref_mel[..., :n]) ** 2)),
        }
        if entry["stop_step_match"]:
            a, b = mine_audio[0], ref_audio[0]
            entry["audio_max_abs"] = float(np.abs(a - b).max())
            entry["audio_lsd_db"] = _log_spectral_distance(a, b)
        per_utt.append(entry)

    mses = [u["mel_mse"] for u in per_utt]
    stops = all(u["stop_step_match"] for u in per_utt)
    out = {
        "per_utterance": per_utt,
        "mean_mel_mse": float(np.mean(mses)),
        "max_mel_mse": float(np.max(mses)),
        "all_stop_steps_match": stops,
        "passes_baseline": bool(np.max(mses) <= 1e-3 and stops),
        "target": "mel-MSE <= 1e-3 vs reference implementation "
                  "(BASELINE north star), trained checkpoints",
    }
    lsds = [u["audio_lsd_db"] for u in per_utt if "audio_lsd_db" in u]
    if lsds:
        out["mean_audio_lsd_db"] = float(np.mean(lsds))
    return out


def main(argv=None, device=None):
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--ppg2mel_model", required=True,
                        help="the reference's .pt or the PPG trainer's "
                             "checkpoint")
    parser.add_argument("--waveglow_model", required=True,
                        help="the reference's .pt or the vocoder "
                             "trainer's checkpoint")
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--sigma", type=float, default=0.6)
    parser.add_argument("--denoiser_strength", type=float, default=0.005)
    parser.add_argument("--max_decoder_steps", type=int, default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run the port's side on the CPU instead of "
                             "the card (the reference runs on the CPU "
                             "regardless)")
    args = parser.parse_args(argv)

    with open(args.filelist) as f:
        wavs = [line.strip() for line in f if line.strip()]
    result = run_trained_parity(
        args.ppg2mel_model, args.waveglow_model, wavs,
        sigma=args.sigma, denoiser_strength=args.denoiser_strength,
        max_decoder_steps=args.max_decoder_steps,
        device="cpu" if args.cpu else device)
    text = json.dumps(result, indent=2)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
