"""Parity harness: mel-MSE between this port and reference checkpoints (the
port of fac_via_ppg_tpu/eval/parity.py).

The comparison path is the deterministic teacher-forced forward
(autoregressive synthesis draws prenet dropout by design, reference
model.py:134, so it cannot be compared pointwise).  Given a Tacotron2
checkpoint (the reference's `.pt`, or the port's trainer's) and wavs:
  1. load the checkpoint (utils/inference.load_tacotron2_model),
  2. extract the PPG and the ground-truth mel of each utterance,
  3. run the port's teacher-forced forward with dropout off,
  4. optionally run the reference's own torch model the same way (a CPU
     oracle read from its sources, named by FACPPG_REFERENCE_SRC,
     eval/reference_oracle.py; without them ReferenceUnavailable),
  5. report per-utterance and mean mel-MSE.

CLI (on the card unless --cpu):
    python -m fac_via_ppg_torch.eval.parity --checkpoint ckpt.pt \\
        --filelist wavs.txt [--against-torch-oracle] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from fac_via_ppg_torch.configs.hparams import (
    Tacotron2Config,
    create_hparams_stage,
)
from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.frontend import ppg as ppg_mod
from fac_via_ppg_torch.models import tacotron2 as t2
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.inference import _device_of, load_tacotron2_model
from fac_via_ppg_torch.weights import move


def mel_mse(a: np.ndarray, b: np.ndarray) -> float:
    """MSE over the overlapping frames of two (n_mel, T) log-mels."""
    n = min(a.shape[-1], b.shape[-1])
    return float(np.mean((a[..., :n] - b[..., :n]) ** 2))


def teacher_forced_mel(cfg: Tacotron2Config, params, model_state,
                       ppg: np.ndarray, mel: np.ndarray) -> np.ndarray:
    """Deterministic (dropout-free) teacher-forced postnet mel (80, T) of a
    (T_in, D) PPG and an (80, T) mel, on the device of `params`."""
    dev = _device_of(params)
    orig = t2.dropout
    t2.dropout = lambda x, rate, keep_mask=None, generator=None: x
    try:
        with torch.no_grad():
            (_, mel_post, _, _), _ = t2.tacotron2_forward(
                cfg, params, model_state,
                torch.as_tensor(np.asarray(ppg, np.float32).T[None],
                                device=dev),
                torch.tensor([ppg.shape[0]], device=dev),
                torch.as_tensor(np.asarray(mel, np.float32)[None],
                                device=dev),
                torch.tensor([mel.shape[1]], device=dev), training=False)
    finally:
        t2.dropout = orig
    return mel_post[0].cpu().numpy()


def extract_features(wav_path: str, hparams, deps, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(PPG (T, D) at dither 0, log-mel (n_mel, T)) of one wav, on
    `device` (None: the card)."""
    dev = resolve_device(device)
    _, wav = feat_mod.read_wav(wav_path)
    ppg = ppg_mod.get_ppg(wav_path, deps, dither=0.0, device=dev)
    stft = TacotronSTFT(
        hparams.filter_length, hparams.hop_length, hparams.win_length,
        hparams.n_acoustic_feat_dims, hparams.sampling_rate,
        hparams.mel_fmin, hparams.mel_fmax,
    )
    audio_norm = torch.as_tensor(
        np.asarray(wav, np.float32) / hparams.max_wav_value,
        device=dev)[None]
    mel = stft.mel_spectrogram(audio_norm)[0].cpu().numpy()
    return ppg, mel


def run_parity(checkpoint: str, filelist: str,
               against_torch_oracle: bool = False,
               t2_kw: Optional[dict] = None,
               deps: Optional[ppg_mod.DependenciesPPG] = None,
               device=None) -> dict:
    """`t2_kw` -- size overrides applied to BOTH sides (this port's config
    and the oracle's create_hparams_stage); empty = the full-size stage
    configuration.  `deps` -- an already-loaded AM bundle (defaults to the
    repo data/ bundle).  `device` None means the card."""
    dev = resolve_device(device)
    hparams = create_hparams_stage(**(t2_kw or {}))
    cfg = Tacotron2Config.from_hparams(hparams)
    params, model_state = load_tacotron2_model(checkpoint, cfg)
    params, model_state = move(params, dev), move(model_state, dev)

    deps = deps or ppg_mod.DependenciesPPG()
    with open(filelist) as f:
        wavs = [line.strip() for line in f if line.strip()]

    per_utt: List[dict] = []
    for wav_path in wavs:
        ppg, mel = extract_features(wav_path, hparams, deps, dev)
        mine = teacher_forced_mel(cfg, params, model_state, ppg, mel)
        entry = {"wav": wav_path, "mse_vs_target": mel_mse(mine, mel)}
        if against_torch_oracle:
            ref = _torch_oracle_mel(checkpoint, hparams, ppg, mel)
            entry["mse_vs_reference_model"] = mel_mse(mine, ref)
        per_utt.append(entry)

    out = {"per_utterance": per_utt}
    for key in ("mse_vs_target", "mse_vs_reference_model"):
        vals = [u[key] for u in per_utt if key in u]
        if vals:
            out["mean_" + key] = float(np.mean(vals))
    return out


def _torch_oracle_mel(checkpoint: str, hparams, ppg: np.ndarray,
                      mel: np.ndarray) -> np.ndarray:
    """Teacher-forced mel from the reference's torch model (CPU)."""
    import torch.nn.functional as F

    from fac_via_ppg_torch.eval.reference_oracle import (
        reference_tacotron2_module,
    )

    ref_model = reference_tacotron2_module().Tacotron2(hparams)
    payload = torch.load(checkpoint, map_location="cpu", weights_only=False)
    ref_model.load_state_dict(payload["state_dict"])
    ref_model.eval()
    # The reference's parse_decoder_outputs crashes at batch size 1 (the
    # per-step gate_output.squeeze() drops the batch dim, model.py:481);
    # duplicate the utterance to batch 2 and keep the first output.  Its
    # prenet hardcodes training=True (model.py:134): dropout off here.
    ppg2 = np.repeat(ppg.T[None], 2, axis=0)
    mel2 = np.repeat(mel[None], 2, axis=0)
    orig = F.dropout
    F.dropout = lambda x, p=0.5, training=False, inplace=False: x
    try:
        with torch.no_grad():
            outputs = ref_model((
                torch.tensor(ppg2).float(),
                torch.tensor([ppg.shape[0]] * 2),
                torch.tensor(mel2).float(),
                ppg.shape[0],
                torch.tensor([mel.shape[1]] * 2),
            ))
    finally:
        F.dropout = orig
    return outputs[1][0].numpy()


def main(argv=None):
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--against-torch-oracle", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    result = run_parity(args.checkpoint, args.filelist,
                        args.against_torch_oracle,
                        device="cpu" if args.cpu else None)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
