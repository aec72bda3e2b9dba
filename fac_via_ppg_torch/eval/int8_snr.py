"""The serving gate of the int8 cond projection (the port of
fac_via_ppg_tpu/eval/int8_snr.py's gate: `select_cond_impl` and its
helpers).

`select_cond_impl` runs the vocoder twice on a calibration batch with the
same noise, f32 with dense cond (the reference) and bf16 with int8 cond
(the serving mode), and keeps int8 only when the worst utterance's SNR
meets the budget.  `calibration_mel_from_wavs` makes that batch from a
deployment's own wavs.  The ladder tool of the JAX package (`run_ladder`,
its CLI) is not ported yet.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch
from scipy.io import wavfile

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.models.waveglow import (
    flow_channels,
    pack_waveglow_int8cond,
    waveglow_infer,
)
from fac_via_ppg_torch.utils.inference import get_mel


def waveglow_config_from_json(path: str) -> WaveGlowConfig:
    """config.json (reference waveglow/config.json schema) -> WaveGlowConfig."""
    with open(path) as fh:
        return WaveGlowConfig.from_dict(json.load(fh)["waveglow_config"])


# Default worst-utterance SNR budget (dB, bf16+int8 against f32-dense) of
# the cond_impl='auto' gate, the JAX package's value.
DEFAULT_SNR_BUDGET_DB = 35.0


def stack_calibration_mels(mels, max_frames: int = 400) -> torch.Tensor:
    """[(n_mel, T)] arrays -> one (B, n_mel, F) f32 calibration batch,
    trimmed to the shortest utterance and capped at `max_frames`."""
    mels = list(mels)
    if not mels:
        raise ValueError("calibration needs at least one mel "
                         "(cond_impl='auto' cannot gate on an empty "
                         "input list)")
    F = min(min(int(m.shape[-1]) for m in mels), int(max_frames))
    return torch.as_tensor(
        np.stack([np.asarray(m, np.float32)[:, :F] for m in mels]))


def calibration_mel_from_wavs(wav_paths, cfg: WaveGlowConfig,
                              max_utts: int = 4, max_frames: int = 400,
                              device: Optional[torch.device] = None
                              ) -> torch.Tensor:
    """Calibration batch for cond_impl='auto' from deployment wavs: the
    TacotronSTFT analysis mel of the first `max_utts` inputs (computed on
    `device`, None meaning the CUDA card), the mel family the vocoder
    trains on (reference mel2samp.py:61-72), so the gate measures the
    deployment's own amplitude statistics.  Returns a CPU tensor."""
    stft = TacotronSTFT(filter_length=1024, hop_length=cfg.hop_length,
                        win_length=1024, sampling_rate=16000,
                        n_mel_channels=cfg.n_mel_channels,
                        mel_fmin=0.0, mel_fmax=8000.0)
    mels = []
    for p in list(wav_paths)[:max_utts]:
        _, wav = wavfile.read(p)
        mels.append(get_mel(wav, stft, device)[0])
    if not mels:
        raise ValueError("cond_impl='auto' needs at least one input wav "
                         "to calibrate on")
    return stack_calibration_mels(mels, max_frames)


def matched_noise(cfg: WaveGlowConfig, batch: int, n_frames: int,
                  seed: int = 0):
    """Unit gaussians in waveglow_infer draw order, shared across paths."""
    chans = flow_channels(cfg)
    G = n_frames * cfg.hop_length // cfg.n_group
    rng = np.random.default_rng(seed)
    shapes = [(batch, chans[-1], G)] + [
        (batch, cfg.n_early_size, G)
        for k in reversed(range(cfg.n_flows))
        if k % cfg.n_early_every == 0 and k > 0
    ]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    err = got - ref
    return round(float(
        10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))
    ), 2)


def select_cond_impl(cfg: WaveGlowConfig, params, mel: torch.Tensor,
                     budget_db: float, sigma: float = 0.6, seed: int = 0,
                     wn_impl: str = "conv") -> tuple:
    """("int8", snr) when the bf16+int8 path's worst-utterance SNR against
    f32-dense on `mel` meets `budget_db`, else ("dense", snr).

    Runs on the device of `params` (f32, remove_weightnorm form) with
    coupling nets `wn_impl` ("conv" or "flow")."""
    dev = params["upsample"]["weight"].device
    mel = mel.to(dev, torch.float32)
    noise = matched_noise(cfg, mel.shape[0], mel.shape[2], seed)
    packed = pack_waveglow_int8cond(cfg, params)

    def run(dtype, cond_impl):
        with torch.no_grad():
            out = waveglow_infer(
                cfg, params, mel, sigma, dtype=dtype, noise=noise,
                wn_impl=wn_impl, cond_impl=cond_impl,
                packed_cond=(packed if cond_impl == "int8" else None))
        return out.double().cpu().numpy()

    ref = run(None, "dense")
    got = run(torch.bfloat16, "int8")
    worst = min(_snr_db(ref[b], got[b]) for b in range(ref.shape[0]))
    return ("int8" if worst >= budget_db else "dense"), worst
