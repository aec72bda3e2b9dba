"""Inference helpers (reference src/common/utils.py:39-181), the port of
fac_via_ppg_tpu/utils/inference.py.

Same public surface: get_mask_from_lengths, load_filepaths,
notch_filtering, get_mel, waveglow_audio, get_inference,
load_tacotron2_model, load_waveglow_model.  The checkpoints are the
reference's own `.pt` files (the JAX package's orbax directories are not
read here; its `train/export_torch` writes the `.pt` form), and the
port's PPG trainer's for Tacotron2.  Randomness
comes from a torch.Generator; the prenet keep-masks and the WaveGlow noise
can be injected instead (`masks`, `noise`).
"""

from __future__ import annotations

import math
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.models.tacotron2 import tacotron2_inference
from fac_via_ppg_torch.models.waveglow import remove_weightnorm, waveglow_infer
from fac_via_ppg_torch.train.import_torch import (
    import_tacotron2_state_dict,
    load_reference_tacotron2_checkpoint,
    load_reference_waveglow_checkpoint,
)
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.numeric import round_up
from fac_via_ppg_torch.weights import fold_waveglow


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, max_len) bool, True at valid positions (utils.py:39-43)."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def load_filepaths(filename: str):
    with open(filename) as f:
        return [line.strip() for line in f]


def notch_filtering(wav: np.ndarray, fs: float, w0: float, Q: float):
    """Band-stop filter (utils.py:115-129)."""
    b, a = signal.iirnotch(2 * w0 / fs, Q)
    return signal.lfilter(b, a, wav)


def get_mel(wav: np.ndarray, stft: TacotronSTFT,
            device: Optional[torch.device] = None) -> np.ndarray:
    """(S,) int16-scale wav -> (1, n_mel, T) log-mel (utils.py:132-139),
    computed on `device` (None means the CUDA card)."""
    dev = resolve_device(device)
    audio_norm = torch.as_tensor(np.asarray(wav, np.float32) / 32768.0,
                                 device=dev)[None, :]
    return stft.mel_spectrogram(audio_norm).cpu().numpy()


def _device_of(params) -> torch.device:
    while isinstance(params, (dict, list)):
        params = (next(iter(params.values())) if isinstance(params, dict)
                  else params[0])
    return params.device


def waveglow_audio(mel, cfg: WaveGlowConfig, waveglow_params, sigma: float,
                   generator: Optional[torch.Generator] = None,
                   is_int16_output: bool = False,
                   dtype: Optional[torch.dtype] = None,
                   pad_to_frames: int = 0, noise=None):
    """mel (1, 80, T) -> waveform (1, T*hop) (utils.py:142-152), on the
    device of `waveglow_params`, the coupling nets on the WN layer kernel.

    `pad_to_frames` rounds the mel length up with silence (log 1e-5); the
    padded tail is trimmed from the audio.  The noise comes from
    `generator` (default: seeded with 0) or is injected (`noise`, in
    `waveglow_infer`'s order)."""
    dev = _device_of(waveglow_params)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    t = mel.shape[-1]
    if pad_to_frames:
        mel = F.pad(mel, (0, round_up(t, pad_to_frames) - t),
                    value=math.log(1e-5))
    if generator is None and noise is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        audio = waveglow_infer(cfg, waveglow_params, mel, sigma, generator,
                               dtype=dtype, noise=noise)
    audio = audio[:, : t * cfg.hop_length]
    if is_int16_output:
        return (32768.0 * audio.float()).cpu().numpy().astype("int16")
    return audio


def get_inference(seq: np.ndarray, cfg: Tacotron2Config, params, model_state,
                  generator: Optional[torch.Generator] = None,
                  is_clip: bool = False, pad_to_frames: int = 0,
                  masks: Optional[Iterator] = None) -> torch.Tensor:
    """(T, D) PPG -> (1, 80, T_out) synthesized mel (utils.py:155-174), on
    the device of `params`.

    `pad_to_frames` zero-pads the PPG to a length bucket, with the true
    length passed to the attention masks.  The prenet keep-masks come from
    `generator` (default: seeded with 0) or are injected (`masks`)."""
    dev = _device_of(params)
    t_in = seq.shape[0]
    x = torch.as_tensor(np.asarray(seq, np.float32).T[None], device=dev)
    lengths = None
    if pad_to_frames:
        x = F.pad(x, (0, round_up(t_in, pad_to_frames) - t_in))
        lengths = torch.tensor([t_in], device=dev)
    if generator is None and masks is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        _, mel_post, _, _, t_end = tacotron2_inference(
            cfg, params, model_state, x, generator, lengths, masks)
    mel_post = mel_post[:, :, :t_end]
    if is_clip:
        return mel_post[:, :, 10: t_in - 10]
    return mel_post


def load_tacotron2_model(path: str, cfg: Tacotron2Config) -> Tuple[dict, dict]:
    """A Tacotron2 checkpoint -> (params, model_state) on the CPU: the
    reference's `.pt` ({'state_dict', ...}, reference
    train_ppg2mel.py:143-149) or one the port's trainer writes
    ({'params', 'model_state', ...}, train/checkpoint.py)."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a reference file that holds more
        payload = None
    if isinstance(payload, dict) and "params" in payload:
        return payload["params"], payload.get("model_state")
    if isinstance(payload, dict) and "state_dict" in payload:
        return import_tacotron2_state_dict(payload["state_dict"], cfg)
    params, model_state, _, _ = load_reference_tacotron2_checkpoint(path, cfg)
    return params, model_state


def load_waveglow_model(path: str, cfg: Optional[WaveGlowConfig] = None):
    """The reference's `.pt` WaveGlow checkpoint (pickled {'model':
    glow.WaveGlow} or a bare state dict) -> the port's inference params on
    the CPU: weight norm folded and the f32 1x1 inverses cached
    (reference utils.py:177-181)."""
    cfg = cfg or WaveGlowConfig()
    return remove_weightnorm(
        fold_waveglow(load_reference_waveglow_checkpoint(path, cfg)))
