"""Quality ladder for reduced-precision WaveGlow inference modes, and the
serving gate of the int8 cond projection (the port of
fac_via_ppg_tpu/eval/int8_snr.py).

`run_ladder` measures the SNR of each serving configuration (bf16-dense,
bf16-int8, f32-int8, plus the opt-in per-tensor-scale rungs) against the
f32-dense output on a checkpoint with real corpus mel and matched noise;
the reference never measures its fp16 inference mode's precision trade
(reference src/waveglow/inference.py:40-49), this tool does.
`select_cond_impl` runs the same comparison for the bf16-int8 mode alone
and keeps int8 only when the worst utterance's SNR meets the budget.
`calibration_mel_from_wavs` makes the calibration batch from a
deployment's own wavs.  The WN int8 rungs (`include_wn_int8`) run on
the conv formulation whatever the ladder's `wn_impl`, as the JAX package
runs them on its xla path.

Usage (on the card unless --cpu):
    python -m fac_via_ppg_torch.eval.int8_snr \
        --waveglow_model waveglow.pt --wav a.wav b.wav [--config config.json]
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
    serving_form,
    waveglow_serve,
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


def _ladder(cfg: WaveGlowConfig, params, mel: torch.Tensor, sigma: float,
            seed: int, wn_impl: str, rungs) -> tuple:
    """(f32-dense audio, {name: audio}) for rungs (name, the fields of its
    serving form: `serving_form`'s options, `wn_impl` by default the
    ladder's), on the device of `params` (f32, remove_weightnorm form),
    every run on the same matched noise; audio as float64 numpy.  Each
    form's int8 packs come from the f32 params."""
    dev = params["upsample"]["weight"].device
    mel = mel.to(dev, torch.float32)
    noise = matched_noise(cfg, mel.shape[0], mel.shape[2], seed)

    def run(fields):
        form = serving_form(cfg, params, **{"wn_impl": wn_impl, **fields})
        with torch.no_grad():
            out = waveglow_serve(form, mel, sigma, noise=noise)
        return out.double().cpu().numpy()

    return run({}), {name: run(fields) for name, fields in rungs}


def run_ladder(cfg: WaveGlowConfig, params, mel: torch.Tensor,
               sigma: float = 0.6, seed: int = 0,
               include_tensorscale: bool = False,
               include_wn_int8: bool = False, detailed: bool = False,
               wn_impl: str = "conv") -> dict:
    """{name: SNR dB vs f32-dense} for each reduced-precision mode, its
    coupling nets on `wn_impl` ("conv" or "flow").

    include_tensorscale adds the per-tensor activation-scale int8 rungs
    (`cond_quant="tensor"`) for an A/B against the per-column default.
    include_wn_int8 adds the WN int8 rungs, each on bf16 with int8 cond:
    the in_layer convs of 4, 8 and all flows (`bf16_int8_wn{n}`), of all
    flows with the per-tensor stacked variant (`bf16_int8_wn{n}t`) and the
    res_skip convs of all flows (`bf16_int8_rs{n}`).  They run on the
    conv formulation whatever `wn_impl`; their detailed entries say so
    (`"wn_impl": "conv"`).

    detailed=True returns {name: {"db", "per_utt_db", "worst_utt_db"}}
    instead of bare floats: per_utt_db is the SNR of each batch row
    (utterance) separately, worst_utt_db its minimum -- the quality gate
    should be judged on the worst utterance, not the batch mean.
    """
    bf16 = torch.bfloat16
    rungs = [
        ("bf16_dense", dict(dtype=bf16)),
        ("bf16_int8", dict(dtype=bf16, cond_impl="int8")),
        ("f32_int8", dict(cond_impl="int8")),
    ]
    if include_tensorscale:
        rungs += [
            ("bf16_int8_tensorscale", dict(dtype=bf16, cond_impl="int8",
                                           cond_quant="tensor")),
            ("f32_int8_tensorscale", dict(cond_impl="int8",
                                          cond_quant="tensor")),
        ]
    if include_wn_int8:
        n = cfg.n_flows
        wn8 = dict(dtype=bf16, cond_impl="int8", wn_impl="conv")
        rungs += [(f"bf16_int8_wn{k}", dict(wn8, wn_int8_flows=k))
                  for k in (4, 8, n) if k <= n]
        rungs += [(f"bf16_int8_wn{n}t", dict(wn8, wn_int8_flows=n,
                                              wn_int8_quant="tensor")),
                  (f"bf16_int8_rs{n}", dict(wn8, wn_int8_rs_flows=n))]
    on_conv = {name for name, fields in rungs
               if fields.get("wn_impl") == "conv"}
    ref, got = _ladder(cfg, params, mel, sigma, seed, wn_impl, rungs)
    out = {}
    for name, audio in got.items():
        if detailed:
            per_utt = [_snr_db(ref[b], audio[b])
                       for b in range(ref.shape[0])]
            out[name] = {"db": _snr_db(ref, audio), "per_utt_db": per_utt,
                         "worst_utt_db": min(per_utt)}
            if name in on_conv:
                out[name]["wn_impl"] = "conv"
        else:
            out[name] = _snr_db(ref, audio)
    return out


def select_cond_impl(cfg: WaveGlowConfig, params, mel: torch.Tensor,
                     budget_db: float, sigma: float = 0.6, seed: int = 0,
                     wn_impl: str = "conv") -> tuple:
    """("int8", snr) when the bf16+int8 path's worst-utterance SNR against
    f32-dense on `mel` meets `budget_db`, else ("dense", snr).

    Runs on the device of `params` (f32, remove_weightnorm form) with
    coupling nets `wn_impl` ("conv" or "flow")."""
    ref, got = _ladder(cfg, params, mel, sigma, seed, wn_impl,
                       [("bf16_int8", dict(dtype=torch.bfloat16,
                                           cond_impl="int8"))])
    got = got["bf16_int8"]
    worst = min(_snr_db(ref[b], got[b]) for b in range(ref.shape[0]))
    return ("int8" if worst >= budget_db else "dense"), worst


def main(argv=None, device=None):
    """The ladder CLI: one JSON line.  `device` None means the card (the
    CPU under --cpu)."""
    import argparse

    from fac_via_ppg_torch.models.waveglow import resolve_wn_impl
    from fac_via_ppg_torch.utils.device import device_name, resolve_device
    from fac_via_ppg_torch.utils.inference import load_waveglow_model
    from fac_via_ppg_torch.weights import move

    parser = argparse.ArgumentParser()
    parser.add_argument("--waveglow_model", required=True,
                        help="the reference's .pt WaveGlow checkpoint")
    parser.add_argument("--config", default=None,
                        help="trainer config.json (waveglow_config block); "
                             "defaults to the full reference architecture")
    parser.add_argument("--wav", nargs="+", required=True,
                        help="wav files providing the conditioning mel")
    parser.add_argument("--sigma", type=float, default=0.6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wn_impl", default="flow",
                        choices=["flow", "conv", "xla"],
                        help="coupling nets: the whole-net flow kernel "
                             "(default, the int8 serving path's) or plain "
                             "torch convs (conv, or the JAX package's xla)")
    parser.add_argument("--include_tensorscale", action="store_true",
                        help="add the per-tensor-scale A/B rungs")
    parser.add_argument("--include_wn_int8", action="store_true",
                        help="add the WN int8 rungs (run on the conv "
                             "formulation whatever --wn_impl)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else device)
    cfg = (waveglow_config_from_json(args.config) if args.config
           else WaveGlowConfig())
    params = move(load_waveglow_model(args.waveglow_model, cfg), dev)
    mels = []
    stft = TacotronSTFT(filter_length=1024, hop_length=cfg.hop_length,
                        win_length=1024, sampling_rate=16000,
                        n_mel_channels=cfg.n_mel_channels,
                        mel_fmin=0.0, mel_fmax=8000.0)
    for p in args.wav:
        _, wav = wavfile.read(p)
        mels.append(get_mel(wav, stft, dev)[0])
    F = min(m.shape[1] for m in mels)
    mel = torch.as_tensor(np.stack([m[:, :F] for m in mels]))

    ladder = run_ladder(cfg, params, mel, args.sigma, args.seed,
                        include_tensorscale=args.include_tensorscale,
                        include_wn_int8=args.include_wn_int8,
                        detailed=True, wn_impl=resolve_wn_impl(args.wn_impl))
    out = {"snr_db_vs_f32_dense": ladder, "mel_shape": list(mel.shape),
           "device": device_name(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
