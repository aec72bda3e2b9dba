"""Gate-convergence / duration-match check for trained Tacotron2 checkpoints
(the port of fac_via_ppg_tpu/eval/duration_check.py).

Runs the full PPG front end and the autoregressive decoder (gate-threshold
stop, reference model.py:489-535) on a list of wavs and compares the
gate-stopped output duration with each source utterance's.  A converged
model gate-stops on every utterance at a small relative duration error;
an undertrained one runs to the max_decoder_steps cap (reported as CAP).

Usage (on the card unless --cpu):
    python -m fac_via_ppg_torch.eval.duration_check CHECKPOINT WAV [WAV ...] \\
        [--cpu] [--hparams stage|default] [--json OUT.json]

CHECKPOINT is the reference's Tacotron2 `.pt` or a checkpoint of the
port's PPG trainer (scripts/train_ppg2mel.py).  The check runs the serve
path of scripts/generate_synthesis.py up to the mel (PPG extraction ->
autoregressive inference), so a passing result here means the synthesis
CLI produces finite, source-length audio from this checkpoint.  Each
utterance's prenet masks come from a generator seeded with `seed + i`.
"""

from __future__ import annotations

import argparse
import json
import wave

import numpy as np
import torch


def check_durations(ckpt_path: str, wav_paths, cfg=None, deps=None,
                    seed: int = 16807, sample_rate: int = 16000,
                    hop: int = 160, device=None, masks=None):
    """Returns a list of per-utterance dicts + a summary dict.  `device`
    None means the card.  `masks` (tests) gives each utterance's prenet
    keep-masks, one iterable per wav, in place of the generator."""
    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        create_hparams_stage,
    )
    from fac_via_ppg_torch.frontend import ppg as ppg_mod
    from fac_via_ppg_torch.utils.device import resolve_device
    from fac_via_ppg_torch.utils.inference import (
        get_inference,
        load_tacotron2_model,
    )
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    if cfg is None:
        cfg = Tacotron2Config.from_hparams(create_hparams_stage())
    params, state = load_tacotron2_model(ckpt_path, cfg)
    params, state = move(params, dev), move(state, dev)
    deps = deps if deps is not None else ppg_mod.DependenciesPPG()

    rows = []
    for i, wav_path in enumerate(wav_paths):
        with wave.open(wav_path) as w:
            src_seconds = w.getnframes() / w.getframerate()
        src_frames = int(round(src_seconds * sample_rate / hop))
        ppg = ppg_mod.get_ppg(wav_path, deps, dither=0.0, device=dev)
        mel = get_inference(
            ppg, cfg, params, state,
            generator=torch.Generator(dev).manual_seed(seed + i),
            masks=None if masks is None else iter(masks[i]))
        out_frames = mel.shape[-1]
        gated = out_frames < cfg.max_decoder_steps
        rows.append({
            "wav": wav_path,
            "src_seconds": round(src_seconds, 3),
            "src_frames": src_frames,
            "out_frames": out_frames,
            "out_seconds": round(out_frames * hop / sample_rate, 3),
            "stop": "GATE" if gated else "CAP",
            "rel_duration_err": (abs(out_frames - src_frames) / src_frames
                                 if gated else None),
        })

    errs = [r["rel_duration_err"] for r in rows if r["stop"] == "GATE"]
    summary = {
        "checkpoint": ckpt_path,
        "n_utts": len(rows),
        "n_gated": len(errs),
        "median_rel_duration_err": (round(float(np.median(errs)), 4)
                                    if errs else None),
        "max_rel_duration_err": (round(float(np.max(errs)), 4)
                                 if errs else None),
    }
    return rows, summary


def main(argv=None, device=None):
    """The CLI; `device` (None: the card, or the CPU under --cpu)."""
    parser = argparse.ArgumentParser(
        description="gate-stop duration check for a Tacotron2 checkpoint"
    )
    parser.add_argument("checkpoint")
    parser.add_argument("wavs", nargs="+")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (leave the card free)")
    parser.add_argument("--hparams", default="stage",
                        choices=("stage", "default"),
                        help="hparams set the checkpoint was trained with "
                             "(stage = the paper config, like the studies)")
    parser.add_argument("--json", default=None,
                        help="also write rows+summary to this JSON file")
    args = parser.parse_args(argv)

    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        create_hparams,
        create_hparams_stage,
    )
    hp = (create_hparams_stage() if args.hparams == "stage"
          else create_hparams())
    cfg = Tacotron2Config.from_hparams(hp)

    rows, summary = check_durations(
        args.checkpoint, args.wavs, cfg=cfg,
        device="cpu" if args.cpu else device)
    for r in rows:
        err = (f" rel_err {100 * r['rel_duration_err']:.1f}%"
               if r["rel_duration_err"] is not None else "")
        print(f"{r['wav']}: src {r['src_seconds']:.2f}s ({r['src_frames']} "
              f"fr) -> out {r['out_frames']} fr ({r['out_seconds']:.2f}s) "
              f"{r['stop']}{err}")
    med = summary["median_rel_duration_err"]
    print(f"gated {summary['n_gated']}/{summary['n_utts']}"
          + (f"; median rel duration err {100 * med:.1f}%"
             if med is not None else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
