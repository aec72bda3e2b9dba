"""End-to-end accent-conversion synthesis CLI, the port of
fac_via_ppg_tpu/scripts/generate_synthesis.py.

Mirrors the reference (src/script/generate_synthesis.py:29-103): the same
argparse surface (--ppg2mel_model, --waveglow_model,
--teacher_utterance_path, --output_dir), the same operating point (sigma
0.6, denoiser strength 0.005 mode 'zeros', gate 0.5, fs 16000), the same
debug.log, the same output name `ac.wav`.

Pipeline, on the CUDA card: wav -> PPG (Kaldi-convention front end on the
host + the nnet3 TDNN) -> Tacotron2 autoregressive mel -> WaveGlow (its
coupling nets on the hand-written WN kernels) -> denoiser -> 16 kHz int16
wav.  Three routes, as in the JAX package:
  * one wav, staged: get_ppg -> get_inference -> waveglow_audio ->
    Denoiser -> int16 (`ac.wav`);
  * one wav with --fused: eval/fused.FusedSynthesizer (`ac.wav`);
  * a directory of wavs or a .txt filelist: FusedSynthesizer in batches of
    --batch_size, one batch in flight while the previous one's wavs are
    written (`ac_<name>.wav`).
WaveGlow serves in `hparams.compute_dtype` (float32 by default).
`--data_parallel` spreads the fused routes' batches over the job's
processes, one per GPU (launch with torchrun or scripts/multiproc.py;
eval/fused.py): every rank gets every row back and rank 0 writes the wavs
and debug.log.

Checkpoints are the reference's `.pt` files: --ppg2mel_model a Tacotron2
{'state_dict', ...} checkpoint, --waveglow_model a WaveGlow checkpoint
(pickled module or state dict).  The JAX package writes both from its own
checkpoints with train/export_torch.

Usage:
  python -m fac_via_ppg_torch.scripts.generate_synthesis \\
      --ppg2mel_model tacotron2.pt --waveglow_model waveglow.pt \\
      --teacher_utterance_path x.wav --output_dir out/ [--fused] \\
      [--batch_size 8] [--cond_impl dense|int8|auto] [--snr_budget_db DB] \
      [--data_parallel]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from scipy.io import wavfile

from fac_via_ppg_torch.configs.hparams import (
    Tacotron2Config,
    WaveGlowConfig,
    create_hparams_stage,
)
from fac_via_ppg_torch.dsp.stft import TacotronSTFT
from fac_via_ppg_torch.frontend import ppg as ppg_mod
from fac_via_ppg_torch.models.denoiser import Denoiser
from fac_via_ppg_torch.ops import wn_flow, wn_layer
from fac_via_ppg_torch.scripts.waveglow_inference import DTYPES
from fac_via_ppg_torch.utils.compilation_cache import enable_compilation_cache
from fac_via_ppg_torch.parallel.mesh import job_device
from fac_via_ppg_torch.utils.inference import (
    get_inference,
    load_tacotron2_model,
    load_waveglow_model,
    waveglow_audio,
)
from fac_via_ppg_torch.weights import move


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate accent conversion speech using pre-trained "
        "models.")
    parser.add_argument("--ppg2mel_model", type=str, required=True,
                        help="Path to the PPG-to-Mel model (the reference's "
                             "Tacotron2 .pt checkpoint).")
    parser.add_argument("--waveglow_model", type=str, required=True,
                        help="Path to the WaveGlow model (the reference's "
                             ".pt checkpoint).")
    parser.add_argument("--teacher_utterance_path", type=str, required=True,
                        help="Path to a native speaker recording, or a "
                             "directory / .txt filelist of them.")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Output dir, will save the audio and log info.")
    parser.add_argument("--fused", action="store_true",
                        help="serve one wav through eval/fused.py's "
                             "FusedSynthesizer: the device stages back to "
                             "back, with no host round trip between them")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="utterances per fused device call when "
                             "--teacher_utterance_path is a directory or "
                             ".txt filelist (throughput serving)")
    parser.add_argument("--cond_impl", default="dense",
                        choices=["dense", "int8", "auto"],
                        help="int8: the vocoder's cond projections as int8 "
                             "matmuls, on the whole-net flow kernel (lossy; "
                             "needs --fused or a batch input).  auto: "
                             "measure the int8 worst-utterance SNR on this "
                             "checkpoint and input at start-up, dense "
                             "below --snr_budget_db")
    parser.add_argument("--snr_budget_db", type=float, default=None,
                        help="worst-utterance SNR budget (dB) of "
                             "--cond_impl auto; default "
                             "eval/int8_snr.DEFAULT_SNR_BUDGET_DB")
    parser.add_argument("--data_parallel", action="store_true",
                        help="spread the fused routes' batches over the "
                             "job's processes, one per GPU (torchrun / "
                             "scripts/multiproc.py); rank 0 writes")
    parser.add_argument("--compilation_cache_dir", default="",
                        help="build the hand kernels' libraries into (and "
                             "reuse them from) this directory; default "
                             "$FACPPG_COMPILATION_CACHE, else the "
                             "package's build/ (utils/compilation_cache.py)")
    return parser.parse_args(argv)


def batch_inputs(teacher_utt_path: str):
    """A directory's .wav files (sorted) or a .txt filelist's lines; None
    for a single-file input."""
    if os.path.isdir(teacher_utt_path):
        return sorted(os.path.join(teacher_utt_path, f)
                      for f in os.listdir(teacher_utt_path)
                      if f.lower().endswith(".wav"))
    if teacher_utt_path.endswith(".txt") and os.path.isfile(teacher_utt_path):
        with open(teacher_utt_path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return None


def main(argv=None, device=None):
    """Run the CLI on `argv` (default: sys.argv).  `device=None` means the
    CUDA card (raises without one); tests pass "cpu".

    Returns a summary: the route ("staged", "fused" or "batch"), the wavs
    written, the cond_impl served (and the gate's worst-utterance SNR
    under "auto"), per batch its rows, its WN layer and flow kernel
    launches and its device seconds (CUDA events around the batch's
    device work; host clock on the CPU), the audio seconds written and
    the wall seconds from the models' load to the last wav."""
    args = parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir or None)
    dev = job_device(device)
    if not _lead():
        return _synthesize(args, dev)
    os.makedirs(args.output_dir, exist_ok=True)
    # debug.log gets every record of the run, whatever handlers a host app
    # has configured; they and the root level are left as they were
    log = logging.FileHandler(os.path.join(args.output_dir, "debug.log"))
    root, level = logging.getLogger(), logging.getLogger().level
    root.addHandler(log)
    root.setLevel(logging.DEBUG)
    try:
        return _synthesize(args, dev)
    finally:
        root.removeHandler(log)
        root.setLevel(level)
        log.close()


def _lead() -> bool:
    """Rank 0 of a launched job, or the one process: the writer."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _synthesize(args, dev):
    output_dir = args.output_dir
    logging.info("Output dir: %s", output_dir)

    teacher_utt_path = args.teacher_utterance_path
    checkpoint_path = args.ppg2mel_model
    waveglow_path = args.waveglow_model
    is_clip = False
    fs = 16000
    waveglow_sigma = 0.6
    denoiser_mode = "zeros"
    denoiser_strength = 0.005

    logging.debug("Tacotron: %s", checkpoint_path)
    logging.debug("Waveglow: %s", waveglow_path)
    logging.debug("AM: SI model")
    logging.debug("is_clip: %d", is_clip)
    logging.debug("Fs: %d", fs)
    logging.debug("Sigma: %f", waveglow_sigma)
    logging.debug("Denoiser strength: %f", denoiser_strength)
    logging.debug("Denoiser mode: %s", denoiser_mode)

    hparams = create_hparams_stage()
    # parity with the reference; mel analysis is not needed here
    TacotronSTFT(hparams.filter_length, hparams.hop_length,
                 hparams.win_length, hparams.n_acoustic_feat_dims,
                 hparams.sampling_rate, hparams.mel_fmin, hparams.mel_fmax)

    wall0 = time.time()
    t2_cfg = Tacotron2Config.from_hparams(hparams)
    wg_cfg = WaveGlowConfig()
    tacotron_params, tacotron_state = load_tacotron2_model(checkpoint_path,
                                                           t2_cfg)
    waveglow_params = load_waveglow_model(waveglow_path, wg_cfg)

    deps = ppg_mod.DependenciesPPG()
    gen = torch.Generator(dev).manual_seed(hparams.seed)
    serving_dtype = DTYPES[hparams.compute_dtype]
    summary = {"route": None, "outputs": [], "cond_impl": args.cond_impl,
               "calibration_snr_db": None, "batches": [], "audio_s": 0.0}

    lead = _lead()

    def write(path, pcm):
        summary["outputs"].append(path)
        summary["audio_s"] += len(pcm) / fs
        if lead:
            wavfile.write(path, fs, pcm)
            print("Wrote", path)

    batch_paths = batch_inputs(teacher_utt_path)
    if batch_paths is not None and not batch_paths:
        logging.warning("No .wav files under %s", teacher_utt_path)
        print("No .wav files under", teacher_utt_path)
        return summary

    calibration_mel = None
    if args.cond_impl == "auto":
        # the int8 serving gate calibrates on this deployment's own input
        from fac_via_ppg_torch.eval.int8_snr import calibration_mel_from_wavs

        cal_wavs = (batch_paths if batch_paths is not None
                    else ([teacher_utt_path]
                          if os.path.isfile(teacher_utt_path) else []))
        if cal_wavs:
            calibration_mel = calibration_mel_from_wavs(cal_wavs, wg_cfg,
                                                        device=dev)

    def fused_synthesizer():
        from fac_via_ppg_torch.eval.fused import FusedSynthesizer

        synth = FusedSynthesizer(
            t2_cfg, tacotron_params, tacotron_state, wg_cfg,
            waveglow_params, deps=deps, sigma=waveglow_sigma,
            denoiser_strength=denoiser_strength,
            serving_dtype=serving_dtype,
            max_frames=t2_cfg.max_decoder_steps,
            cond_impl=args.cond_impl, calibration_mel=calibration_mel,
            snr_budget_db=args.snr_budget_db, device=dev,
            data_parallel=args.data_parallel)
        summary["cond_impl"] = synth.cond_impl
        summary["calibration_snr_db"] = synth.calibration_snr_db
        return synth

    if batch_paths is not None:
        logging.info("Batch AC on %d utterances", len(batch_paths))
        summary["route"] = "batch"
        synth = fused_synthesizer()

        def launch(chunk):
            pairs = [synth.featurize(p) for p in chunk]
            h = {"chunk": chunk, "layer0": wn_layer.launches,
                 "flow0": wn_flow.launches, "t0": time.time()}
            if dev.type == "cuda":
                h["start"] = torch.cuda.Event(enable_timing=True)
                h["start"].record()
            h["handle"] = synth.launch_feature_pairs(pairs, gen)
            if dev.type == "cuda":
                h["done"] = torch.cuda.Event(enable_timing=True)
                h["done"].record()
            h["wn_layer_launches"] = wn_layer.launches - h["layer0"]
            h["wn_flow_launches"] = wn_flow.launches - h["flow0"]
            return h

        def write_chunk(h):
            pcms = synth.collect_feature_pairs(h["handle"])
            device_s = (h["start"].elapsed_time(h["done"]) / 1e3
                        if "done" in h else time.time() - h["t0"])
            summary["batches"].append({
                "rows": len(h["chunk"]), "device_s": device_s,
                **{k: h[k] for k in ("wn_layer_launches",
                                     "wn_flow_launches")}})
            for p, pcm in zip(h["chunk"], pcms):
                name = os.path.splitext(os.path.basename(p))[0]
                write(os.path.join(output_dir, f"ac_{name}.wav"), pcm)

        # one chunk stays in flight: chunk N+1's featurization and device
        # work are enqueued before chunk N's PCM is read back and written
        inflight = None
        try:
            for start in range(0, len(batch_paths), args.batch_size):
                h = launch(batch_paths[start: start + args.batch_size])
                if inflight is not None:
                    write_chunk(inflight)
                inflight = h
            if inflight is not None:
                write_chunk(inflight)
                inflight = None
        finally:
            # a bad wav in chunk N+1 must not lose chunk N's finished
            # audio: land the in-flight chunk before propagating
            if inflight is not None:
                write_chunk(inflight)
        logging.info("Done!")
        summary["wall_s"] = time.time() - wall0
        return summary

    if os.path.isfile(teacher_utt_path):
        logging.info("Perform AC on %s", teacher_utt_path)
        if args.fused:
            summary["route"] = "fused"
            pcm = fused_synthesizer()(teacher_utt_path, generator=gen)
        else:
            if args.cond_impl != "dense":
                raise SystemExit("--cond_impl int8/auto needs --fused "
                                 "(or a directory/.txt batch input)")
            summary["route"] = "staged"
            t2_params = move(tacotron_params, dev)
            t2_state = move(tacotron_state, dev)
            wg_params = move(waveglow_params, dev)
            teacher_ppg = ppg_mod.get_ppg(teacher_utt_path, deps, device=dev)
            ac_mel = get_inference(teacher_ppg, t2_cfg, t2_params, t2_state,
                                   gen, is_clip)
            ac_wav = waveglow_audio(ac_mel, wg_cfg, wg_params,
                                    waveglow_sigma, gen, dtype=serving_dtype)
            # built here, not up front: the fused and batch routes build
            # their own bias spectrum inside FusedSynthesizer
            denoiser = Denoiser(wg_cfg, wg_params, mode=denoiser_mode)
            with torch.no_grad():
                ac_wav = denoiser(ac_wav.float(),
                                  strength=denoiser_strength)[0, 0]
            pcm = (np.clip(ac_wav.cpu().numpy(), -1.0, 1.0)
                   * 32767).astype(np.int16)
        write(os.path.join(output_dir, "ac.wav"), pcm)
    else:
        logging.warning("Missing %s", teacher_utt_path)

    logging.info("Done!")
    summary["wall_s"] = time.time() - wall0
    return summary


if __name__ == "__main__":
    main()
