"""Batched WaveGlow vocoder inference CLI.

The port of fac_via_ppg_tpu/scripts/waveglow_inference.py (reference
src/waveglow/inference.py:33-73): a filelist of mel files -> one int16 wav
each, `<output_dir>/<basename>_synthesis.wav`, with sigma and denoiser
options.

Mels are `.npy` (n_mel, T) arrays or the reference's torch-saved `.pt`
tensors, mixed freely.  The checkpoint is the reference's `.pt` WaveGlow
format (a pickled {'model': glow.WaveGlow} or a bare state dict); the JAX
package writes it from its own checkpoints with
`train/export_torch.save_reference_waveglow_checkpoint`.  Its orbax
checkpoint directories are not read here.

Runs on the CUDA card, with the coupling nets on the whole-net flow kernel
(`--wn_impl flow`: one kernel launch per flow); `--wn_int8_flows N` (the
WN int8 rung, lossy) needs `--wn_impl conv` (or the JAX CLI's `xla`), as in
the JAX CLI.  Same-length mels form one
batch; `--mel_bucket` pads lengths into shared buckets first.  One batch
stays in flight: batch N is copied to pinned host memory behind an event,
batch N+1 is enqueued, and only then are batch N's wavs written.

Several GPUs, one process each (launch with torchrun or scripts/
multiproc.py; parallel/mesh.py): `--data_parallel` splits each batch's
rows over the processes, the batch raised to at least the data axis and
padded to a multiple of it; the noise is drawn for the whole batch on
every rank and each takes its rows, the audio is all-gathered and rank 0
writes the wavs, the same bytes as one process's.  `--model_parallel N`
splits WaveGlow's WN channels over N processes on the conv formulation
(`--wn_impl conv|xla`; the hand kernels raise there).  With one process
both do nothing (the mesh is 1 data x 1 model).

Usage:
  python -m fac_via_ppg_torch.scripts.waveglow_inference -f mels.txt \\
      -w waveglow.pt -o outdir [-s 0.6] [-d 0.005] [-b 8] [--mel_bucket 64]
"""

from __future__ import annotations

import argparse
import os
import time
import warnings

import numpy as np
import torch
from scipy.io import wavfile

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.data.mel2samp import MAX_WAV_VALUE, files_to_list
from fac_via_ppg_torch.eval.int8_snr import waveglow_config_from_json
from fac_via_ppg_torch.models.denoiser import Denoiser
from fac_via_ppg_torch.models.waveglow import (
    check_serving,
    resolve_wn_impl,
    serving_form,
    waveglow_noise,
    waveglow_serve,
)
from fac_via_ppg_torch.ops import wn_flow
from fac_via_ppg_torch.parallel.mesh import (
    gather_rows,
    job_device,
    make_mesh,
    padded_rows,
    rank_rows,
)
from fac_via_ppg_torch.utils.compilation_cache import enable_compilation_cache
from fac_via_ppg_torch.utils.inference import load_waveglow_model
from fac_via_ppg_torch.utils.numeric import round_batch_to_grid, round_up
from fac_via_ppg_torch.weights import move

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def load_mel(path: str) -> np.ndarray:
    """One (n_mel, T) mel file: `.npy`, or the reference's torch-saved
    `.pt` tensor (its inference filelist format,
    src/waveglow/inference.py:46-48)."""
    if path.endswith((".pt", ".pth")):
        m = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(m.numpy() if isinstance(m, torch.Tensor) else m,
                          np.float32)
    return np.load(path)


def bucket_mels(mels, mel_bucket: int):
    """(file, (n_mel, T) mel) pairs -> (file, padded mel, true_frames).

    `mel_bucket` > 0 pads each mel's time axis up to a multiple of
    `mel_bucket` frames by repeating the last frame, so distinct utterance
    lengths share batches; the audio is trimmed back to true_frames * hop.
    0 keeps exact lengths (the reference's semantics)."""
    out = []
    for f, m in mels:
        t = m.shape[-1]
        if mel_bucket:
            t_pad = round_up(t, mel_bucket)
            if t_pad != t:
                m = np.concatenate(
                    [m, np.repeat(m[:, -1:], t_pad - t, axis=1)], axis=1)
        out.append((f, m, t))
    return out


def main(mel_files, waveglow_path, output_dir, sigma, denoiser_strength,
         batch_size=1, sampling_rate=16000, compute_dtype="float32",
         wn_impl="flow", cond_impl="dense", config_path=None,
         snr_budget_db=None, pad_batches="grid", mel_bucket=0,
         wn_int8_flows=0, data_parallel=False, model_parallel=1,
         device=None):
    """Vocode every mel of the filelist `mel_files`.  `device=None` means
    the CUDA card (raises without one); tests pass "cpu".  Noise comes from
    a torch.Generator seeded with 0 (the JAX CLI's PRNGKey(0)).

    Returns a summary: the cond_impl served (and the gate's
    worst-utterance SNR under "auto"); per batch its rows, its flow kernel
    launches and its vocoder seconds (CUDA events around the batch's
    device work; host clock on the CPU); the audio seconds written; the
    wall seconds.  `wn_impl` also takes the JAX CLI's names, "xla" for
    "conv" and "pallas" for "layer".  `wn_int8_flows` runs the WN
    in_layer convs of that many of the narrowest flows on int8 codes
    (conv only; measure eval/int8_snr.py --include_wn_int8 first).
    `data_parallel` / `model_parallel` spread the batches over the job's
    processes (see the module doc); the summary is every rank's, the
    wavs rank 0's."""
    try:
        wn_impl = resolve_wn_impl(wn_impl)
    except ValueError as e:
        raise SystemExit(f"--wn_impl: {e}") from None
    if cond_impl not in ("dense", "int8", "auto"):
        raise SystemExit(f"--cond_impl must be dense/int8/auto, got "
                         f"{cond_impl!r}")
    if pad_batches not in ("grid", "full", "none"):
        raise SystemExit(f"--pad_batches must be grid/full/none, "
                         f"got {pad_batches!r}")
    if compute_dtype not in DTYPES:
        raise SystemExit(f"--compute_dtype must be one of {list(DTYPES)}")
    cfg = (waveglow_config_from_json(config_path) if config_path is not None
           else WaveGlowConfig())
    # the serving form's checks, before any work ("auto" may serve int8)
    try:
        check_serving(cfg, wn_impl, "dense" if cond_impl == "dense"
                      else "int8", wn_int8_flows=wn_int8_flows,
                      model=model_parallel)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    dev = job_device(device)
    mesh = None
    if data_parallel or model_parallel > 1:
        mesh = make_mesh(model=int(model_parallel), device=dev)
        batch_size = max(batch_size, mesh.shape["data"])
        print(f"vocoder mesh: {mesh.shape['data']} data x "
              f"{mesh.shape['model']} model")
    dp = mesh is not None and mesh.data_group is not None
    lead = mesh is None or mesh.rank == 0
    params = move(load_waveglow_model(waveglow_path, cfg), dev)
    denoiser = Denoiser(cfg, params) if denoiser_strength > 0 else None

    files = files_to_list(mel_files)
    if lead:
        os.makedirs(output_dir, exist_ok=True)
    mels = [(f, load_mel(f)) for f in files]
    by_len = {}
    for f, m, t in bucket_mels(mels, mel_bucket):
        by_len.setdefault(m.shape[-1], []).append((f, m, t))

    gate_snr_db = None
    if cond_impl == "auto":
        # calibrated on the deployment's own inputs: the first mels of
        # the filelist are the calibration batch
        from fac_via_ppg_torch.eval.int8_snr import (
            DEFAULT_SNR_BUDGET_DB,
            select_cond_impl,
            stack_calibration_mels,
        )

        budget = (DEFAULT_SNR_BUDGET_DB if snr_budget_db is None
                  else float(snr_budget_db))
        cal = stack_calibration_mels(
            [m.astype(np.float32) for _, m in mels[:4]])
        cond_impl, gate_snr_db = select_cond_impl(
            cfg, params, cal, budget, sigma=sigma, wn_impl=wn_impl)
        print(f"cond_impl=auto: bf16+int8 worst-utterance SNR "
              f"{gate_snr_db:.1f} dB vs budget {budget:.1f} dB -> serving "
              f"cond_impl='{cond_impl}'")

    dtype = DTYPES[compute_dtype]
    # the serving form, built once: the weights cast (the 1x1 inverses
    # stay f32), the kernels' packs, the int8 ones from the f32 params
    form = serving_form(cfg, params, dtype=dtype, wn_impl=wn_impl,
                        cond_impl=cond_impl, wn_int8_flows=wn_int8_flows,
                        mesh=mesh)

    if (batch_size > 1 and not mel_bucket and len(files) > 1
            and len(by_len) > len(files) // 2):
        warnings.warn(
            f"batching requested (batch {batch_size}) but the {len(files)} "
            f"mels have {len(by_len)} distinct lengths, so exact-length "
            "grouping leaves most batches near size 1.  Pass --mel_bucket "
            "64 to pad lengths into shared buckets and form full batches.",
            stacklevel=2)

    hop = cfg.hop_length
    gen = torch.Generator(dev).manual_seed(0)
    summary = {"cond_impl": cond_impl, "gate_snr_db": gate_snr_db,
               "batches": [], "audio_s": 0.0}

    def launch(chunk, mel_batch):
        """Enqueue one batch; its audio lands in (pinned) host memory.  A
        data-parallel rank enqueues its rows and all-gathers the audio."""
        n0 = wn_flow.launches
        h = {"chunk": chunk, "rows": mel_batch.shape[0],
             "frames": mel_batch.shape[2], "t0": time.time()}
        if dev.type == "cuda":
            h["start"] = torch.cuda.Event(enable_timing=True)
            h["start"].record()
        with torch.no_grad():
            mel = torch.as_tensor(mel_batch, device=dev)
            noise = None
            if dp:
                G = mel.shape[2] * hop // cfg.n_group
                rows = rank_rows(mesh, mel.shape[0])
                noise = [z[rows] for z in waveglow_noise(
                    cfg, mel.shape[0], G, gen, dev)]
                mel = mel[rows]
            audio = waveglow_serve(form, mel.to(dtype or torch.float32),
                                   sigma, gen, noise=noise).float()
            if denoiser is not None:
                audio = denoiser(audio, strength=denoiser_strength)[:, 0, :]
            audio = audio * MAX_WAV_VALUE
            if dp:
                audio = gather_rows(mesh, audio, len(chunk))
            audio = audio[: len(chunk)]
        h["launches"] = wn_flow.launches - n0
        if dev.type == "cuda":
            h["host"] = torch.empty(audio.shape, dtype=torch.float32,
                                    pin_memory=True)
            h["host"].copy_(audio, non_blocking=True)
            h["done"] = torch.cuda.Event(enable_timing=True)
            h["done"].record()
        else:
            h["host"] = audio
            h["vocoder_s"] = time.time() - h["t0"]
        return h

    def write_batch(h):
        if "done" in h:
            h["done"].synchronize()
            h["vocoder_s"] = h["start"].elapsed_time(h["done"]) / 1e3
        # clip before the int16 cast: a sample past full scale would wrap
        audio = np.clip(h["host"].numpy(), -MAX_WAV_VALUE,
                        MAX_WAV_VALUE - 1).astype(np.int16)
        for (f, _, t), wav in zip(h["chunk"], audio):
            out = os.path.join(output_dir,
                               os.path.basename(f) + "_synthesis.wav")
            summary["audio_s"] += t * hop / sampling_rate
            if lead:
                # trim mel-bucket padding back to the true length
                wavfile.write(out, sampling_rate, wav[: t * hop])
                print(out)
        summary["batches"].append({k: h[k] for k in (
            "rows", "frames", "launches", "vocoder_s")})

    wall0 = time.time()
    chunk_size = (batch_size if pad_batches == "none"
                  else round_batch_to_grid(batch_size))
    inflight = None
    try:
        for group in by_len.values():
            for i in range(0, len(group), chunk_size):
                chunk = group[i: i + chunk_size]
                mel_batch = np.stack([m for _, m, _ in chunk]).astype(
                    np.float32)
                # batch padding (rows repeat the last mel; outputs are
                # trimmed to the real rows): grid rounds off-grid chunks
                # (> 8, not a multiple of 8) up to the 8-grid; full also
                # pads partial tail chunks to the full chunk size; none
                # keeps exact chunk sizes
                target = len(chunk)
                if pad_batches != "none":
                    target = round_batch_to_grid(
                        chunk_size if pad_batches == "full" else target)
                if dp:
                    target = padded_rows(mesh, target)
                if target > len(chunk):
                    mel_batch = np.concatenate(
                        [mel_batch,
                         np.repeat(mel_batch[-1:], target - len(chunk), 0)])
                h = launch(chunk, mel_batch)
                if inflight is not None:
                    write_batch(inflight)
                inflight = h
        if inflight is not None:
            write_batch(inflight)
            inflight = None
    finally:
        # a bad mel file later in the list must not lose the finished
        # in-flight batch
        if inflight is not None:
            write_batch(inflight)
    summary["wall_s"] = time.time() - wall0
    return summary


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-f", "--filelist_path", required=True)
    parser.add_argument("-w", "--waveglow_path", required=True,
                        help="the reference's .pt WaveGlow checkpoint "
                             "(pickled module or state dict); the JAX "
                             "package writes one with train/export_torch."
                             "save_reference_waveglow_checkpoint")
    parser.add_argument("-o", "--output_dir", required=True)
    parser.add_argument("-s", "--sigma", default=1.0, type=float)
    parser.add_argument("-d", "--denoiser_strength", default=0.0, type=float,
                        help="Removes model bias. Start with 0.1 and adjust")
    parser.add_argument("-b", "--batch_size", default=1, type=int)
    parser.add_argument("--sampling_rate", default=16000, type=int)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=list(DTYPES))
    parser.add_argument("--wn_impl", default="flow",
                        choices=["conv", "layer", "flow", "xla", "pallas"],
                        help="coupling nets: flow = the whole-net kernel, "
                             "one launch per flow (default); layer (or the "
                             "JAX CLI's pallas) = the WN layer kernel, one "
                             "launch per layer; conv (or xla) = plain "
                             "torch convs")
    parser.add_argument("--cond_impl", default="dense",
                        choices=["dense", "int8", "auto"],
                        help="int8: cond projections as int8 matmuls; "
                             "auto: measure the int8 worst-utterance SNR "
                             "on this checkpoint and the first input mels "
                             "at start-up, dense below --snr_budget_db")
    parser.add_argument("--snr_budget_db", type=float, default=None,
                        help="worst-utterance SNR budget (dB) of "
                             "--cond_impl auto; default "
                             "eval/int8_snr.DEFAULT_SNR_BUDGET_DB")
    parser.add_argument("--wn_int8_flows", type=int, default=0,
                        help="run the WN in_layer convs of the N narrowest "
                             "flows on int8 codes (needs --wn_impl conv or "
                             "xla; lossy: measure eval/int8_snr.py "
                             "--include_wn_int8 first)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="split each batch's rows over the job's "
                             "processes, one per GPU (torchrun / "
                             "scripts/multiproc.py); rank 0 writes")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="split the WN hidden channel over this many "
                             "processes (needs --wn_impl conv or xla; "
                             "composes with --data_parallel)")
    parser.add_argument("-c", "--config", default=None,
                        help="config.json naming a non-default architecture "
                             "(reference waveglow/config.json schema)")
    parser.add_argument("--mel_bucket", type=int, default=0,
                        help="pad each mel's time axis up to a multiple "
                             "of N frames (last frame repeated; audio "
                             "trimmed to the true length), so distinct "
                             "lengths form full batches; 0 = exact "
                             "lengths")
    parser.add_argument("--pad_batches", default="grid",
                        choices=["grid", "full", "none"],
                        help="batch padding: grid rounds off-grid chunks "
                             "(> 8, not a multiple of 8) up to the 8-grid; "
                             "full also pads partial tail chunks to the "
                             "batch size; none = exact sizes")
    parser.add_argument("--compilation_cache_dir", default="",
                        help="build the hand kernels' libraries into (and "
                             "reuse them from) this directory; default "
                             "$FACPPG_COMPILATION_CACHE, else the "
                             "package's build/ (utils/compilation_cache.py)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    enable_compilation_cache(args.compilation_cache_dir or None)
    main(args.filelist_path, args.waveglow_path, args.output_dir, args.sigma,
         args.denoiser_strength, args.batch_size, args.sampling_rate,
         args.compute_dtype, args.wn_impl, args.cond_impl, args.config,
         args.snr_budget_db, args.pad_batches, args.mel_bucket,
         args.wn_int8_flows, args.data_parallel, args.model_parallel)
