"""Streaming end-to-end accent conversion on one CUDA card (torch).

The port of fac_via_ppg_tpu/eval/streaming.py.  A three-stage pipeline
over a stream of utterances:

  stage 1 (host threads): wav read + Kaldi-convention front end (native
            C++ MFCC) -> AM input features
  stage 2 (device): TDNN PPG forward + Tacotron2 autoregressive mel (the
            decode on the card, k-step chunks replayed as CUDA graphs)
  stage 3 (device): WaveGlow vocoder (its coupling nets on the hand
            written WN kernels) + optional denoiser

Stages are connected by bounded queues so utterance N's host feature
extraction overlaps utterance N-1's device synthesis.  Randomness comes
from one torch.Generator (the JAX package's key), consumed in call order.

CLI: python -m fac_via_ppg_torch.eval.streaming --ppg2mel_model CKPT \\
        --waveglow_model CKPT --filelist wavs.txt --output_dir out/
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy.io import wavfile

from fac_via_ppg_torch.configs.hparams import (
    Tacotron2Config,
    WaveGlowConfig,
    create_hparams_stage,
)
from fac_via_ppg_torch.frontend import ppg as ppg_mod
from fac_via_ppg_torch.models.denoiser import Denoiser
from fac_via_ppg_torch.parallel.mesh import job_device
from fac_via_ppg_torch.utils.compilation_cache import enable_compilation_cache
from fac_via_ppg_torch.utils.inference import (
    get_inference,
    load_tacotron2_model,
    load_waveglow_model,
    waveglow_audio,
)
from fac_via_ppg_torch.utils.numeric import round_batch_to_grid
from fac_via_ppg_torch.weights import move


@dataclass
class StreamResult:
    wav_path: str
    audio: np.ndarray
    audio_seconds: float
    # attributed cost: front-end seconds + this utterance's share of the
    # device call (device wall / micro-batch size) -- sums to pipeline cost
    wall_seconds: float
    # service latency: front-end START -> audio ready.  For micro-batched
    # serving this includes the wait for the batch to fill and the FULL
    # device call (an utterance isn't done until its batch is), i.e. the
    # latency price of throughput batching -- quote p50/p95 of this.
    latency_seconds: float = 0.0
    # on_error='skip': the front-end failure for this utterance (audio is
    # empty); None for successful conversions
    error: Optional[str] = None


_FRONTEND_ERROR = object()


def _frontend_pool(wav_paths, featurize_fn, n_workers: int,
                   queue_depth: int):
    """Lazily yields (path, payload, frontend_seconds, t_start) from a
    pool of host featurization threads (t_start: perf_counter when the
    utterance's front-end processing began -- the latency clock origin).

    `wav_paths` may be any iterable -- including a live/unbounded
    generator: a feeder thread pulls paths one at a time through a
    bounded queue, so production overlaps consumption and nothing is
    drained eagerly.  Yield order follows featurization completion, not
    input order.

    A featurization failure does NOT kill the worker: the item is
    yielded with `payload is _FRONTEND_ERROR` and the exception in the
    frontend_seconds slot -- the consumer decides (raise vs skip).  A
    failure of the source iterable itself is re-raised at stream end.
    """
    path_q: queue.Queue = queue.Queue(maxsize=max(queue_depth, 1))
    feat_q: queue.Queue = queue.Queue(maxsize=max(queue_depth, 1))
    _PSENT = object()
    _SENT = object()
    errors = []
    live = [n_workers]
    live_lock = threading.Lock()

    def feeder():
        try:
            for p in wav_paths:
                path_q.put(p)
        except BaseException as e:
            errors.append(e)
        finally:
            for _ in range(n_workers):
                path_q.put(_PSENT)

    def worker():
        try:
            while True:
                path = path_q.get()
                if path is _PSENT:
                    break
                t0 = time.perf_counter()
                try:
                    payload = featurize_fn(path)
                except Exception as e:  # per-utterance: worker survives
                    feat_q.put((path, _FRONTEND_ERROR, e, t0))
                    continue
                feat_q.put((path, payload, time.perf_counter() - t0, t0))
        except BaseException as e:
            errors.append(e)
        finally:
            with live_lock:
                live[0] -= 1
                if live[0] == 0:
                    feat_q.put(_SENT)

    threading.Thread(target=feeder, daemon=True).start()
    for _ in range(n_workers):
        threading.Thread(target=worker, daemon=True).start()

    while True:
        item = feat_q.get()
        if item is _SENT:
            if errors:
                raise errors[0]
            return
        yield item


class StreamingAccentConverter:
    def __init__(self, t2_cfg: Tacotron2Config, tacotron_params,
                 tacotron_state, wg_cfg: WaveGlowConfig, waveglow_params,
                 deps: Optional[ppg_mod.DependenciesPPG] = None,
                 sigma: float = 0.6, denoiser_strength: float = 0.005,
                 queue_depth: int = 4, serving_dtype=None,
                 fused: bool = False, batch_size: int = 1,
                 frontend_threads: int = 1, pipeline_depth: int = 2,
                 on_error: str = "raise", cond_impl: str = "dense",
                 calibration_mel=None, snr_budget_db=None,
                 pad_to_grid: bool = True, device=None,
                 data_parallel: bool = False, model_parallel: int = 1):
        """Parameters are the port's (`weights.py` converts the JAX
        package's); they are moved to `device` (None means "cuda", which
        raises without a card).

        `data_parallel` / `model_parallel` (fused only) spread each
        micro-batch over the job's processes (eval/fused.py); every rank
        streams the same wavs and must form the same micro-batches, so
        data parallelism takes one front-end thread (the pool yields in
        completion order), and every rank yields every result."""
        if (data_parallel or model_parallel > 1) and not fused:
            raise ValueError("data_parallel / model_parallel need "
                             "fused=True")
        if data_parallel and frontend_threads > 1:
            raise ValueError(
                "data_parallel streaming needs frontend_threads=1: every "
                "rank must form the same micro-batches, and several "
                "front-end threads yield in completion order")
        self.device = dev = job_device(device)
        self.t2_cfg = t2_cfg
        self.tacotron_params = move(tacotron_params, dev)
        self.tacotron_state = move(tacotron_state, dev)
        self.wg_cfg = wg_cfg
        self.waveglow_params = move(waveglow_params, dev)
        self.deps = deps or ppg_mod.DependenciesPPG()
        self.sigma = sigma
        self.denoiser = (
            Denoiser(wg_cfg, self.waveglow_params)
            if denoiser_strength > 0 else None
        )
        self.denoiser_strength = denoiser_strength
        if batch_size > 8 and batch_size % 8:
            grid = round_batch_to_grid(batch_size)
            mitigation = (
                f"Micro-batches are auto-padded to {grid} rows on the "
                f"device (FusedSynthesizer pad_to_grid), so throughput is "
                f"{batch_size}/{grid} of that grid point; prefer 8/16/24 "
                "to not waste the pad rows."
                if pad_to_grid else
                "pad_to_grid=False runs the off-grid program as-is; "
                "prefer 8/16/24."
            )
            warnings.warn(
                f"batch_size {batch_size} is off the tile grid (multiples "
                "of 8): the JAX package measured off-grid batches slower "
                "on the TPU; on the card it is not measured.  "
                + mitigation,
                stacklevel=2,
            )
        self.queue_depth = max(queue_depth, 2 * batch_size)
        self.serving_dtype = serving_dtype
        self.batch_size = batch_size
        self.frontend_threads = frontend_threads
        # max micro-batches in flight on the device (batch_size > 1 only):
        # depth 2 launches batch N+1 before batch N's PCM readback; depth
        # 1 is the synchronous loop.
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # per-utterance front-end failures: 'raise' aborts the stream,
        # 'skip' yields an error-annotated StreamResult and keeps serving
        # the rest
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', "
                             f"got {on_error!r}")
        self.on_error = on_error
        self.fused = None
        if fused:
            # the device side of a micro-batch runs back to back on the
            # card (eval/fused.py); the host front end still overlaps on
            # the worker threads, feeding features instead of PPGs.  With
            # batch_size > 1 the consumer drains up to that many
            # featurized utterances per fused call.
            from fac_via_ppg_torch.eval.fused import FusedSynthesizer

            self.fused = FusedSynthesizer(
                t2_cfg, self.tacotron_params, self.tacotron_state, wg_cfg,
                self.waveglow_params, deps=self.deps, sigma=sigma,
                denoiser_strength=denoiser_strength,
                serving_dtype=serving_dtype,
                max_frames=t2_cfg.max_decoder_steps,
                cond_impl=cond_impl,
                calibration_mel=calibration_mel,
                snr_budget_db=snr_budget_db,
                pad_to_grid=pad_to_grid,
                device=dev,
                data_parallel=data_parallel,
                model_parallel=model_parallel,
            )
        elif batch_size > 1:
            raise ValueError("batch_size > 1 requires fused=True")
        elif cond_impl != "dense":
            raise ValueError("cond_impl needs fused=True")

    def _generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(self.device).manual_seed(0)

    def prewarm(self, utt_seconds: float = 4.0, generator=None):
        """Run one dummy micro-batch before serving, output discarded.

        On the card this captures the decode's CUDA graphs for the
        prewarm shape (B = batch_size, T_in = utt_seconds of frames
        rounded to the feature bucket) and lets cuBLAS / cuDNN pick their
        kernels, so that the first real micro-batch of that shape does
        not pay them inside its latency window -- which, because the
        front-end pool has already timestamped every queued utterance,
        would leak into the latency clock of every utterance featurized
        meanwhile.  Fused mode only (the staged path is not the
        latency-quoted path)."""
        if self.fused is None:
            return
        generator = (generator if generator is not None else
                     torch.Generator(self.device).manual_seed(0x9e3779))
        n_frames = max(int(utt_seconds * 100), 1)
        t_pad = -(-n_frames // self.fused.feat_bucket) * self.fused.feat_bucket
        feats = np.zeros((t_pad, int(self.deps.lda.shape[0])), np.float32)
        if self.batch_size == 1:
            self.fused.synthesize_features(feats, n_frames, generator)
        else:
            self.fused.synthesize_feature_pairs(
                [(feats, n_frames)] * self.batch_size, generator,
                pad_batch_to=self.batch_size,
            )

    def _error_result(self, path, exc, t_arr) -> StreamResult:
        """on_error='skip': an empty, error-annotated result; 'raise':
        abort the stream with the front-end failure."""
        if self.on_error == "raise":
            raise RuntimeError(
                f"front-end failed for {path!r} (on_error='skip' serves "
                f"past per-utterance failures)"
            ) from exc
        return StreamResult(
            wav_path=path,
            audio=np.zeros(0, np.float32),
            audio_seconds=0.0,
            wall_seconds=0.0,
            latency_seconds=time.perf_counter() - t_arr,
            error=f"{type(exc).__name__}: {exc}",
        )

    def run(self, wav_paths, generator=None):
        """Yields StreamResult per utterance, with stage overlap."""
        if self.fused is not None:
            yield from self._run_fused(wav_paths, generator)
            return
        generator = self._generator(generator)
        stream = _frontend_pool(
            wav_paths,
            lambda p: ppg_mod.get_ppg(p, self.deps, device=self.device),
            n_workers=max(1, self.frontend_threads),
            queue_depth=self.queue_depth,
        )
        for path, teacher_ppg, frontend_s, t_arr in stream:
            if teacher_ppg is _FRONTEND_ERROR:
                yield self._error_result(path, frontend_s, t_arr)
                continue
            t0 = time.perf_counter()
            # Length-bucketed shapes throughout: one captured decode graph
            # serves every utterance length of a bucket.
            mel = get_inference(
                teacher_ppg, self.t2_cfg, self.tacotron_params,
                self.tacotron_state, generator, pad_to_frames=64,
            )
            t_mel = mel.shape[-1]
            bucket = 100
            t_pad = ((t_mel + bucket - 1) // bucket) * bucket
            mel = torch.nn.functional.pad(mel, (0, t_pad - t_mel),
                                          value=float(np.log(1e-5)))
            audio = waveglow_audio(
                mel, self.wg_cfg, self.waveglow_params, self.sigma,
                generator, dtype=self.serving_dtype,
            ).float()
            if self.denoiser is not None:
                with torch.no_grad():
                    audio = self.denoiser(
                        audio, strength=self.denoiser_strength)[:, 0, :]
            audio = audio[0, : t_mel * self.wg_cfg.hop_length].cpu().numpy()
            t_done = time.perf_counter()
            yield StreamResult(
                wav_path=path,
                audio=audio,
                audio_seconds=len(audio) / 16000.0,
                wall_seconds=t_done - t0 + frontend_s,
                latency_seconds=t_done - t_arr,
            )

    def _run_fused(self, wav_paths, generator=None):
        """Fused streaming: host featurization on worker thread(s), one
        device program + one readback per micro-batch of `batch_size`
        utterances (1 = per utterance).  Micro-batches block until full
        (the stream tail flushes partial, padded to the batch shape) -- a
        throughput mode; for lowest per-utterance latency use
        batch_size=1.

        Up to `pipeline_depth` micro-batches stay in flight: batch N+1 is
        launched (`launch_feature_pairs` returns once the decode's stop is
        read, with the vocoder and PCM still queued on the card) before
        batch N's PCM readback."""
        generator = self._generator(generator)
        stream = _frontend_pool(
            wav_paths, self.fused.featurize,
            n_workers=max(1, self.frontend_threads),
            queue_depth=self.queue_depth,
        )

        pending = []
        inflight: list = []  # FIFO of (batch, handle, t_launch)
        last_done = [0.0]

        def launch():
            nonlocal pending
            batch, pending = pending, []
            handle = self.fused.launch_feature_pairs(
                [pair for _, pair, _, _ in batch], generator,
                pad_batch_to=self.batch_size,
            )
            inflight.append((batch, handle, time.perf_counter()))

        def collect():
            batch, handle, t0 = inflight.pop(0)
            pcms = self.fused.collect_feature_pairs(handle)
            t_done = time.perf_counter()
            # Critical-path attribution: when batches overlap, this
            # batch's pipeline cost is the time it advanced the stream
            # past the previous collect, not its full launch->done span.
            device_s = (t_done - max(t0, last_done[0])) / len(batch)
            last_done[0] = t_done
            for (path, _, frontend_s, t_arr), pcm in zip(batch, pcms):
                yield StreamResult(
                    wav_path=path,
                    audio=pcm.astype(np.float32) / 32767.0,
                    audio_seconds=len(pcm) / 16000.0,
                    wall_seconds=device_s + frontend_s,
                    latency_seconds=t_done - t_arr,
                )

        for item in stream:
            if item[1] is _FRONTEND_ERROR:
                path, _, exc, t_arr = item
                yield self._error_result(path, exc, t_arr)
                continue
            if self.batch_size == 1:
                # one utterance a program: the lowest-latency path
                path, (feats, t), frontend_s, t_arr = item
                t0 = time.perf_counter()
                pcm = self.fused.synthesize_features(feats, t, generator)
                t_done = time.perf_counter()
                yield StreamResult(
                    wav_path=path,
                    audio=pcm.astype(np.float32) / 32767.0,
                    audio_seconds=len(pcm) / 16000.0,
                    wall_seconds=t_done - t0 + frontend_s,
                    latency_seconds=t_done - t_arr,
                )
                continue
            pending.append(item)
            if len(pending) >= self.batch_size:
                launch()
                if len(inflight) >= self.pipeline_depth:
                    yield from collect()
        if pending:
            launch()
        while inflight:
            yield from collect()


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--ppg2mel_model", required=True)
    parser.add_argument("--waveglow_model", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--sigma", type=float, default=0.6)
    parser.add_argument("--denoiser_strength", type=float, default=0.005)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="WaveGlow serving dtype")
    parser.add_argument("--data_parallel", action="store_true",
                        help="spread each fused micro-batch over the job's "
                             "processes, one per GPU (torchrun / "
                             "scripts/multiproc.py; needs --fused and one "
                             "front-end thread); rank 0 writes")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="split WaveGlow's WN channels over this many "
                             "processes (needs --fused; composes with "
                             "--data_parallel)")
    parser.add_argument("--fused", action="store_true",
                        help="the device side of a micro-batch back to "
                             "back on the card (eval/fused.py)")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="fused micro-batch: utterances per device call "
                             "(throughput mode; needs --fused)")
    parser.add_argument("--frontend_threads", type=int, default=1,
                        help="host front-end worker threads")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="micro-batches in flight on the device "
                             "(batch_size > 1): 2 launches the next batch "
                             "before the PCM readback; 1 = synchronous")
    parser.add_argument("--on_error", default="raise",
                        choices=["raise", "skip"],
                        help="per-utterance front-end failures: abort "
                             "the stream, or log + keep serving")
    parser.add_argument("--cond_impl", default="dense",
                        choices=["dense", "int8", "auto"],
                        help="int8: the vocoder's cond projections as int8 "
                             "matmuls, on the whole-net flow kernel (lossy; "
                             "needs --fused).  auto: measure the int8 "
                             "worst-utterance SNR on this deployment's own "
                             "checkpoint + first inputs at startup and "
                             "fall back to dense below --snr_budget_db")
    parser.add_argument("--snr_budget_db", type=float, default=None,
                        help="worst-utterance SNR budget (dB) for "
                             "--cond_impl auto; default "
                             "eval/int8_snr.DEFAULT_SNR_BUDGET_DB")
    parser.add_argument("--compilation_cache_dir", default="",
                        help="build the hand kernels' libraries into (and "
                             "reuse them from) this directory; default "
                             "$FACPPG_COMPILATION_CACHE, else the "
                             "package's build/ (utils/compilation_cache.py)")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Run the CLI on `argv` (default: sys.argv).  `device=None` means the
    CUDA card (raises without one); tests pass "cpu"."""
    args = parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir or None)
    dev = job_device(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    hparams = create_hparams_stage()
    t2_cfg = Tacotron2Config.from_hparams(hparams)
    wg_cfg = WaveGlowConfig()
    t2_params, t2_state = load_tacotron2_model(args.ppg2mel_model, t2_cfg)
    wg_params = load_waveglow_model(args.waveglow_model, wg_cfg)

    with open(args.filelist) as f:
        wavs = [line.strip() for line in f if line.strip()]
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)

    calibration_mel = None
    if args.cond_impl == "auto":
        # calibrate the int8 gate on this deployment's own first inputs
        from fac_via_ppg_torch.eval.int8_snr import calibration_mel_from_wavs

        calibration_mel = calibration_mel_from_wavs(wavs, wg_cfg)

    converter = StreamingAccentConverter(
        t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
        sigma=args.sigma, denoiser_strength=args.denoiser_strength,
        serving_dtype=(None if args.compute_dtype == "float32"
                       else getattr(torch, args.compute_dtype)),
        fused=args.fused, batch_size=args.batch_size,
        frontend_threads=args.frontend_threads,
        pipeline_depth=args.pipeline_depth,
        on_error=args.on_error,
        cond_impl=args.cond_impl,
        calibration_mel=calibration_mel,
        snr_budget_db=args.snr_budget_db,
        device=dev,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
    )
    total_audio = total_wall = 0.0
    steady_audio = steady_wall = 0.0
    latencies = []
    n = 0
    # With micro-batching every result of the first flush shares the
    # first device call (the decode graphs' capture, cuBLAS / cuDNN
    # warm-up), so the whole first batch is warmup.
    warm = args.batch_size if args.batch_size > 1 else 1
    t_start = time.perf_counter()
    for result in converter.run(wavs):
        if result.error is not None:
            # not counted toward the warm window (an error result isn't a
            # served utterance, and bumping n would let the warm-up-laden
            # first micro-batch leak into the steady-state numbers)
            print(f"SKIPPED {result.wav_path}: {result.error}")
            continue
        out = os.path.join(
            args.output_dir,
            os.path.basename(result.wav_path).replace(".wav", "_ac.wav"),
        )
        if lead:
            wavfile.write(
                out, 16000,
                (np.clip(result.audio, -1, 1) * 32767).astype(np.int16),
            )
        total_audio += result.audio_seconds
        total_wall += result.wall_seconds
        if n >= warm:  # earlier results pay the warm-up
            steady_audio += result.audio_seconds
            steady_wall += result.wall_seconds
            latencies.append(result.latency_seconds)
        n += 1
        print(
            f"{out}: {result.audio_seconds:.2f}s audio in "
            f"{result.wall_seconds:.2f}s"
        )
    pipeline_wall = time.perf_counter() - t_start
    if total_audio:
        print(
            f"stream RTF {total_audio / pipeline_wall:.2f}x incl. warm-up; "
            f"steady-state {steady_audio / max(steady_wall, 1e-9):.2f}x"
        )
    if latencies:
        print(
            "per-utterance latency p50 "
            f"{np.percentile(latencies, 50):.3f}s / p95 "
            f"{np.percentile(latencies, 95):.3f}s "
            "(front-end start -> audio ready, incl. micro-batch wait)"
        )


if __name__ == "__main__":
    main()
