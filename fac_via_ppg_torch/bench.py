"""The port's benchmark: WaveGlow synthesis real-time factor on one CUDA
card (the port of the JAX package's root bench.py).

    python -m fac_via_ppg_torch.bench [--config rtf] [options]

prints ONE JSON line, {"metric", "value", "unit", "detail"}; `detail`
names the card (torch.cuda.get_device_name) and the TF32 settings the run
kept (PyTorch's defaults unless the caller changed them).

Default protocol (`--config rtf`): full-size WaveGlow (random seeded
weights, the FLOPs of trained ones), weight norm folded as in deployment,
batch 24 x 10 s of audio per call, bf16 with f32 accumulation, the
coupling nets on the whole-net flow kernel (`--wn_impl flow`, the port's
default: one launch per flow) and the stacked cond projections as int8
matmuls (`--cond_impl int8`), 3 warm-up + 10 timed calls, each call's
scalar read back to the host inside the timed window.  The detail adds
the same calls with one and two calls in flight (each result still read
back inside the window), the dense-cond bf16 figure and the f32 figure.
A figure that fails fails the run.

Other configurations (one JSON line each):
    --config e2e              one wav -> PPG -> mel -> wav, staged
    --config e2e_fused        one wav through FusedSynthesizer
    --config e2e_fused_batch  --batch wavs per FusedSynthesizer call
    --config streaming        StreamingAccentConverter, staged
    --config streaming_fused  the same, fused (--batch micro-batches)
    --config train_ppg2mel    the Tacotron2 train step
    --config train_waveglow   the WaveGlow train step

`--wn_impl` takes the JAX bench's names too: xla (the port's conv
formulation) and pallas (the WN layer kernel).  The WN int8 rungs
(`--wn_int8_flows N`, `--wn_int8_rs_flows N`, `--wn_int8_quant tensor`)
run on the conv formulation only (`--wn_impl conv` or `xla`); as in the
JAX bench, a rung's line leaves out the dense and f32 figures.
`--grouped_upsample` is taken for the JAX bench's sake and changes
nothing: the port has one upsampler layout, the JAX package's grouped one
(models/waveglow.py::upsample_grouped), and the line records the flag.
Every function takes its sizes as arguments, so
that a test can run it tiny with `device="cpu"`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from fac_via_ppg_torch.configs.hparams import (
    Tacotron2Config,
    WaveGlowConfig,
    create_hparams,
    create_hparams_stage,
)
from fac_via_ppg_torch.eval.rtf import Window, readback, scalar
from fac_via_ppg_torch.models.waveglow import resolve_wn_impl
from fac_via_ppg_torch.utils.device import device_name, resolve_device

def tf32_state() -> dict:
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def _runs(detail: dict, key: str, runs: list) -> None:
    if len(runs) > 1:
        detail[key] = [round(r, 2) for r in runs]


def bench_waveglow_rtf(batch: int = 24, seconds: float = 10.0,
                       warmup: int = 3, iters: int = 10,
                       wn_impl: str = "flow", cond_impl: str = "int8",
                       repeats: int = 1, wn_int8_flows: int = 0,
                       wn_int8_quant: str = "column",
                       wn_int8_rs_flows: int = 0,
                       cfg: Optional[WaveGlowConfig] = None,
                       device=None, mesh=None) -> dict:
    """The vocoder's real-time factor (see the module doc).  `mesh` with
    a model axis above 1 (parallel/mesh.py; every rank of the job calls)
    times the tensor-parallel conv formulation, each rank on its slices
    of the params and of the int8 packs."""
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        remove_weightnorm,
        serving_form,
        waveglow_serve,
    )
    from fac_via_ppg_torch.weights import move

    wn_impl = resolve_wn_impl(wn_impl)
    cfg = cfg or WaveGlowConfig()
    rung = bool(wn_int8_flows or wn_int8_rs_flows)
    dev = mesh.device if mesh is not None else resolve_device(device)
    sr = 16000
    n_frames = int(seconds * sr) // cfg.hop_length
    params = move(remove_weightnorm(
        init_waveglow(cfg, torch.Generator().manual_seed(0))), dev)
    mel = torch.as_tensor(
        np.random.RandomState(0).randn(batch, cfg.n_mel_channels, n_frames),
        dtype=torch.float32, device=dev) * 0.5 - 5.0
    served = {}

    def serving(dtype, ci):
        """(serving form, mel) in `dtype` (None: f32), built once a
        dtype: the vocoder CLI's serving form, its int8 weights from the
        un-cast params.  `ci="dense"` on an int8 form serves the same
        weights with the dense cond."""
        if dtype not in served:
            served[dtype] = (serving_form(
                cfg, params, dtype=dtype, wn_impl=wn_impl,
                cond_impl=cond_impl, wn_int8_flows=wn_int8_flows,
                wn_int8_quant=wn_int8_quant,
                wn_int8_rs_flows=wn_int8_rs_flows, mesh=mesh),
                mel if dtype is None else mel.to(dtype))
        form, m = served[dtype]
        if ci != form.cond_impl:
            form = dataclasses.replace(form, cond_impl=ci)
        return form, m

    def measure(dtype, b=batch, pipelined=False, ci=None, depth=1):
        """Serial protocol: each call's scalar read back before the next
        call is launched.  Pipelined: up to `depth` calls in flight, each
        result still read back inside the timed window, so only the
        readback overlaps the card's work (the eval/streaming.py
        pipeline_depth pattern).  `repeats` > 1 times the window that many
        times; returns (median RTF, total seconds, each window's RTF)."""
        form, m = serving(dtype, cond_impl if ci is None else ci)
        mel_b = m[:b]

        def call(i):
            g = torch.Generator(dev).manual_seed(i)
            return scalar(waveglow_serve(form, mel_b, 0.6, g))

        with torch.no_grad():
            for i in range(warmup):
                call(i).item()
            audio_seconds = iters * b * (n_frames * cfg.hop_length) / sr
            rtfs, elapsed_total = [], 0.0
            for _ in range(max(repeats, 1)):
                with Window(dev) as w:
                    inflight = []
                    for i in range(iters):
                        cur = call(100 + i)
                        if not pipelined:
                            cur.item()
                            continue
                        inflight.append(cur)
                        if len(inflight) > depth:
                            inflight.pop(0).item()
                    for c in inflight:
                        c.item()
                rtfs.append(audio_seconds / w.seconds)
                elapsed_total += w.seconds
        return float(np.median(rtfs)), elapsed_total, rtfs

    # Serving precision is bf16 (f32 accumulation, f32 1x1 inverses).
    rtf_bf16, elapsed, runs = measure(torch.bfloat16)
    detail = {
        "batch": batch,
        "seconds_per_utt": seconds,
        "iters": iters,
        "repeats": max(repeats, 1),
        "elapsed_s": round(elapsed, 3),
        "device": device_name(dev),
        "tf32": tf32_state(),
        "wn_impl": wn_impl,
        "cond_impl": cond_impl,
        "wn_int8_flows": wn_int8_flows,
        "wn_int8_quant": wn_int8_quant if wn_int8_flows else None,
        "wn_int8_rs_flows": wn_int8_rs_flows,
    }
    if mesh is not None:
        detail["mesh"] = dict(mesh.shape)
    if len(runs) > 1:
        detail["rtf_runs"] = [round(r, 2) for r in runs]
        detail["rtf_min"] = round(min(runs), 2)
        detail["rtf_max"] = round(max(runs), 2)
    rtf_piped, _, piped_runs = measure(torch.bfloat16, pipelined=True)
    detail["rtf_pipelined"] = round(rtf_piped, 2)
    _runs(detail, "rtf_pipelined_runs", piped_runs)
    rtf_p2, _, p2_runs = measure(torch.bfloat16, pipelined=True, depth=2)
    detail["rtf_pipelined_depth2"] = round(rtf_p2, 2)
    _runs(detail, "rtf_pipelined_depth2_runs", p2_runs)
    line = {"metric": "waveglow_rtf", "value": round(rtf_bf16, 2),
            "unit": "x_realtime", "detail": detail}
    if rung:
        # a rung's line: its comparators are the plain line's figures
        return line
    if cond_impl != "dense":
        # the dense bf16 figure, so the int8 gain shows in one line
        detail["rtf_bf16_dense"] = round(
            measure(torch.bfloat16, ci="dense")[0], 2)
    # f32 at the headline batch; halved while it does not fit the card
    f32_batch = batch
    while True:
        try:
            rtf_f32 = measure(None, b=f32_batch, ci="dense")[0]
            break
        except torch.cuda.OutOfMemoryError:
            if f32_batch == 1:
                raise
            served.clear()
            torch.cuda.empty_cache()
            f32_batch //= 2
    detail["rtf_float32"] = round(rtf_f32, 2)
    detail["f32_batch"] = f32_batch
    if f32_batch != batch:
        detail["f32_note"] = (f"f32 measured at batch {f32_batch}, not the "
                              f"headline batch {batch}: batch {2 * f32_batch}"
                              " did not fit the card's memory")
    return line


class Models(NamedTuple):
    t2_cfg: Tacotron2Config
    t2_params: dict
    t2_state: dict
    wg_cfg: WaveGlowConfig
    wg_params: dict
    deps: object


def full_size_models() -> Models:
    """Full-size random-weight model pair (the stage hparams' Tacotron2,
    the default WaveGlow in its serving form) and the PPG dependencies
    (the substitute AM in data/am/, generated on first use), on the CPU."""
    from fac_via_ppg_torch.frontend import ppg as ppg_mod
    from fac_via_ppg_torch.models import init_tacotron2, init_waveglow
    from fac_via_ppg_torch.models.waveglow import remove_weightnorm

    t2_cfg = Tacotron2Config.from_hparams(create_hparams_stage())
    t2_params, t2_state = init_tacotron2(t2_cfg,
                                         torch.Generator().manual_seed(0))
    wg_cfg = WaveGlowConfig()
    wg_params = remove_weightnorm(
        init_waveglow(wg_cfg, torch.Generator().manual_seed(1)))
    return Models(t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
                  ppg_mod.DependenciesPPG())


def synth_wavs(tmpdir: str, n: int, seconds: float):
    """`n` seeded 16 kHz wavs of `seconds`: a modulated tone each."""
    from scipy.io import wavfile

    paths = []
    rng = np.random.RandomState(0)
    t = np.arange(int(seconds * 16000)) / 16000.0
    for i in range(n):
        f0 = 120 + 40 * rng.rand()
        wav = (np.sin(2 * np.pi * f0 * t)
               * (0.4 + 0.2 * np.sin(2 * np.pi * 3 * t)))
        p = f"{tmpdir}/utt{i}.wav"
        wavfile.write(p, 16000, (wav * 12000).astype(np.int16))
        paths.append(p)
    return paths


def fused_synthesizer(models: Models, n_frames: int, cond_impl: str, dev):
    """The e2e_fused configurations' FusedSynthesizer: bf16 WaveGlow, the
    gate held off, every request decoding `n_frames`."""
    from fac_via_ppg_torch.eval.fused import FusedSynthesizer

    t2_cfg = dataclasses.replace(models.t2_cfg, gate_threshold=1.01)
    return FusedSynthesizer(
        t2_cfg, models.t2_params, models.t2_state, models.wg_cfg,
        models.wg_params, deps=models.deps, serving_dtype=torch.bfloat16,
        max_frames=n_frames, cond_impl=cond_impl, device=dev)


def bench_e2e_latency(utt_seconds: float = 4.0, warmup: int = 2,
                      iters: int = 5, models: Optional[Models] = None,
                      device=None) -> dict:
    """One utterance: wav -> PPG -> autoregressive mel -> WaveGlow (bf16)
    -> denoiser -> wav, staged, each stage's result handed to the next.

    Random weights, so the gate never fires reliably: the decoder is
    pinned to exactly `utt_seconds` worth of frames (gate_threshold > 1),
    the length a trained model would produce."""
    from fac_via_ppg_torch.frontend import ppg as ppg_mod
    from fac_via_ppg_torch.models.denoiser import Denoiser
    from fac_via_ppg_torch.utils.inference import (
        get_inference,
        waveglow_audio,
    )
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    models = models or full_size_models()
    n_frames = int(utt_seconds * 100)  # 10 ms hop
    t2_cfg = dataclasses.replace(models.t2_cfg, max_decoder_steps=n_frames,
                                 gate_threshold=1.01)
    t2_params, t2_state = move(models.t2_params, dev), \
        move(models.t2_state, dev)
    wg_params = move(models.wg_params, dev)
    denoiser = Denoiser(models.wg_cfg, wg_params)

    with tempfile.TemporaryDirectory() as td:
        paths = synth_wavs(td, warmup + iters, utt_seconds)
        lat = []
        for i, p in enumerate(paths):
            g = torch.Generator(dev).manual_seed(i)
            with Window(dev) as w:
                ppg = ppg_mod.get_ppg(p, models.deps, device=dev)
                mel = get_inference(ppg, t2_cfg, t2_params, t2_state, g,
                                    pad_to_frames=64)
                audio = waveglow_audio(mel, models.wg_cfg, wg_params, 0.6,
                                       g, dtype=torch.bfloat16,
                                       pad_to_frames=100)
                with torch.no_grad():
                    readback(denoiser(audio.float(), strength=0.005))
            if i >= warmup:
                lat.append(w.seconds)
    lat_s = float(np.median(lat))
    return {
        "metric": "e2e_latency",
        "value": round(lat_s, 3),
        "unit": "s_per_utt",
        "detail": {
            "utt_seconds": utt_seconds,
            "iters": iters,
            "per_utt_s": [round(x, 3) for x in lat],
            "device": device_name(dev),
            "tf32": tf32_state(),
        },
    }


def bench_e2e_fused(utt_seconds: float = 4.0, warmup: int = 2,
                    iters: int = 5, cond_impl: str = "dense",
                    models: Optional[Models] = None, device=None) -> dict:
    """One utterance per FusedSynthesizer call: one transfer in, one PCM
    readback out."""
    dev = resolve_device(device)
    synth = fused_synthesizer(models or full_size_models(),
                              int(utt_seconds * 100), cond_impl, dev)
    with tempfile.TemporaryDirectory() as td:
        paths = synth_wavs(td, warmup + iters, utt_seconds)
        lat = []
        for i, p in enumerate(paths):
            g = torch.Generator(dev).manual_seed(i)
            with Window(dev) as w:
                pcm = synth(p, generator=g)
            if not pcm.size:
                raise AssertionError(f"no PCM for {p}")
            if i >= warmup:
                lat.append(w.seconds)
    lat_s = float(np.median(lat))
    return {
        "metric": "e2e_latency_fused",
        "value": round(lat_s, 3),
        "unit": "s_per_utt",
        "detail": {
            "utt_seconds": utt_seconds,
            "iters": iters,
            "per_utt_s": [round(x, 3) for x in lat],
            "cond_impl": cond_impl,
            "device": device_name(dev),
            "tf32": tf32_state(),
        },
    }


def bench_e2e_fused_batch(batch: int = 24, utt_seconds: float = 4.0,
                          warmup: int = 2, iters: int = 5,
                          cond_impl: str = "dense",
                          models: Optional[Models] = None,
                          device=None) -> dict:
    """Throughput serving: `batch` utterances per FusedSynthesizer call."""
    dev = resolve_device(device)
    synth = fused_synthesizer(models or full_size_models(),
                              int(utt_seconds * 100), cond_impl, dev)
    with tempfile.TemporaryDirectory() as td:
        paths = synth_wavs(td, batch, utt_seconds)
        for i in range(warmup):
            synth.synthesize_batch(
                paths, generator=torch.Generator(dev).manual_seed(i))
        audio_s = 0.0
        with Window(dev) as w:
            for i in range(iters):
                outs = synth.synthesize_batch(
                    paths, generator=torch.Generator(dev).manual_seed(
                        100 + i))
                audio_s += sum(len(o) for o in outs) / 16000.0
    rtf = audio_s / w.seconds
    return {
        "metric": "e2e_fused_batch_rtf",
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "detail": {
            "batch": batch,
            "utt_seconds": utt_seconds,
            "iters": iters,
            "s_per_batch": round(w.seconds / iters, 3),
            "cond_impl": cond_impl,
            "device": device_name(dev),
            "tf32": tf32_state(),
        },
    }


def bench_streaming(n_utts: int = 8, utt_seconds: float = 4.0,
                    fused: bool = False, batch: int = 1,
                    frontend_threads: int = 1, pipeline_depth: int = 2,
                    cond_impl: str = "dense",
                    models: Optional[Models] = None, device=None) -> dict:
    """Streaming accent conversion throughput (front end overlapped with
    the card's synthesis), steady state after the first micro-batches.
    `batch` > 1 micro-batches the fused calls (throughput mode)."""
    from fac_via_ppg_torch.eval.streaming import StreamingAccentConverter

    warm = 2 * batch  # the first micro-batches capture the decode graphs
    if n_utts < warm + batch:
        n_utts = warm + 3 * batch
    dev = resolve_device(device)
    models = models or full_size_models()
    n_frames = int(utt_seconds * 100)
    t2_cfg = dataclasses.replace(models.t2_cfg, max_decoder_steps=n_frames,
                                 gate_threshold=1.01)
    conv = StreamingAccentConverter(
        t2_cfg, models.t2_params, models.t2_state, models.wg_cfg,
        models.wg_params, deps=models.deps, serving_dtype=torch.bfloat16,
        fused=fused, batch_size=batch, frontend_threads=frontend_threads,
        pipeline_depth=pipeline_depth,
        cond_impl=(cond_impl if fused else "dense"), device=dev)
    # outside the measured stream: the first call's graph captures would
    # otherwise reach the latency clock of every utterance queued meanwhile
    conv.prewarm(utt_seconds)
    # audio produced / wall clock after the warm-up utterances; summing
    # per-utterance seconds would count the overlapped front end twice
    with tempfile.TemporaryDirectory() as td:
        paths = synth_wavs(td, n_utts, utt_seconds)
        audio_s, n_steady, start = 0.0, 0, None
        latencies = []
        for i, r in enumerate(conv.run(paths)):
            if i == warm - 1:
                start = time.perf_counter()
            elif i >= warm:
                audio_s += r.audio_seconds
                n_steady += 1
                latencies.append(r.latency_seconds)
    wall_s = time.perf_counter() - start
    rtf = audio_s / wall_s
    return {
        "metric": "streaming_rtf_fused" if fused else "streaming_rtf",
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "detail": {
            "n_utts": n_utts,
            "utt_seconds": utt_seconds,
            "steady_utts": n_steady,
            "batch": batch,
            "frontend_threads": frontend_threads,
            "pipeline_depth": pipeline_depth if batch > 1 else 1,
            # service latency (front-end start -> audio ready, with the
            # micro-batch fill wait and the whole device call)
            "latency_p50_s": round(float(np.percentile(latencies, 50)), 3),
            "latency_p95_s": round(float(np.percentile(latencies, 95)), 3),
            "cond_impl": cond_impl if fused else "dense",
            "device": device_name(dev),
            "tf32": tf32_state(),
        },
    }


def _compute_dtype(train_dtype: str):
    if train_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown train_dtype {train_dtype!r}")
    return None if train_dtype == "float32" else torch.bfloat16


def bench_train_ppg2mel(warmup: int = 3, iters: int = 20,
                        train_dtype: str = "float32", batch: int = 6,
                        remat: bool = False, frames: int = 400,
                        hparams=None, device=None) -> dict:
    """The PPG2Mel training step at the paper's operating point (batch 6,
    ~4 s utterances = 400 mel frames, Adam + grad clip), hparams
    `create_hparams()` unless given."""
    from fac_via_ppg_torch.models import init_tacotron2
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import make_tacotron2_train_step
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    hp = hparams or create_hparams()
    cfg = Tacotron2Config.from_hparams(hp)
    params, model_state = init_tacotron2(cfg,
                                         torch.Generator().manual_seed(0))
    params, model_state = move(params, dev), move(model_state, dev)
    optimizer = make_optimizer(hp.learning_rate, hp.weight_decay,
                               hp.grad_clip_thresh)
    opt_state = optimizer.init(params)
    step = make_tacotron2_train_step(
        cfg, optimizer, hp.mel_weight, hp.gate_weight,
        compute_dtype=_compute_dtype(train_dtype), remat=remat)

    B, t_in, t_out = batch, frames, frames
    rng = np.random.RandomState(0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    data = (t(np.abs(rng.rand(B, cfg.n_symbols, t_in))),
            t([t_in] * B, torch.int64),
            t(rng.randn(B, cfg.n_acoustic_feat_dims, t_out) * 0.5),
            t(np.zeros((B, t_out))),
            t([t_out] * B, torch.int64))

    def run(i):
        g = torch.Generator(dev).manual_seed(i)
        readback(step(params, model_state, opt_state, data, g).loss)

    for i in range(warmup):
        run(i)
    with Window(dev) as w:
        for i in range(iters):
            run(100 + i)
    s_per_it = w.seconds / iters
    return {
        "metric": "train_ppg2mel_step",
        "value": round(s_per_it, 4),
        "unit": "s_per_iter",
        "detail": {"batch": B, "frames": t_out, "iters": iters,
                   "train_dtype": train_dtype, "remat": remat,
                   "device": device_name(dev), "tf32": tf32_state()},
    }


def bench_train_waveglow(warmup: int = 3, iters: int = 20,
                         train_dtype: str = "float32", batch: int = 3,
                         remat: bool = False, grouped_upsample: bool = False,
                         segment: int = 10000,
                         cfg: Optional[WaveGlowConfig] = None,
                         device=None) -> dict:
    """The WaveGlow training step at the reference config (batch 3,
    10000-sample segments, sigma 0.7071).  `grouped_upsample` is only
    recorded: the step always takes the grouped spect straight from the
    upsampler's phases."""
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        weight_norm_params,
    )
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import make_waveglow_train_step
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    cfg = cfg or WaveGlowConfig()
    params = move(weight_norm_params(
        init_waveglow(cfg, torch.Generator().manual_seed(0))), dev)
    optimizer = make_optimizer(1e-5)
    opt_state = optimizer.init(params)
    step = make_waveglow_train_step(
        cfg, optimizer, sigma=0.7071,
        compute_dtype=_compute_dtype(train_dtype), remat=remat)

    B, seg = batch, segment
    F = -(-seg // cfg.hop_length)  # TacotronSTFT frame count (ceil)
    rng = np.random.RandomState(0)
    data = (torch.as_tensor(rng.randn(B, cfg.n_mel_channels, F) * 0.5 - 5.0,
                            dtype=torch.float32, device=dev),
            torch.as_tensor(rng.randn(B, seg) * 0.1, dtype=torch.float32,
                            device=dev))
    for _ in range(warmup):
        readback(step(params, opt_state, data).loss)
    with Window(dev) as w:
        for _ in range(iters):
            readback(step(params, opt_state, data).loss)
    s_per_it = w.seconds / iters
    return {
        "metric": "train_waveglow_step",
        "value": round(s_per_it, 4),
        "unit": "s_per_iter",
        "detail": {"batch": B, "segment": seg, "iters": iters,
                   "train_dtype": train_dtype, "remat": remat,
                   "grouped_upsample": grouped_upsample,
                   "device": device_name(dev), "tf32": tf32_state()},
    }


CONFIGS = ("rtf", "e2e", "e2e_fused", "e2e_fused_batch", "streaming",
           "streaming_fused", "train_ppg2mel", "train_waveglow")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="rtf", choices=CONFIGS)
    parser.add_argument("--wn_impl", default="flow",
                        choices=["flow", "layer", "conv", "xla", "pallas"],
                        help="rtf: coupling nets on the whole-net flow "
                             "kernel (default), the WN layer kernel "
                             "(layer, or the JAX bench's pallas) or plain "
                             "torch convs (conv, or xla)")
    parser.add_argument("--cond_impl", default="int8",
                        choices=["dense", "int8"],
                        help="int8 (default): the stacked cond projections "
                             "as int8 matmuls (the cond kernel, "
                             "ops/cond_int8.py; lossy, gate it with "
                             "eval/int8_snr.py); dense: bf16.  "
                             "Applies to rtf / e2e_fused / e2e_fused_batch "
                             "/ streaming_fused; e2e and streaming are "
                             "staged and always dense")
    parser.add_argument("--train_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--batch", type=int, default=None,
                        help="utterances per fused call (e2e_fused_batch, "
                             "default 24; streaming_fused micro-batch, "
                             "default 1); train batch (train_ppg2mel 6, "
                             "train_waveglow 3)")
    parser.add_argument("--frontend_threads", type=int, default=1,
                        help="host front-end worker threads (streaming)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute activations in the backward pass "
                             "(torch.utils.checkpoint), for larger batches")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="streaming_fused micro-batches in flight")
    parser.add_argument("--grouped_upsample", action="store_true",
                        help="train_waveglow: recorded only; the port's "
                             "one upsampler already takes the grouped "
                             "spect straight from its phases")
    parser.add_argument("--wn_int8_flows", type=int, default=0,
                        help="rtf: the WN in_layer convs of the N narrowest "
                             "flows on int8 codes (needs --wn_impl conv; "
                             "lossy: measure eval/int8_snr.py "
                             "--include_wn_int8 first)")
    parser.add_argument("--wn_int8_rs_flows", type=int, default=0,
                        help="rtf: the res_skip convs of the N narrowest "
                             "flows on int8 codes (needs --wn_impl conv)")
    parser.add_argument("--wn_int8_quant", default="column",
                        choices=["column", "tensor"],
                        help="the in_layer rung's activation scale: per "
                             "column (three tap products) or per tensor "
                             "(one stacked product)")
    parser.add_argument("--repeats", type=int, default=1,
                        help="rtf: time the window N times; the value is "
                             "the median, the detail holds each run and "
                             "their min / max")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (tiny checks only)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    runners = {
        "rtf": lambda: bench_waveglow_rtf(
            wn_impl=args.wn_impl, cond_impl=args.cond_impl,
            repeats=args.repeats, wn_int8_flows=args.wn_int8_flows,
            wn_int8_quant=args.wn_int8_quant,
            wn_int8_rs_flows=args.wn_int8_rs_flows, device=device),
        "e2e": lambda: bench_e2e_latency(device=device),
        "e2e_fused": lambda: bench_e2e_fused(cond_impl=args.cond_impl,
                                             device=device),
        "e2e_fused_batch": lambda: bench_e2e_fused_batch(
            batch=args.batch or 24, cond_impl=args.cond_impl, device=device),
        "streaming": lambda: bench_streaming(
            frontend_threads=args.frontend_threads, device=device),
        "streaming_fused": lambda: bench_streaming(
            fused=True, batch=args.batch or 1,
            frontend_threads=args.frontend_threads,
            pipeline_depth=args.pipeline_depth, cond_impl=args.cond_impl,
            device=device),
        "train_ppg2mel": lambda: bench_train_ppg2mel(
            train_dtype=args.train_dtype, batch=args.batch or 6,
            remat=args.remat, device=device),
        "train_waveglow": lambda: bench_train_waveglow(
            train_dtype=args.train_dtype, batch=args.batch or 3,
            remat=args.remat, grouped_upsample=args.grouped_upsample,
            device=device),
    }
    out = runners[args.config]()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
