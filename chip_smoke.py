#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; there is no CPU path):
  1. build both kernels at once (csrc/wn_layer.cu, csrc/wn_flow.cu, both
     with the shared bf16 wgmma tile csrc/wn_wgmma.cuh and f32 SIMT tile
     csrc/wn_simt.cuh; one nvcc each for sm_90a) and print their ptxas
     register / spill lines;
  2. print the bf16 and f32 layer kernels' registers, spills (ptxas),
     dynamic shared memory and blocks per SM; hold the WN layer kernel against
     `wn_layer_plain` on the card: dilations 1, 2, 8, 128 and the last
     layer, B=2, T=1000, C=256, in f32 (TF32 off, atol 1e-4) and bf16
     (the wgmma tile with the layer's weight image, atol 3e-2); then all 8
     layers of a flow at the fused path's shapes: bf16 B=4, T=10000 (the
     served batch) and f32 B=1, T=1760 (the denoiser's bias pass);
  3. print the bf16 and f32 flow kernels' registers, spills, dynamic
     shared memory and blocks per SM; hold one tile's GEMM 1 of the wgmma
     tile (its cp.async ring, weight image, swizzles and wgmma
     descriptors) against torch.matmul (atol 1e-3), and of the f32 SIMT
     tile (ring, ownership; atol 1e-4); hold the whole-net flow kernel
     against `wn_flow_plain`: n_half 4, 3 and 2 at B=2, T=1000, C=256, L=8
     in f32 (atol 1e-4) and bf16 (3e-2 x max(1, max|plain|)), bf16 at a
     ragged T=97; then the vocoder CLI's shape, bf16 B=8, T=10240;
  4. hold WaveGlow on each kernel ("layer", "flow") against its conv
     formulation (plain torch) on one short mel, f32, atol 1e-4;
  5. serve 8 seeded synthetic wavs (2-4 s, 16 kHz) as two batches of 4
     through FusedSynthesizer.launch_feature_pairs / collect_feature_pairs
     at the full default configs (random seeded weights), bf16 WaveGlow,
     max_frames=500; check each PCM and that the layer kernel ran >= 96
     times per batch; time one batch stage by stage, with WaveGlow on the
     layer kernel, the flow kernel and the conv formulation; profile one
     batch (torch.profiler): device busy share, top kernels;
  6. run the batched vocoder CLI (scripts/waveglow_inference.main) at the
     full WaveGlowConfig(), seeded random weights written as a .pt state
     dict by the port's exporter: 16 seeded mels of 449-512 frames, -b 8
     --mel_bucket 64 -s 0.6 -d 0.005, bf16, --wn_impl flow (two batches of
     8 x 512 frames); check each wav and 12 flow kernel launches per
     batch; then --cond_impl auto over the first 8 mels; profile one
     batch's device work; check torch._int_mm against the exact int32 CPU
     product, bit for bit;
  7. time both kernels and their plain versions at their main path's
     shapes, with each one's bound; and both f32 forms, held against their
     plain versions, at the synthesis CLI's shape (B=8, T=20000: 8
     requests x 1000 frames), with their f32 bounds and the SM clock and
     power draw while each runs;
  8. the synthesis CLI (scripts/generate_synthesis.main) at full width:
     write the substitute bundle (5816 senones, 3 x 256) and a binary copy
     of its AM (frontend/nnet3_binary.write_nnet3_binary), and hold the
     binary AM's arrays and PPGs on the card equal to the text AM's; write
     a seeded Tacotron2 in the reference's .pt format
     (save_reference_tacotron2_checkpoint; gate bias -10, so every request
     decodes all 1000 steps) and a WaveGlow .pt state dict; run the CLI
     in-process on the binary AM with the hparams' defaults (f32
     WaveGlow): (a) one wav staged, (b) the same wav --fused, (c) 8 wavs
     as a directory, --batch_size 8, (d) (c) with --cond_impl int8, (e)
     (c) with --cond_impl auto; check every wav (16 kHz int16, finite, not
     constant, 1000 * hop long), >= 96 layer kernel launches per dense
     batch and 12 flow kernel launches per int8 batch; profile one batch
     of (c);
  9. streaming, and the decode on the card (models/tacotron2.py::decode:
     k-step chunks, each a CUDA graph replay): (a) at B=8, T_in=448,
     M=1000 (full-width Tacotron2, seeded, one set of prenet masks), the
     public batched entry (graphs) against the eager chunk loop (its plain
     version), gate held off and at a gate setting that stops the 8
     sequences at different steps (picked from the held-off run's gate
     logits, printed); then B=1 (tacotron2_inference) the same way:
     lengths / end step exact, mel, gate and alignments within 1e-5;
     (b) that decode timed, eager against graph in turns, for each k of
     CHUNK_SWEEP, and profiled; (c) StreamingAccentConverter at full width
     (fused, batch 8, 2 front-end threads, pipeline depth 2, bf16
     WaveGlow, max_frames 500) after prewarm() over 24 seeded wavs of
     2-4 s: every PCM checked, >= 96 layer kernel launches a batch, the
     native MFCC built and serving; depth 1 against depth 2 on one
     front-end thread, bit for bit; cond_impl="int8" (12 flow kernel
     launches a batch); the staged route over 2 wavs; the native MFCC
     against numpy at dither 0 (1e-3); (d) the streaming CLI in-process on
     a generated .pt pair, --fused --batch_size 8 over 8 wavs;
 10. training (TF32 off): (a) one Tacotron2 train step at full width
     (B=2, T_in=T_out=96, every dropout mask injected) and one WaveGlow
     step (full WaveGlowConfig, one 10000-sample segment) on the card
     against the same step on the CPU: loss to 1e-5 relative, each
     gradient leaf to 1e-4 of its norm (the conv biases that a training
     batch norm follows, whose gradient is rounding noise, to 1e-4 of
     the whole gradient's norm), the params after the step to 1e-5 where
     the gradient's sign is determined, elsewhere to 2 lr (Adam's first
     update is +-lr); Tacotron2 in f64 and f32, its f32 gradient bound
     waived where a relu input takes the other side of zero on the card
     (counted, `relu_sign_flips`), WaveGlow in f32; (b)
     scripts/train_ppg2mel.main in-process at create_hparams()'s defaults
     (full PPG, batch 6, length buckets of 128) on the substitute AM, 24
     seeded 2-4 s wavs and 6 for validation (the f32 run with
     featurize_device=True: the device front end featurizes the training
     set, which it caches, and each run's validation set, counted; the
     bf16 run with the default preload, the host MFCC and the TDNN on the
     card, reading that cache): 20 iterations, validation and a checkpoint every 10, then
     checkpoint_path=auto (resumes at 11) for one epoch, in f32 and bf16;
     every loss finite, the checkpoint round-trips; (c)
     scripts/train_waveglow.main at the full config,
     batch 3, segments of 10000, 18 wavs: 24 iterations, a checkpoint
     every 10, then auto-resume, f32 and bf16.  Each step timed between two
     synchronizes, the fifth profiled;
 11. the device front end and the checkpoint tools: (a) MfccTorch on the
     card against the numpy MFCC at dither 0 on 3 wavs of odd lengths,
     with TF32 turned on globally and off (rtol 1e-3, atol 2e-2); (b)
     DeviceFeaturizer on the full-width substitute AM over 32
     make_corpus utterances of 2-4.5 s (two chunks of 16, two T buckets)
     against the host path on the card at dither 0 (each frame's error
     over its largest posterior within FEAT_ROW_TOL, rows summing to 1
     within 1e-4), and a control with the MFCC in float32, which must
     fail that bound; (c) eval/featurize_bench.run_bench(32, 4.0): host
     and device utterances per s, the median of 5 passes each; (d) one
     seeded full-width
     WaveGlow (weight norm on) as a state dict, as the reference's
     pickled module (save_reference_waveglow_checkpoint) and in the old
     unfused res / skip format upgraded by train/convert_model.py, each
     through the vocoder CLI (as phase 6, 8 mels): 12 flow kernel
     launches each, the pickled module's wavs bit-equal to the state
     dict's, the old format's within OLD_WAV_TOL int16 steps.
Prints a `card:` line, `stages:`, `profile:`, `timing:`, `cli profile:`,
`cli:`, `synth profile:`, `synth:`, `decode:`, `decode profile:`,
`stream:`, `stream cli:`, `train ppg2mel:`, `train waveglow:`, `device
featurizer:`, `featurize bench:` and `pickled:` lines, a `{"kernels":
...}` line and, last, `{"ok": true, "device": {...}}`.
Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --time-flow CHECKOUT
    python3 chip_smoke.py --time-layer CHECKOUT
    python3 chip_smoke.py --time-f32 CHECKOUT
    python3 chip_smoke.py --train
    python3 chip_smoke.py --tools

run only the flow kernel (at the CLI's shape), only the layer kernel
(bf16 at the fused batch's shape, B=4, T=10000, d=8), or both kernels'
f32 forms (at the synthesis CLI's shape, B=8, T=20000; TF32 off, atol
1e-4) of the port in CHECKOUT (another commit unpacked with `git
archive`): build, hold against the plain versions and time as phase 7
does; print one JSON line.  `--train` runs phase 10 alone, `--tools`
phase 11 (with the flow kernel's build).  Compare two versions on one
card in one call, in turns: old, new, new, old.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
N_WAVS, BATCH, MAX_FRAMES, SEED = 8, 4, 500, 1234
# the vocoder CLI's run: mels, their frame range, its batch
N_MELS, MEL_FRAMES, CLI_BATCH = 16, (449, 512), 8
# the synthesis CLI's batch (--batch_size 8) and its frames per request
# (max_decoder_steps; the gate is held off)
SYNTH_BATCH, SYNTH_FRAMES = 8, 1000
# phase 9: the decode's shape (the synthesis CLI's batch at the longest
# feature bucket of a 4 s request), the chunk lengths swept, the stream
STREAM_WAVS, STREAM_BATCH = 24, 8
DEC_B, DEC_T_IN, DEC_M = 8, 448, 1000
CHUNK_SWEEP = (1, 8, 32, 64)
GATE_SCALE = 1e3
# phase 10: the card-vs-CPU Tacotron2 step's (B, T_in, T_out), the
# WaveGlow segment; the trainers' wavs and iterations
T2_CHECK = (2, 96, 96)
WG_SEGMENT = 10000
T2_TRAIN_WAVS, T2_VAL_WAVS, T2_TRAIN_ITERS = 24, 6, 20
WG_TRAIN_WAVS, WG_TRAIN_ITERS = 18, 24
# phase 11: the device PPGs against the host path's, each frame's max
# |error| over its largest posterior (the full-width substitute AM on 32
# utterances, on an H100: 2.7e-5 with the MFCC in float64, 3.3e-4 in
# float32, the control); the old-format WaveGlow's wavs against the state dict's, in
# int16 steps, where its folded res_skip weights differ by rounding
FEAT_ROW_TOL = 6e-5
OLD_WAV_TOL = 16


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def layer_inputs(g, B, T, C, last, dtype):
    R = C if last else 2 * C

    def mk(shape, s):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    return (mk((B, T, C), 0.3), mk((B, T, 2 * C), 0.3),
            mk((3 * C, 2 * C), 0.05), mk((2 * C,), 0.1),
            mk((C, R), 0.05), mk((R,), 0.1))


def cuda_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clock_during(fn, seconds=1.0):
    """The card's SM clock (MHz) and power draw (W), each the median of
    nvidia-smi's readings while `fn` runs back to back for ~`seconds`."""
    import threading

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout.splitlines()
            try:
                samples.append([float(v) for v in
                                out[torch.cuda.current_device()].split(",")])
            except (ValueError, IndexError):
                pass

    n = max(1, int(seconds * 1e3 / cuda_ms(fn, reps=2, warmup=1)))
    thread = threading.Thread(target=poll)
    thread.start()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    stop.set()
    thread.join()
    if not samples:
        return "not measured", "not measured"
    return tuple(float(np.median([s[k] for s in samples])) for k in (0, 1))


def layer_image(wl, args):
    """The layer's weight image where `wl` runs bf16 at C = 256 on the
    wgmma tile (as pack_wn_layer stores it); a checkout from before that
    tile takes none."""
    x, w_in, w_rs = args[0], args[2], args[4]
    if not hasattr(wl, "layer_images") or x.dtype != torch.bfloat16 \
            or x.shape[2] != wl.KERNEL_C:
        return {}
    img = wl.layer_images([w_in], [w_rs])
    return {"in_img": img["in_img"][0], "rs_img": img["rs_img"][0]}


def compare(wl, args, d, last, tag):
    n0 = wl.launches
    a_k, s_k = wl.wn_layer(*args, dilation=d, last=last,
                           **layer_image(wl, args))
    torch.cuda.synchronize()
    if wl.launches != n0 + 1:
        raise AssertionError("wn_layer did not count its launch")
    a_p, s_p = wl.wn_layer_plain(*args, dilation=d, last=last)
    err = max((s_k.float() - s_p.float()).abs().max().item(),
              (a_k.float() - a_p.float()).abs().max().item())
    tol = TOL[args[0].dtype]
    log(f"wn_layer {tag} d={d} last={last}: max_abs_err {err:.3g} "
        f"(atol {tol})")
    if not err <= tol:
        raise AssertionError(f"WN kernel disagrees: {err} > {tol}")
    return err


def kernel_resources(mod, report, kernel, dtype=torch.bfloat16):
    """A C = 256 kernel's ptxas registers and spills and its dynamic shared
    memory and blocks per SM on this card: the bf16 wgmma kernel, or the
    f32 SIMT kernel (its keys then end in _f32)."""
    regs, spill = ptxas_usage(report, kernel)
    blocks, smem = mod.kernel_resources(dtype)
    log(f"{kernel}: {regs} registers, {spill} bytes spilled (ptxas), {smem} "
        f"bytes of dynamic shared memory, {blocks} block(s) per SM")
    sfx = "_f32" if dtype == torch.float32 else ""
    return {f"registers{sfx}": regs, f"spill_bytes{sfx}": spill,
            f"smem_bytes{sfx}": smem, f"blocks_per_sm{sfx}": blocks}


def check_kernel(wl):
    """The kernel against wn_layer_plain: B=2, T=1000 at a few dilations,
    then every layer of a flow at the shapes the main path gives it (the
    served batch in bf16, the denoiser's bias pass in f32), cond a
    per-layer slice of the stacked (B, T, L*2C) projection as there.
    Returns the largest error of each dtype."""
    g = torch.Generator("cuda").manual_seed(SEED)
    worst = {}
    C = 256
    for dtype in (torch.float32, torch.bfloat16):
        for d, last in ((1, False), (2, False), (8, False), (128, False),
                        (128, True)):
            args = layer_inputs(g, 2, 1000, C, last, dtype)
            err = compare(wl, args, d, last, f"{str(dtype)[6:]} B=2 T=1000")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    T_serve = MAX_FRAMES * 160 // 8
    for dtype, B, T in ((torch.bfloat16, BATCH, T_serve),
                        (torch.float32, 1, 88 * 160 // 8)):
        L = 8
        cond_all = (torch.randn((B, T, L * 2 * C), generator=g,
                                device="cuda") * 0.3).to(dtype)
        for i in range(L):
            last = i == L - 1
            x, _, w_in, b_in, w_rs, b_rs = layer_inputs(g, B, T, C, last,
                                                        dtype)
            cond = cond_all[:, :, 2 * C * i: 2 * C * (i + 1)]
            err = compare(wl, (x, cond, w_in, b_in, w_rs, b_rs), 2 ** i,
                          last, f"{str(dtype)[6:]} B={B} T={T}")
            worst[dtype] = max(worst[dtype], err)
        del cond_all
    return worst


def build_kernels(mods):
    """One nvcc per kernel source, all started together; returns each
    library's ptxas report."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    with ThreadPoolExecutor(len(mods)) as pool:
        reports = list(pool.map(lambda m: m.build(), mods))
    log(f"built {', '.join(m.LIBRARY.name for m in mods)} in "
        f"{time.time() - t0:.2f} s")
    for m, report in zip(mods, reports):
        log(f"{m.LIBRARY.name}:")
        for name, regs, spill in ptxas_entries(report):
            log(f"  {name}: {regs} registers, {spill} bytes spilled")
        for line in report.splitlines():
            if "Performance" in line:
                log(f"  {line.strip()}")
    return reports


def ptxas_entries(report):
    """(mangled name, registers, spill store bytes) of every entry
    function in a ptxas -v report."""
    lines = report.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            spill = regs = None
            for nxt in lines[i + 1:i + 4]:
                if "spill stores" in nxt:
                    spill = int(nxt.split("bytes spill stores")[0]
                                .split(",")[-1])
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split("registers")[0])
            found.append((name, regs, spill))
    return found


def ptxas_usage(report, kernel):
    """(registers, spill store bytes) of `kernel` in a ptxas -v report;
    the most of each over its instantiations."""
    found = [(r, s) for name, r, s in ptxas_entries(report) if kernel in name]
    if not found:
        raise AssertionError(f"no ptxas entry for {kernel}")
    return max(r for r, _ in found), max(s for _, s in found)


def flow_inputs(wf, g, B, T, n_half, dtype, C=256, L=8):
    """A random flow pack (ops/wn_flow.pack_wn_flow's layout, the last
    layer's residual columns zero, the bf16 kernel's weight image where
    `wf` has one), audio (B, n_half, T) and cond (B, T, L*2C) on the
    card."""
    f32 = torch.float32

    def mk(shape, s, dt=dtype):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dt)

    packed = {"w_start": mk((n_half, C), 0.3), "b_start": mk((C,), 0.1, f32),
              "w_in": mk((L, 3 * C, 2 * C), 0.05),
              "b_in": mk((L, 2 * C), 0.1, f32),
              "w_rs": mk((L, C, 2 * C), 0.05),
              "b_rs": mk((L, 2 * C), 0.1, f32),
              "w_end": mk((C, 2 * n_half), 0.05),
              "b_end": mk((2 * n_half,), 0.1, f32)}
    packed["w_rs"][L - 1, :, :C] = 0
    packed["b_rs"][L - 1, :C] = 0
    # as pack_wn_flow does (a checkout from before the image has none)
    if dtype == torch.bfloat16 and hasattr(wf, "weight_image"):
        packed.update(wf.weight_image(packed))
    return packed, mk((B, n_half, T), 1.0), mk((B, T, L * 2 * C), 0.3)


def compare_flow(wf, packed, audio, cond, tag):
    """The flow kernel against wn_flow_plain: f32 within 1e-4; bf16 within
    3e-2 x max(1, max|plain|), ~4 bf16 ulps of the largest output, as the
    two round differently through 8 layers."""
    n0 = wf.launches
    got = wf.wn_flow(packed, audio, cond)
    torch.cuda.synchronize()
    if wf.launches != n0 + 1:
        raise AssertionError("wn_flow did not count its launch")
    want = wf.wn_flow_plain(packed, audio, cond).float()
    err = (got.float() - want).abs().max().item()
    dt = audio.dtype
    tol = TOL[dt] * (max(1.0, want.abs().max().item())
                     if dt == torch.bfloat16 else 1.0)
    log(f"wn_flow {tag}: max_abs_err {err:.3g} (bound {tol:.3g}, "
        f"max|plain| {want.abs().max().item():.3g})")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"flow kernel disagrees: {err} > {tol}")
    return err


def check_gemm1_tile(wf, g, dtype=torch.bfloat16):
    """One tile's GEMM 1 of a C = 256 flow kernel alone against
    torch.matmul (TF32 off) on the same data, at the first tile (d=1) and
    a tail tile past T (d=128): the bf16 wgmma tile (ring, image,
    swizzles, descriptors; atol 1e-3) or the f32 SIMT tile (ring,
    ownership; atol 1e-4); the two differ only in summation order."""
    T, C = 1000, 256
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    x = (torch.randn((T, C), generator=g, device="cuda") * 0.3).to(dtype)
    w_in = (torch.randn((3 * C, 2 * C), generator=g, device="cuda")
            * 0.05).to(dtype)
    w = w_in if dtype == torch.float32 else wf.weight_image(
        {"w_in": w_in[None], "w_rs": w_in.new_zeros((1, C, 2 * C))}
    )["w_in_img"][0]
    worst = 0.0
    for t0, d in ((0, 1), (960, 128)):
        got = wf.gemm1_tile(x, w, t0, d)
        torch.cuda.synchronize()
        rows = torch.arange(t0, t0 + 64, device="cuda")
        taps = []
        for j in range(3):
            t = rows + (j - 1) * d
            ok = (t >= 0) & (t < T)
            taps.append(torch.where(ok[:, None],
                                    x[t.clamp(0, T - 1)].float(), 0.0))
        err = (got - torch.matmul(torch.cat(taps, 1), w_in.float())
               ).abs().max().item()
        log(f"wn_flow {str(dtype)[6:]} GEMM 1 tile t0={t0} d={d}: "
            f"max_abs_err {err:.3g} (atol {tol})")
        if not err <= tol:
            raise AssertionError(f"GEMM 1 tile disagrees: {err}")
        worst = max(worst, err)
    return worst


def check_flow_kernel(wf, report):
    """The bf16 and f32 flow kernels' resources; their GEMM 1 tiles; the
    flow kernel
    against wn_flow_plain at n_half 4, 3, 2 (B=2, T=1000) in both dtypes,
    bf16 at a ragged T=97, then at the CLI's shape (bf16 B=8, T=10240).
    Returns the largest error of each dtype and the resources."""
    res = kernel_resources(wf, report, "wn_flow_bf16_kernel")
    res.update(kernel_resources(wf, report, "wn_flow_f32_kernel",
                                torch.float32))
    g = torch.Generator("cuda").manual_seed(SEED + 4)
    res["gemm1_tile_max_abs_err"] = check_gemm1_tile(wf, g)
    res["gemm1_tile_max_abs_err_f32"] = check_gemm1_tile(wf, g,
                                                         torch.float32)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_half in (4, 3, 2):
            args = flow_inputs(wf, g, 2, 1000, n_half, dtype)
            err = compare_flow(wf, *args,
                               f"{str(dtype)[6:]} B=2 T=1000 n_half={n_half}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    args = flow_inputs(wf, g, 2, 97, 3, torch.bfloat16)
    worst[torch.bfloat16] = max(worst[torch.bfloat16], compare_flow(
        wf, *args, "bfloat16 B=2 T=97 n_half=3"))
    T = MEL_FRAMES[1] * 160 // 8
    args = flow_inputs(wf, g, CLI_BATCH, T, 4, torch.bfloat16)
    err = compare_flow(wf, *args, f"bfloat16 B={CLI_BATCH} T={T} n_half=4")
    worst[torch.bfloat16] = max(worst[torch.bfloat16], err)
    return worst, res


def check_waveglow(wg_cfg, wg_params):
    from fac_via_ppg_torch.models.waveglow import remove_weightnorm, \
        waveglow_infer

    g = torch.Generator("cuda").manual_seed(SEED + 1)
    mel = torch.randn((1, wg_cfg.n_mel_channels, 40), generator=g,
                      device="cuda") - 4.0
    params = remove_weightnorm(wg_params)
    conv = waveglow_infer(wg_cfg, params, mel, 0.6,
                          torch.Generator("cuda").manual_seed(7),
                          wn_impl="conv")
    for impl in ("layer", "flow"):
        out = waveglow_infer(wg_cfg, params, mel, 0.6,
                             torch.Generator("cuda").manual_seed(7),
                             wn_impl=impl)
        err = (out - conv).abs().max().item()
        log(f"waveglow {impl} vs conv, f32: max_abs_err {err:.3g} "
            f"(atol 1e-4)")
        if not (torch.isfinite(out).all() and err <= 1e-4):
            raise AssertionError(f"WaveGlow on the {impl} kernel disagrees: "
                                 f"{err}")


def write_wavs(dirname, n=N_WAVS, seed=SEED):
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        n = int(16000 * rng.uniform(2.0, 4.0))
        t = np.arange(n) / 16000.0
        f0 = rng.uniform(90, 220) * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))
        phase = 2 * np.pi * np.cumsum(f0) / 16000.0
        x = sum(np.sin(h * phase) / h for h in range(1, 6))
        x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t) ** 2)
        x = 6000 * x + 200 * rng.randn(n)
        path = f"{dirname}/req{i}.wav"
        wavfile.write(path, 16000, x.astype(np.int16))
        paths.append(path)
    return paths


def serving_models():
    """Phase 5's and 9's models at the full default configs: a seeded
    Tacotron2 with its gate held off and a seeded WaveGlow in its serving
    form."""
    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        WaveGlowConfig,
    )
    from fac_via_ppg_torch.models import init_tacotron2, init_waveglow
    from fac_via_ppg_torch.models.waveglow import remove_weightnorm

    g = torch.Generator().manual_seed(SEED)
    t2_cfg, wg_cfg = Tacotron2Config(), WaveGlowConfig()
    t2_params, t2_state = init_tacotron2(t2_cfg, g)
    # the gate never fires: every request decodes max_frames, the most
    # work the path can be given
    t2_params["decoder"]["gate_layer"]["bias"].fill_(-10.0)
    wg_params = init_waveglow(wg_cfg, g)
    # the end convs are zero at init; small weights let the kernel's
    # output reach the audio
    for wn in wg_params["wn"]:
        w = wn["end"]["weight"]
        wn["end"]["weight"] = torch.randn(w.shape, generator=g) * 1e-2
    # the serving form, with the f32 1x1 inverses computed once
    return t2_cfg, t2_params, t2_state, wg_cfg, remove_weightnorm(wg_params)


def build_synth():
    from fac_via_ppg_torch.eval.fused import FusedSynthesizer

    t2_cfg, t2_params, t2_state, wg_cfg, wg_params = serving_models()
    t0 = time.time()
    synth = FusedSynthesizer(t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
                             serving_dtype=torch.bfloat16,
                             max_frames=MAX_FRAMES, device="cuda")
    torch.cuda.synchronize()
    log(f"FusedSynthesizer built in {time.time() - t0:.2f} s")
    return synth, wg_cfg, wg_params


def serve(synth, wl, paths):
    hop = synth.wg_cfg.hop_length
    launches, feat_s, dev_s, audio_s = [], [], [], 0.0
    wall0 = time.time()
    for b in range(0, len(paths), BATCH):
        t0 = time.time()
        pairs = [synth.featurize(p) for p in paths[b:b + BATCH]]
        t1 = time.time()
        wl.launches = 0
        handle = synth.launch_feature_pairs(
            pairs, torch.Generator("cuda").manual_seed(SEED + b))
        pcms = synth.collect_feature_pairs(handle)
        t2 = time.time()
        n = wl.launches
        launches.append(n)
        feat_s.append(t1 - t0)
        dev_s.append(t2 - t1)
        mel_lens = handle[1].cpu().tolist()
        for pcm, m in zip(pcms, mel_lens):
            if pcm.dtype != np.int16 or len(pcm) != m * hop:
                raise AssertionError(f"bad PCM: {pcm.dtype} {len(pcm)} "
                                     f"vs mel_len {m} * {hop}")
            if not np.isfinite(pcm.astype(np.float64)).all() \
                    or pcm.std() == 0:
                raise AssertionError("PCM is constant or not finite")
            audio_s += len(pcm) / 16000.0
        log(f"batch {b // BATCH}: mel_lens {mel_lens}, WN kernel launches "
            f"{n}, featurize {t1 - t0:.3f} s, device {t2 - t1:.3f} s")
        if n < 96:
            raise AssertionError(f"only {n} WN kernel launches in a batch")
    wall = time.time() - wall0
    return launches, feat_s, dev_s, audio_s, wall


def stage_times(synth, paths, repeats=3):
    """One batch, stage by stage, each stage closed by a synchronize;
    each stage's seconds for every repeat."""
    from fac_via_ppg_torch.eval.fused import SILENCE
    from fac_via_ppg_torch.models.tacotron2 import \
        tacotron2_inference_batched
    from fac_via_ppg_torch.models.waveglow import (
        pack_waveglow_flow,
        waveglow_infer,
    )

    flow_pack = pack_waveglow_flow(synth.wg_cfg, synth.wg_params)
    pairs = [synth.featurize(p) for p in paths[:BATCH]]
    t_max = max(f.shape[0] for f, _ in pairs)
    feats = torch.as_tensor(np.stack([
        np.concatenate([f, np.repeat(f[-1:], t_max - len(f), 0)])
        for f, _ in pairs]), device="cuda")
    n_frames = torch.tensor([t for _, t in pairs], device="cuda")
    out = {}

    def note(key, value):
        out.setdefault(key, []).append(value)

    for _ in range(repeats):
        g = torch.Generator("cuda").manual_seed(SEED)
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.time()
            ppg = synth.nnet.forward(feats)
            torch.cuda.synchronize()
            note("am_s", time.time() - t)
            t = time.time()
            _, mel, _, _, lens = tacotron2_inference_batched(
                synth.t2_cfg, synth.t2_params, synth.t2_state,
                ppg.transpose(1, 2).float(), n_frames, g)
            torch.cuda.synchronize()
            note("decode_s", time.time() - t)
            note("decode_steps", int(lens.max()))
            produced = (torch.arange(MAX_FRAMES, device="cuda")[None, None]
                        < lens[:, None, None])
            mel = torch.where(produced, mel, mel.new_full((), SILENCE))
            mel = mel.to(torch.bfloat16)
            t = time.time()
            audio = waveglow_infer(synth.wg_cfg, synth.wg_params, mel,
                                   synth.sigma, g,
                                   packed_wn=synth._packed_wn).float()
            torch.cuda.synchronize()
            note("waveglow_s", time.time() - t)
            if not torch.isfinite(audio).all():
                raise AssertionError("WaveGlow audio is not finite")
            t = time.time()
            waveglow_infer(synth.wg_cfg, synth.wg_params, mel, synth.sigma,
                           g, wn_impl="flow", packed_wn=flow_pack)
            torch.cuda.synchronize()
            note("waveglow_flow_s", time.time() - t)
            t = time.time()
            waveglow_infer(synth.wg_cfg, synth.wg_params, mel, synth.sigma,
                           g, wn_impl="conv")
            torch.cuda.synchronize()
            note("waveglow_conv_s", time.time() - t)
            t = time.time()
            spec, ang = synth._stft.transform(audio)
            spec = torch.clamp(spec - synth._bias * synth.strength, min=0.0)
            synth._stft.inverse(spec, ang)
            torch.cuda.synchronize()
            note("denoise_s", time.time() - t)
    return out


def profile_run(fn):
    """`fn` under torch.profiler: the device's busy share of the wall time
    (the union of its kernels' intervals) and the kernels that take the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t

    # device kernels only: key_averages() would count each kernel again
    # under the aten op that launched it
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us, reach = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    per_name = {}
    for e in kernels:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    busy_s = busy_us / 1e6
    return {"wall_s_profiled": wall,
            "device_kernels": len(kernels),
            "device_busy_s": busy_s if kernels else "not measured",
            "busy_share": busy_s / wall if kernels else "not measured",
            "top": [[k[:70], us / 1e3, n] for k, (us, n) in top]}


def profile_batch(synth, paths):
    """One batch of the fused served path under the profiler."""
    pairs = [synth.featurize(p) for p in paths[:BATCH]]
    gen = torch.Generator("cuda").manual_seed(SEED)
    return profile_run(lambda: synth.collect_feature_pairs(
        synth.launch_feature_pairs(pairs, gen)))


def profile_cli_batch(cfg, ckpt, paths):
    """The vocoder CLI's device work for one batch (8 x 512 frames, bf16,
    flow kernel, denoiser) under the profiler, after one warm-up."""
    from fac_via_ppg_torch.models.denoiser import Denoiser
    from fac_via_ppg_torch.models.waveglow import (
        cast_params,
        pack_waveglow_flow,
        waveglow_infer,
    )
    from fac_via_ppg_torch.scripts.waveglow_inference import (
        bucket_mels,
        load_mel,
    )
    from fac_via_ppg_torch.utils.inference import load_waveglow_model
    from fac_via_ppg_torch.weights import move

    params = move(load_waveglow_model(ckpt, cfg), torch.device("cuda"))
    den = Denoiser(cfg, params)
    serve = cast_params(params, torch.bfloat16)
    pack = pack_waveglow_flow(cfg, serve)
    mels = bucket_mels([(p, load_mel(p)) for p in paths[:CLI_BATCH]], 64)
    mel = torch.as_tensor(np.stack([m for _, m, _ in mels]),
                          device="cuda").to(torch.bfloat16)
    gen = torch.Generator("cuda").manual_seed(SEED)

    def batch():
        with torch.no_grad():
            audio = waveglow_infer(cfg, serve, mel, 0.6, gen,
                                   wn_impl="flow", packed_wn=pack).float()
            den(audio, strength=0.005)

    batch()
    return profile_run(batch)


def time_kernel(wl):
    """The kernel and its plain version at the serving shape: one batch of
    4 at max_frames, B x T = 4 x (500 * 160 / 8), C = 256, bf16, d = 8;
    and the f32 kernel at the denoiser's bias pass."""
    C, B, T = 256, BATCH, MAX_FRAMES * 160 // 8
    g = torch.Generator("cuda").manual_seed(SEED + 2)
    dt = torch.bfloat16
    args = layer_inputs(g, B, T, C, False, dt)
    img = layer_image(wl, args)
    n0 = wl.launches
    ms = cuda_ms(lambda: wl.wn_layer(*args, dilation=8, **img))
    wl.launches = n0
    plain_ms = cuda_ms(lambda: wl.wn_layer_plain(*args, dilation=8))
    flops, nbytes, bound, by = layer_bound(B, T, dt)
    log(f"wn_layer bf16 B={B} T={T} C={C}: {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, bound {bound:.4f} ms ({flops} FLOP, {nbytes} B,"
        f" {flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.2f} % of "
        f"bound)")
    # the denoiser's one-off f32 pass: B=1, 88 frames
    a32 = layer_inputs(g, 1, 88 * 160 // 8, C, False, torch.float32)
    ms32 = cuda_ms(lambda: wl.wn_layer(*a32, dilation=8))
    wl.launches = n0
    log(f"wn_layer f32 B=1 T=1760 C={C} (denoiser bias pass): {ms32:.4f} ms")
    return ms, plain_ms, bound, by, ms32


def layer_bound(B, T, dtype, C=256):
    """The least time of one (non-last) layer: FLOP 2*B*T*(3C*2C + C*2C);
    bytes: x, cond, both outputs once and the weights and biases once, in
    the layer pack's dtype."""
    esz = 2 if dtype == torch.bfloat16 else 4
    flops = 2 * B * T * (3 * C * 2 * C + C * 2 * C)
    nbytes = (B * T * (C + 2 * C + C + C) + 3 * C * 2 * C + 2 * C
              + C * 2 * C + 2 * C) * esz
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, \
        nbytes / PEAK_BYTES * 1e3
    return flops, nbytes, max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def time_f32_at_synth(wl, wf):
    """Both kernels' f32 forms at the synthesis CLI's shape, B=8 x
    T=20000 (8 requests x 1000 frames; the layer kernel at d=8, the flow
    kernel at n_half=4): held against their plain versions (atol 1e-4,
    TF32 off), then timed beside the plain versions, with the f32 bound."""
    g = torch.Generator("cuda").manual_seed(SEED + 8)
    B, T, C, f32 = SYNTH_BATCH, SYNTH_FRAMES * 160 // 8, 256, torch.float32
    n_l, n_f = wl.launches, wf.launches
    args = layer_inputs(g, B, T, C, False, f32)
    out = {"wn_layer": {"max_abs_err_f32_synth": compare(
        wl, args, 8, False, f"float32 B={B} T={T}")}}
    ms = cuda_ms(lambda: wl.wn_layer(*args, dilation=8), reps=10)
    plain_ms = cuda_ms(lambda: wl.wn_layer_plain(*args, dilation=8), reps=5)
    out["wn_layer"].update(zip(
        ("ms_f32_synth", "plain_ms_f32_synth", "bound_ms_f32",
         "bound_by_f32", "sm_mhz_f32", "power_w_f32"),
        (ms, plain_ms, *layer_bound(B, T, f32)[2:],
         *clock_during(lambda: wl.wn_layer(*args, dilation=8)))))
    del args
    fargs = flow_inputs(wf, g, B, T, 4, f32)
    out["wn_flow"] = {"max_abs_err_f32_synth": compare_flow(
        wf, *fargs, f"float32 B={B} T={T} n_half=4")}
    fms = cuda_ms(lambda: wf.wn_flow(*fargs), reps=5)
    fplain = cuda_ms(lambda: wf.wn_flow_plain(*fargs), reps=3)
    out["wn_flow"].update(zip(
        ("ms_f32_synth", "plain_ms_f32_synth", "bound_ms_f32",
         "bound_by_f32", "sm_mhz_f32", "power_w_f32"),
        (fms, fplain, *flow_bound(B, T, 4, f32)[2:],
         *clock_during(lambda: wf.wn_flow(*fargs)))))
    del fargs
    wl.launches, wf.launches = n_l, n_f
    for name, t in out.items():
        log(f"{name} f32 B={B} T={T} (synthesis CLI): "
            f"{t['ms_f32_synth']:.4f} ms, plain "
            f"{t['plain_ms_f32_synth']:.4f} ms, f32 bound "
            f"{t['bound_ms_f32']:.4f} ms ({t['bound_by_f32']}, "
            f"{100 * t['bound_ms_f32'] / t['ms_f32_synth']:.2f} % of bound; "
            f"SM clock {t['sm_mhz_f32']} MHz, {t['power_w_f32']} W while it "
            f"runs)")
    return out


def waveglow_params(seed):
    """A seeded full-width WaveGlow (folded), its end convs randomised."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models import init_waveglow

    cfg = WaveGlowConfig()
    g = torch.Generator().manual_seed(seed)
    params = init_waveglow(cfg, g)
    # the end convs are zero at init; small weights let the kernel's
    # output reach the audio
    for wn in params["wn"]:
        w = wn["end"]["weight"]
        wn["end"]["weight"] = torch.randn(w.shape, generator=g) * 1e-2
    return cfg, params


def write_waveglow_pt(path, seed):
    """A seeded full-width WaveGlow written as a .pt state dict by the
    port's exporter, its end convs randomised."""
    from fac_via_ppg_torch.train.export_torch import \
        export_waveglow_state_dict

    cfg, params = waveglow_params(seed)
    torch.save(export_waveglow_state_dict(params, cfg), path)
    return cfg


def write_mels(tmp, n_mel_channels, n=N_MELS):
    """`n` seeded mel .npy files of MEL_FRAMES frames; their paths and
    frame counts."""
    rng = np.random.RandomState(SEED)
    frames = rng.randint(MEL_FRAMES[0], MEL_FRAMES[1] + 1, size=n)
    paths = []
    for i, n in enumerate(frames):
        paths.append(f"{tmp}/mel{i}.npy")
        np.save(paths[-1], (rng.randn(n_mel_channels, n) * 0.5
                            - 5).astype(np.float32))
    return paths, [int(n) for n in frames]


def write_cli_inputs(tmp):
    """A seeded full-width WaveGlow .pt state dict, and N_MELS seeded mel
    .npy files."""
    ckpt = f"{tmp}/waveglow.pt"
    cfg = write_waveglow_pt(ckpt, SEED + 3)
    paths, frames = write_mels(tmp, cfg.n_mel_channels)
    return cfg, ckpt, paths, frames


def check_wavs(out_dir, paths, frames, hop):
    from scipy.io import wavfile

    for path, n in zip(paths, frames):
        sr, wav = wavfile.read(f"{out_dir}/{path.rsplit('/', 1)[1]}"
                               "_synthesis.wav")
        if sr != 16000 or wav.dtype != np.int16 or len(wav) != n * hop:
            raise AssertionError(f"bad wav for {path}: {sr} Hz {wav.dtype} "
                                 f"{len(wav)} vs {n} * {hop}")
        if wav.std() == 0:
            raise AssertionError(f"constant wav for {path}")


def run_cli(wf, tmp):
    """The batched vocoder CLI in-process, as a user runs it: -b 8
    --mel_bucket 64 -s 0.6 -d 0.005, bf16, --wn_impl flow; then
    --cond_impl auto over the first 8 mels."""
    from fac_via_ppg_torch.scripts import waveglow_inference as cli

    cfg, ckpt, paths, frames = write_cli_inputs(tmp)
    lists = {}
    for name, n in (("all", N_MELS), ("first8", 8)):
        lists[name] = f"{tmp}/{name}.txt"
        with open(lists[name], "w") as fh:
            fh.write("\n".join(paths[:n]) + "\n")
    kw = dict(batch_size=CLI_BATCH, compute_dtype="bfloat16",
              wn_impl="flow", mel_bucket=64)
    wf.launches = 0
    summary = cli.main(lists["all"], ckpt, f"{tmp}/out", 0.6, 0.005, **kw)
    n = wf.launches
    check_wavs(f"{tmp}/out", paths, frames, cfg.hop_length)
    per_batch = [b["launches"] for b in summary["batches"]]
    log(f"cli: {len(per_batch)} batches, flow kernel launches {per_batch} "
        f"(total {n}), vocoder s per batch "
        f"{[b['vocoder_s'] for b in summary['batches']]}, "
        f"{summary['audio_s']:.2f} audio s in {summary['wall_s']:.3f} s")
    if per_batch != [cfg.n_flows] * len(per_batch) or \
            n != cfg.n_flows * len(per_batch):
        raise AssertionError(f"expected {cfg.n_flows} flow kernel launches "
                             f"per batch, got {per_batch} (total {n})")
    auto = cli.main(lists["first8"], ckpt, f"{tmp}/out8", 0.6, 0.005,
                    cond_impl="auto", **kw)
    check_wavs(f"{tmp}/out8", paths[:8], frames[:8], cfg.hop_length)
    log(f"cli --cond_impl auto: served {auto['cond_impl']!r}, gate's "
        f"worst-utterance SNR {auto['gate_snr_db']} dB")
    log("cli profile: " + json.dumps(profile_cli_batch(cfg, ckpt, paths)))
    return summary, n, auto, check_int_mm(cfg, ckpt)


def check_int_mm(cfg, ckpt):
    """torch._int_mm (the int8 cond projection on CUDA) against the exact
    int32 CPU product, bit for bit: the CLI batch's codes (B=8 x 512
    frames) against flow 0's int8 weights, every 160th row checked."""
    from fac_via_ppg_torch.models.waveglow import (
        _int8_matmul,
        pack_waveglow_int8cond,
        quantize_per_column_int8,
    )
    from fac_via_ppg_torch.utils.inference import load_waveglow_model

    pk = pack_waveglow_int8cond(cfg, load_waveglow_model(ckpt, cfg))[0]
    g = torch.Generator("cuda").manual_seed(SEED + 5)
    G = MEL_FRAMES[1] * cfg.hop_length // cfg.n_group
    spect = torch.randn((CLI_BATCH, cfg.n_mel_channels * cfg.n_group, G),
                        generator=g, device="cuda")
    sq, _ = quantize_per_column_int8(spect)
    rows = sq.transpose(1, 2).reshape(CLI_BATCH * G, -1)
    wq = pk["wq"].T.to("cuda")
    got = _int8_matmul(rows, wq)
    torch.cuda.synchronize()
    idx = torch.arange(0, rows.shape[0], 160, device="cuda")
    want = torch.matmul(rows[idx].cpu().int(), wq.cpu().int())
    same = torch.equal(got[idx].cpu(), want)
    log(f"torch._int_mm ({rows.shape[0]} x {rows.shape[1]}) @ "
        f"({wq.shape[0]} x {wq.shape[1]}) -> {got.dtype}: {len(idx)} rows "
        f"{'bit-equal to' if same else 'DIFFER from'} the CPU int32 product")
    if got.dtype != torch.int32 or not same:
        raise AssertionError("torch._int_mm disagrees with the exact product")
    return len(idx)


def write_t2_pt(path, seed):
    """A seeded Tacotron2 at the hparams' defaults in the reference's .pt
    format, gate bias -10 (every request decodes all max_decoder_steps)."""
    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        create_hparams_stage,
    )
    from fac_via_ppg_torch.models import init_tacotron2
    from fac_via_ppg_torch.train.export_torch import \
        save_reference_tacotron2_checkpoint

    cfg = Tacotron2Config.from_hparams(create_hparams_stage())
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(seed))
    params["decoder"]["gate_layer"]["bias"].fill_(-10.0)
    save_reference_tacotron2_checkpoint(path, params, state, cfg)


def write_synth_inputs(tmp):
    """Phase 8's inputs: the full-width substitute bundle, its AM also in
    Kaldi's binary format; a seeded full-width Tacotron2 as the
    reference's .pt, gate bias -10 (every request decodes all
    max_decoder_steps); a seeded WaveGlow .pt; 8 seeded wavs."""
    from fac_via_ppg_torch.frontend.nnet3 import load_nnet3
    from fac_via_ppg_torch.frontend.nnet3_binary import write_nnet3_binary
    from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle

    t0 = time.time()
    make_bundle(f"{tmp}/bundle")
    write_nnet3_binary(load_nnet3(f"{tmp}/bundle/am/final.raw.txt"),
                       f"{tmp}/bundle/am/final.raw")
    write_t2_pt(f"{tmp}/tacotron2.pt", SEED + 7)
    write_waveglow_pt(f"{tmp}/waveglow.pt", SEED + 9)
    Path(f"{tmp}/wavs").mkdir()
    wavs = write_wavs(f"{tmp}/wavs")
    log(f"synthesis inputs written in {time.time() - t0:.2f} s")
    return f"{tmp}/tacotron2.pt", f"{tmp}/waveglow.pt", wavs


def check_binary_am(tmp, wav):
    """The binary AM against the text AM it was written from: the same
    arrays, and equal PPGs on the card for one wav.  Returns the
    dependencies on the binary AM."""
    from fac_via_ppg_torch.frontend import ppg as ppg_mod

    feats = {k: f"{tmp}/bundle/feats/{v}" for k, v in (
        ("lda_path", "final.mat"), ("reduce_dim_path", "reduce_dim.mat"),
        ("splice_opts_path", "splice_opts"))}
    text = ppg_mod.DependenciesPPG(
        nnet_path=f"{tmp}/bundle/am/final.raw.txt", **feats)
    binary = ppg_mod.DependenciesPPG(
        nnet_path=f"{tmp}/bundle/am/final.raw", **feats)
    n_arrays = 0
    for name, comp in text.nnet.components.items():
        other = binary.nnet.components[name].attrs
        for key, val in comp.attrs.items():
            if isinstance(val, np.ndarray):
                n_arrays += 1
                if not np.array_equal(other[key], val):
                    raise AssertionError(f"binary AM differs at {name}.{key}")
    a = ppg_mod.get_ppg(wav, text, device="cuda")
    b = ppg_mod.get_ppg(wav, binary, device="cuda")
    if a.shape[1] != 5816 or not np.isfinite(a).all() \
            or not np.array_equal(a, b):
        raise AssertionError("binary and text AMs give different PPGs")
    log(f"binary AM: {n_arrays} arrays equal to the text AM's; PPGs "
        f"{a.shape} on the card equal")
    return binary


def check_synth_wavs(paths, hop):
    from scipy.io import wavfile

    for path in paths:
        sr, wav = wavfile.read(path)
        if sr != 16000 or wav.dtype != np.int16 \
                or len(wav) != SYNTH_FRAMES * hop:
            raise AssertionError(f"bad wav {path}: {sr} Hz {wav.dtype} "
                                 f"{len(wav)} vs {SYNTH_FRAMES} * {hop}")
        if wav.std() == 0:
            raise AssertionError(f"constant wav {path}")


def run_synthesis(wl, wf, tmp):
    """The synthesis CLI in-process, as a user runs it, on the binary AM
    (supplied in place of the default bundle, as the CLI's tests do):
    runs (a)-(e).  Every kernel count is set to 0 just before each run and
    read just after."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.scripts import generate_synthesis as gs

    wg_cfg = WaveGlowConfig()
    n_layers = wg_cfg.n_flows * wg_cfg.wn_n_layers    # 96
    t2_pt, wg_pt, wavs = write_synth_inputs(tmp)
    deps = check_binary_am(tmp, wavs[0])
    base = ["--ppg2mel_model", t2_pt, "--waveglow_model", wg_pt]
    wav_dir = str(Path(wavs[0]).parent)
    runs = {"a_staged": [wavs[0]], "b_fused": [wavs[0], "--fused"],
            "c_batch": [wav_dir, "--batch_size", str(SYNTH_BATCH)],
            "d_int8": [wav_dir, "--batch_size", str(SYNTH_BATCH),
                       "--cond_impl", "int8"],
            "e_auto": [wav_dir, "--batch_size", str(SYNTH_BATCH),
                       "--cond_impl", "auto"]}
    default_deps = gs.ppg_mod.DependenciesPPG
    gs.ppg_mod.DependenciesPPG = lambda: deps
    out = {}
    try:
        for name, extra in runs.items():
            wl.launches = wf.launches = 0
            t0 = time.time()
            summary = gs.main(base + ["--output_dir", f"{tmp}/{name}",
                                      "--teacher_utterance_path"] + extra)
            torch.cuda.synchronize()
            wall = time.time() - t0
            res = {"wall_s": wall, "wavs": len(summary["outputs"]),
                   "cond_impl": summary["cond_impl"],
                   "wn_layer_launches": wl.launches,
                   "wn_flow_launches": wf.launches,
                   "batches": summary["batches"]}
            want = 1 if name[0] in "ab" else len(wavs)
            if res["wavs"] != want:
                raise AssertionError(f"{name}: {res['wavs']} wavs, not "
                                     f"{want}")
            # every route decodes all 1000 steps; the staged route's
            # denoiser keeps the length too
            check_synth_wavs(summary["outputs"], 160)
            for b in summary["batches"]:
                if summary["cond_impl"] == "int8":
                    ok = (b["wn_flow_launches"] == wg_cfg.n_flows
                          and b["wn_layer_launches"] == 0)
                else:
                    ok = b["wn_layer_launches"] >= n_layers
                if not ok:
                    raise AssertionError(f"{name}: kernel launches {b}")
            if name == "e_auto":
                res["calibration_snr_db"] = summary["calibration_snr_db"]
                if res["calibration_snr_db"] is None:
                    raise AssertionError("auto printed no decision")
            if name == "c_batch":
                res["audio_s_per_wall_s"] = summary["audio_s"] / wall
            log(f"synth {name}: {json.dumps(res)}")
            out[name] = res
        prof = profile_synth_batch(t2_pt, wg_pt, deps, wavs)
    finally:
        gs.ppg_mod.DependenciesPPG = default_deps
    return out, prof


def profile_synth_batch(t2_pt, wg_pt, deps, wavs):
    """One batch of run (c) under the profiler: FusedSynthesizer as the
    CLI builds it (f32 WaveGlow, max_frames 1000), after one warm-up."""
    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        WaveGlowConfig,
        create_hparams_stage,
    )
    from fac_via_ppg_torch.eval.fused import FusedSynthesizer
    from fac_via_ppg_torch.utils.inference import (
        load_tacotron2_model,
        load_waveglow_model,
    )

    cfg, wg_cfg = Tacotron2Config.from_hparams(create_hparams_stage()), \
        WaveGlowConfig()
    synth = FusedSynthesizer(
        cfg, *load_tacotron2_model(t2_pt, cfg), wg_cfg,
        load_waveglow_model(wg_pt, wg_cfg), deps=deps, serving_dtype=None,
        max_frames=cfg.max_decoder_steps, device="cuda")
    pairs = [synth.featurize(p) for p in wavs[:SYNTH_BATCH]]
    gen = torch.Generator("cuda").manual_seed(SEED)

    def batch():
        synth.collect_feature_pairs(synth.launch_feature_pairs(pairs, gen))

    batch()
    return profile_run(batch)


def flow_bound(B, T, n_half, dtype, C=256, L=8):
    """The least time of one net: FLOP per time row 2*(n_half*C + L*3C*2C
    + (L-1)*C*2C + C*C + C*2*n_half); bytes: audio, cond and output once,
    the weights once, biases in f32."""
    esz = 2 if dtype == torch.bfloat16 else 4
    flops = 2 * B * T * (n_half * C + L * 6 * C * C + (L - 1) * 2 * C * C
                         + C * C + 2 * C * n_half)
    nbytes = (esz * (B * T * (n_half + L * 2 * C + 2 * n_half)
                     + n_half * C + L * 6 * C * C + L * 2 * C * C
                     + 2 * C * n_half)
              + 4 * (C + 4 * L * C + 2 * n_half))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, \
        nbytes / PEAK_BYTES * 1e3
    return flops, nbytes, max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def time_flow_kernel(wf):
    """The flow kernel and its plain version at the CLI's shape: one batch
    of 8 x 512 frames, B x T = 8 x 10240, C=256, L=8, n_half=4, bf16; and
    the kernel in f32 (--compute_dtype float32)."""
    g = torch.Generator("cuda").manual_seed(SEED + 6)
    B, T = CLI_BATCH, MEL_FRAMES[1] * 160 // 8
    n0 = wf.launches
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = flow_inputs(wf, g, B, T, 4, dtype)
        ms = cuda_ms(lambda: wf.wn_flow(*args), reps=10)
        plain_ms = cuda_ms(lambda: wf.wn_flow_plain(*args), reps=5)
        flops, nbytes, bound, by = flow_bound(B, T, 4, dtype)
        log(f"wn_flow {str(dtype)[6:]} B={B} T={T} C=256 L=8 n_half=4: "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by}; {flops} FLOP, {nbytes} B, {flops / ms / 1e9:.1f} "
            f"TFLOP/s, {100 * bound / ms:.2f} % of bound)")
        out[dtype] = (ms, plain_ms, bound, by)
        del args
    wf.launches = n0
    return out


def time_flow_at(root):
    """`--time-flow`: the flow kernel of the port in checkout `root` alone,
    checked and timed at the CLI's shape; one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from fac_via_ppg_torch.ops import wn_flow as wf

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_kernels((wf,))
    g = torch.Generator("cuda").manual_seed(SEED + 6)
    B, T = CLI_BATCH, MEL_FRAMES[1] * 160 // 8
    err = compare_flow(wf, *flow_inputs(wf, g, B, T, 4, torch.bfloat16),
                       f"bfloat16 B={B} T={T} n_half=4")
    t = time_flow_kernel(wf)
    log(json.dumps({"module": wf.__file__, "card": card,
                    "ms": t[torch.bfloat16][0],
                    "plain_ms": t[torch.bfloat16][1],
                    "ms_f32": t[torch.float32][0], "max_abs_err": err}))
    return 0


def time_layer_at(root):
    """`--time-layer`: the layer kernel of the port in checkout `root`
    alone, checked and timed at the fused batch's shape (bf16 B=4,
    T=10000, d=8); one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from fac_via_ppg_torch.ops import wn_layer as wl

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_kernels((wl,))
    g = torch.Generator("cuda").manual_seed(SEED + 2)
    B, T = BATCH, MAX_FRAMES * 160 // 8
    err = compare(wl, layer_inputs(g, B, T, 256, False, torch.bfloat16), 8,
                  False, f"bfloat16 B={B} T={T}")
    ms, plain_ms, bound, _, ms32 = time_kernel(wl)
    log(json.dumps({"module": wl.__file__, "card": card, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "ms_f32": ms32, "max_abs_err": err}))
    return 0


def time_f32_at(root):
    """`--time-f32`: both kernels' f32 forms of the port in checkout
    `root`, checked against their plain versions and timed at the
    synthesis CLI's shape (B=8, T=20000); one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from fac_via_ppg_torch.ops import wn_flow as wf
    from fac_via_ppg_torch.ops import wn_layer as wl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build_kernels((wl, wf))
    log(json.dumps({"root": str(root), "card": card,
                    **time_f32_at_synth(wl, wf)}))
    return 0


# ---------------------------------------------------------------- phase 9

def stop_gate(logits, M, k, margin=1e-6):
    """A gate setting at which the sequences stop at different steps.

    `logits` (B, M): the gate's bias-free outputs z over all M steps with
    the stop held off.  The decode's state never reads the gate, so a
    gate of weight s*w and bias -s*th stops a sequence after the first
    step at which s*z > th, the rest of the decode unchanged.  Over s in
    {+1, -1} and thresholds between observed values, take the one with
    the most distinct lengths, then the most that stop, then the most
    that stop inside a chunk of k, keeping every produced s*z at least
    `margin` from the threshold (random weights give |z| ~ 1e-3).
    Returns (s, th, lengths)."""
    best, B = None, logits.shape[0]
    for sign in (1.0, -1.0):
        u = sign * logits
        vals = np.unique(u)
        cands = (vals[1:] + vals[:-1]) / 2
        for th in cands[::max(1, len(cands) // 2000)]:
            fired = u > th
            first = np.where(fired.any(1), fired.argmax(1) + 1, M)
            near = min(np.abs(u[i, :first[i]] - th).min() for i in range(B))
            if near < margin:
                continue
            score = (len(set(first.tolist())), int((first < M).sum()),
                     int((first % k != 0).sum()),
                     -abs(float(np.median(first)) - M / 2))
            if best is None or score > best[0]:
                best = (score, sign, float(th), first.tolist())
    if best is None:
        raise AssertionError("no gate setting stops the sequences apart")
    return best[1:]


def decode_inputs(B, T_in, M, seed):
    """Full-width Tacotron2 (seeded, gate held off), a seeded PPG batch of
    B x T_in (true lengths spread down to T_in / 2), and one set of
    prenet masks drawn up front, all on the card."""
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.models import init_tacotron2
    from fac_via_ppg_torch.models import tacotron2 as tt
    from fac_via_ppg_torch.weights import move

    cfg = Tacotron2Config(max_decoder_steps=M)
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(seed))
    params["decoder"]["gate_layer"]["bias"].fill_(-10.0)
    dev = torch.device("cuda")
    params, state = move(params, dev), move(state, dev)
    g = torch.Generator("cuda").manual_seed(seed)
    ppg = torch.softmax(torch.randn((B, cfg.n_symbols, T_in), generator=g,
                                    device=dev) * 3, dim=1)
    lengths = torch.linspace(T_in, T_in // 2, B, device=dev).long()
    return cfg, params, state, ppg, lengths


def hold_decodes(tt, cfg, params, state, ppg, lengths, seed, single):
    """The public entry (CUDA graphs) against the eager chunk loop, the
    plain version, on the same masks: lengths / end step exact, mel, gate
    and alignments within 1e-5.  Returns (lengths or t_end, max error,
    the eager decode's gate logits)."""
    with torch.no_grad():
        g = torch.Generator("cuda").manual_seed(seed)
        memory, processed = tt._encode(cfg, params, state, ppg, lengths, g,
                                       None)
        masks = tt.decoder_prenet_masks(cfg, 2, ppg.shape[0], "cuda", g)
        mel, gate, align, lens, t_end = tt.decode(
            cfg, params["decoder"], memory, processed, lengths, masks,
            single, graph=False)
        g = torch.Generator("cuda").manual_seed(seed)
        if single:
            out = tt.tacotron2_inference(cfg, params, state, ppg, g, lengths)
        else:
            out = tt.tacotron2_inference_batched(cfg, params, state, ppg,
                                                 lengths, g)
        torch.cuda.synchronize()
    err = max((out[0] - mel.permute(1, 2, 0)).abs().max().item(),
              (out[2] - gate.T).abs().max().item(),
              (out[3] - align.permute(1, 0, 2)).abs().max().item())
    got = [out[4]] if single else out[4].tolist()
    want = [int(t_end)] if single else lens.tolist()
    if got != want or not err <= 1e-5:
        raise AssertionError(f"graph decode disagrees with eager: lengths "
                             f"{got} vs {want}, max_abs_err {err}")
    return want, err, gate.T.cpu().numpy()


def check_decode_graphs():
    """Phase 9 (a): the graph decode against the eager chunk loop at
    B=8, T_in=448, M=1000, gate held off and at a gate setting that stops
    the sequences at different steps; then B=1 the same way."""
    from fac_via_ppg_torch.models import decode_graph
    from fac_via_ppg_torch.models import tacotron2 as tt

    out = {}
    for name, B, single in (("batched", DEC_B, False), ("single", 1, True)):
        cfg, params, state, ppg, lengths = decode_inputs(
            B, DEC_T_IN, DEC_M, SEED + 11)
        gate = params["decoder"]["gate_layer"]
        replays = decode_graph.replays
        held, err_off, logits = hold_decodes(tt, cfg, params, state, ppg,
                                             lengths, SEED + 12, single)
        if held != [DEC_M] * B or decode_graph.replays == replays:
            raise AssertionError(f"{name}: held-off decode gave {held}, "
                                 f"{decode_graph.replays - replays} replays")
        sign, th, expect = stop_gate(logits + 10.0, DEC_M, tt.DECODE_CHUNK)
        # in place (the captured graph reads the same addresses), scaled
        # by GATE_SCALE so that every logit is >= 1e-3 from the threshold
        gate["weight"].mul_(sign * GATE_SCALE)
        gate["bias"].fill_(-th * GATE_SCALE)
        stops, err_stop, _ = hold_decodes(tt, cfg, params, state, ppg,
                                          lengths, SEED + 12, single)
        if stops != expect:
            raise AssertionError(f"{name}: stops {stops}, predicted {expect}")
        out[name] = {"held_off_lengths": held, "stop_lengths": stops,
                     "gate_weight_scale": sign * GATE_SCALE,
                     "gate_bias": -th * GATE_SCALE,
                     "max_abs_err": max(err_off, err_stop)}
        log(f"decode graph vs eager, {name} B={B} T_in={DEC_T_IN} "
            f"M={DEC_M}: held off {held[:2]}..., stopped at {stops} "
            f"(gate weight x {sign * GATE_SCALE:+.0f}, bias "
            f"{-th * GATE_SCALE:.5f}); max_abs_err "
            f"{out[name]['max_abs_err']:.3g} (atol 1e-5)")
    return out


def time_decode(profile=True):
    """Phase 9 (b): the B=8, T_in=448, M=1000 decode (gate held off, all
    1000 steps), the eager chunk loop against graph replay, in turns
    (eager, graph, graph, eager) for each k of CHUNK_SWEEP, each graph
    captured before it is timed; then one graph decode at DECODE_CHUNK
    under the profiler.  Seconds per 1000 steps."""
    from fac_via_ppg_torch.models import decode_graph
    from fac_via_ppg_torch.models import tacotron2 as tt

    cfg, params, state, ppg, lengths = decode_inputs(
        DEC_B, DEC_T_IN, DEC_M, SEED + 11)
    with torch.no_grad():
        g = torch.Generator("cuda").manual_seed(SEED + 12)
        memory, processed = tt._encode(cfg, params, state, ppg, lengths, g,
                                       None)
        masks = tt.decoder_prenet_masks(cfg, 2, DEC_B, "cuda", g)

    def run(k, graph):
        torch.cuda.synchronize()
        t = time.time()
        tt.decode(cfg, params["decoder"], memory, processed, lengths, masks,
                  False, k=k, graph=graph)
        torch.cuda.synchronize()
        return (time.time() - t) * 1000 / DEC_M

    sweep = {}
    for k in CHUNK_SWEEP:
        n0 = decode_graph.captures
        t = time.time()
        run(k, True)
        capture_s = time.time() - t
        if decode_graph.captures != n0 + 1:
            raise AssertionError(f"k={k}: no graph captured")
        turns = [run(k, False), run(k, True), run(k, True), run(k, False)]
        sweep[k] = {"eager_s": [turns[0], turns[3]],
                    "graph_s": [turns[1], turns[2]],
                    "first_call_s": capture_s}
        log(f"decode k={k}: eager {turns[0]:.4f} / {turns[3]:.4f} s, graph "
            f"{turns[1]:.4f} / {turns[2]:.4f} s per 1000 steps (first call, "
            f"with the capture, {capture_s:.3f} s)")
    prof = {}
    if profile:
        prof = profile_run(lambda: run(tt.DECODE_CHUNK, True))
        prof_eager = profile_run(lambda: run(tt.DECODE_CHUNK, False))
        prof = {"graph": prof, "eager": prof_eager}
    return sweep, prof, decode_graph.count()


def run_streaming(wl, wf, tmp):
    """Phase 9 (c): StreamingAccentConverter at full width (fused, batch
    8, 2 front-end threads, pipeline depth 2, bf16 WaveGlow, max_frames
    500, after prewarm) over 24 seeded wavs; the same at depth 1 (PCM bit
    for bit); cond_impl="int8"; the staged route over 2 wavs; the native
    MFCC built, used and held against numpy."""
    import dataclasses
    import threading

    from fac_via_ppg_torch import native
    from fac_via_ppg_torch.eval.streaming import StreamingAccentConverter
    from fac_via_ppg_torch.frontend import feat as feat_mod
    from fac_via_ppg_torch.frontend import mfcc as mfcc_mod

    t2_cfg, t2_params, t2_state, wg_cfg, wg_params = serving_models()
    t2_cfg = dataclasses.replace(t2_cfg, max_decoder_steps=MAX_FRAMES)
    paths = write_wavs(tmp, n=STREAM_WAVS, seed=SEED + 13)
    hop = wg_cfg.hop_length

    def converter(**kw):
        conv = StreamingAccentConverter(
            t2_cfg, t2_params, t2_state, wg_cfg, wg_params,
            serving_dtype=torch.bfloat16, device="cuda", **kw)
        stages = {"featurize_s": 0.0, "launch_s": 0.0, "collect_s": 0.0,
                  "launches": []}
        if conv.fused is None:
            return conv, stages
        f = conv.fused
        featurize, launch, collect = (f.featurize, f.launch_feature_pairs,
                                      f.collect_feature_pairs)
        lock = threading.Lock()

        def timed_featurize(path):
            t = time.time()
            out = featurize(path)
            with lock:
                stages["featurize_s"] += time.time() - t
            return out

        def timed_launch(*a, **k):
            n = (wl.launches, wf.launches)
            t = time.time()
            handle = launch(*a, **k)
            stages["launch_s"] += time.time() - t
            stages["launches"].append([wl.launches - n[0],
                                       wf.launches - n[1]])
            return handle

        def timed_collect(handle):
            t = time.time()
            out = collect(handle)
            stages["collect_s"] += time.time() - t
            return out

        f.featurize, f.launch_feature_pairs, f.collect_feature_pairs = (
            timed_featurize, timed_launch, timed_collect)
        return conv, stages

    def serve(conv, seed):
        t0 = time.time()
        results = list(conv.run(paths, torch.Generator("cuda").manual_seed(
            seed)))
        wall = time.time() - t0
        if sorted(r.wav_path for r in results) != sorted(paths):
            raise AssertionError("the stream lost or repeated utterances")
        for r in results:
            pcm = np.round(r.audio * 32767)
            if r.error is not None or not np.isfinite(pcm).all() \
                    or pcm.std() == 0 or len(pcm) != MAX_FRAMES * hop:
                raise AssertionError(f"bad stream result {r.wav_path}: "
                                     f"{len(pcm)} samples, {r.error}")
        return results, wall

    out = {}
    native.calls = 0
    conv, stages = converter(fused=True, batch_size=STREAM_BATCH,
                             frontend_threads=2, pipeline_depth=2)
    t = time.time()
    conv.prewarm()
    torch.cuda.synchronize()
    out["prewarm_s"] = time.time() - t
    stages.update(featurize_s=0.0, launch_s=0.0, collect_s=0.0, launches=[])
    wl.launches = wf.launches = 0
    results, wall = serve(conv, SEED + 14)
    out["wn_layer_launches"], out["wn_flow_launches"] = \
        wl.launches, wf.launches
    launches = stages.pop("launches")
    if len(launches) != STREAM_WAVS // STREAM_BATCH or any(
            n_l < 96 or n_f for n_l, n_f in launches):
        raise AssertionError(f"dense stream launches per batch {launches}")
    if native.calls < STREAM_WAVS:
        raise AssertionError(f"native MFCC served {native.calls} calls")
    first = {r.wav_path for r in results[:STREAM_BATCH]}
    steady = [r for r in results if r.wav_path not in first]
    lat = [r.latency_seconds for r in steady]
    out.update({
        "wall_s": wall, "stages": stages, "launches_per_batch": launches,
        "audio_s": sum(r.audio_seconds for r in results),
        "audio_s_per_wall_s": sum(r.audio_seconds for r in results) / wall,
        "steady_audio_s_per_attributed_s":
            sum(r.audio_seconds for r in steady)
            / sum(r.wall_seconds for r in steady),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "native_mfcc_calls": native.calls})

    # depth 1 against depth 2 on one front-end thread: with two, the
    # batches' make-up follows featurization order, which varies
    piped = {}
    for depth in (2, 1):
        c, _ = converter(fused=True, batch_size=STREAM_BATCH,
                         frontend_threads=1, pipeline_depth=depth)
        piped[depth], out[f"depth{depth}_one_thread_wall_s"] = serve(
            c, SEED + 14)
    if [r.wav_path for r in piped[1]] != [r.wav_path for r in piped[2]] \
            or any(not np.array_equal(a.audio, b.audio)
                   for a, b in zip(piped[1], piped[2])):
        raise AssertionError("pipeline depth 1 and 2 serve different PCM")
    del c, piped

    int8_conv, int8_stages = converter(
        fused=True, batch_size=STREAM_BATCH, frontend_threads=2,
        pipeline_depth=2, cond_impl="int8")
    wl.launches = wf.launches = 0
    _, out["int8_wall_s"] = serve(int8_conv, SEED + 15)
    out["int8_wn_flow_launches"] = wf.launches
    launches = int8_stages["launches"]
    if any(n_l or n_f != wg_cfg.n_flows for n_l, n_f in launches):
        raise AssertionError(f"int8 stream launches per batch {launches}")
    out["int8_launches_per_batch"] = launches
    del int8_conv

    staged, _ = converter(fused=False)
    t = time.time()
    staged_res = list(staged.run(paths[:2], torch.Generator(
        "cuda").manual_seed(SEED + 16)))
    out["staged_wall_s"] = time.time() - t
    for r in staged_res:
        if r.error is not None or not np.isfinite(r.audio).all() \
                or r.audio.std() == 0 or len(r.audio) % hop:
            raise AssertionError(f"bad staged result {r.wav_path}")
    out["staged_samples"] = [len(r.audio) for r in staged_res]
    del staged

    fs, wav = feat_mod.read_wav(paths[0])
    opts = mfcc_mod.MfccOptions(frame_opts=mfcc_mod.FrameExtractionOptions(
        snip_edges=False, allow_downsample=True, dither=0.0),
        use_energy=False)
    a = mfcc_mod.compute_mfcc(wav, fs, opts, backend="native")
    b = mfcc_mod.compute_mfcc(wav, fs, opts, backend="numpy")
    out["native_vs_numpy_max_abs_err"] = float(np.abs(a - b).max())
    if not native.LIBRARY.exists() or not \
            out["native_vs_numpy_max_abs_err"] <= 1e-3:
        raise AssertionError(f"native MFCC: {out}")
    log(f"native MFCC: {native.LIBRARY} built and served "
        f"{out['native_mfcc_calls']} calls; against numpy at dither 0 "
        f"max_abs_err {out['native_vs_numpy_max_abs_err']:.3g} (atol 1e-3)")
    return out


def run_streaming_cli(tmp):
    """Phase 9 (d): the streaming CLI in-process on a generated .pt pair
    (the hparams' defaults: f32 WaveGlow, 1000 frames, gate held off),
    --fused --batch_size 8 over 8 wavs; every wav checked."""
    from scipy.io import wavfile

    from fac_via_ppg_torch.eval import streaming

    t2_pt, wg_pt = f"{tmp}/tacotron2.pt", f"{tmp}/waveglow.pt"
    write_t2_pt(t2_pt, SEED + 7)
    write_waveglow_pt(wg_pt, SEED + 9)
    wavs = write_wavs(tmp, seed=SEED + 17)
    with open(f"{tmp}/wavs.txt", "w") as fh:
        fh.write("\n".join(wavs) + "\n")
    t0 = time.time()
    streaming.main(["--ppg2mel_model", t2_pt, "--waveglow_model", wg_pt,
                    "--filelist", f"{tmp}/wavs.txt", "--output_dir",
                    f"{tmp}/out", "--fused", "--batch_size", "8",
                    "--frontend_threads", "2"])
    wall = time.time() - t0
    for w in wavs:
        sr, pcm = wavfile.read(f"{tmp}/out/" + Path(w).name.replace(
            ".wav", "_ac.wav"))
        if sr != 16000 or pcm.dtype != np.int16 \
                or len(pcm) != SYNTH_FRAMES * 160 or pcm.std() == 0:
            raise AssertionError(f"bad streaming CLI wav for {w}")
    return {"wall_s": wall, "wavs": len(wavs)}


# ---------------------------------------------------------------- phase 10

def t2_masks(cfg, B, T_in, T_out, seed):
    """Every dropout keep-mask of one Tacotron2 training forward, in the
    order `tacotron2_forward(masks=...)` takes them, as numpy bool arrays
    (each device converts its own)."""
    rng = np.random.RandomState(seed)
    E, P, pe = (cfg.encoder_embedding_dim, cfg.prenet_dim,
                cfg.postnet_embedding_dim)
    shapes = [(B, T_in, cfg.symbols_embedding_dim)] * 2 \
        + [(B, E, T_in)] * cfg.encoder_n_convolutions \
        + [(B, T_out, P)] * 2
    step = [(B, cfg.attention_rnn_dim, cfg.p_attention_dropout)] * 2 \
        + [(B, cfg.decoder_rnn_dim, cfg.p_decoder_dropout)] * 2
    masks = [rng.rand(*s) < 0.5 for s in shapes]
    for _ in range(T_out):
        masks += [rng.rand(b, d) < 1.0 - p for b, d, p in step if p > 0]
    post = [(B, pe, T_out)] * (cfg.postnet_n_convolutions - 1) \
        + [(B, cfg.n_acoustic_feat_dims, T_out)]
    return masks + [rng.rand(*s) < 0.5 for s in post]


def t2_train_batch(cfg, B, T_in, T_out, seed):
    rng = np.random.RandomState(seed)
    in_len = np.linspace(T_in, T_in * 0.6, B).astype(np.int64)
    out_len = np.linspace(T_out, T_out * 0.6, B).astype(np.int64)
    ppg = rng.rand(B, cfg.n_symbols, T_in).astype(np.float32)
    ppg *= (np.arange(T_in)[None, None] < in_len[:, None, None])
    mel = (rng.randn(B, cfg.n_acoustic_feat_dims, T_out) * 0.5 - 4).astype(
        np.float32)
    mel *= (np.arange(T_out)[None, None] < out_len[:, None, None])
    gate = (np.arange(T_out)[None] >= (out_len - 1)[:, None]).astype(
        np.float32)
    return ppg, in_len, mel, gate, out_len


STEP_WD, STEP_CLIP = 1e-6, 1.0  # the hparams' weight decay and clip


class relu_inputs:
    """Records every torch.relu input of the enclosed forward (a CPU
    copy each, in call order): which side of the kink each element took."""

    def __enter__(self):
        self.inputs, self._relu = [], torch.relu

        def relu(x):
            self.inputs.append(x.detach().to("cpu", copy=True))
            return self._relu(x)

        torch.relu = relu
        return self.inputs

    def __exit__(self, *exc):
        torch.relu = self._relu
        return False


def one_step(make_step, cfg, params, batch, device, lr, state=None,
             masks=None, dtype=torch.float32):
    """One train step of a fresh Adam on `device`, params, state and batch
    in `dtype`: (loss, the gradients fed to the optimizer, the params
    after it, the params before it, the relu inputs), all on the CPU."""
    from fac_via_ppg_torch.train.optim import Optimizer
    from fac_via_ppg_torch.utils.tree import tree_leaves, tree_map

    class Capture(Optimizer):
        def apply(self, opt_state, grads):
            # copies: the optimizer clips the gradients in place
            self.grads = [g.detach().to("cpu", copy=True) for g in grads]
            return super().apply(opt_state, grads)

    def put(x):
        x = torch.as_tensor(x)
        # a copy: the optimizer updates the params in place
        return x.to(device, dtype if x.is_floating_point() else x.dtype,
                    copy=True)

    opt = Capture(lr, STEP_WD, STEP_CLIP)
    params = tree_map(put, params)
    before = [x.cpu() for x in tree_leaves(params)]
    batch = tuple(put(x) for x in batch)
    step = make_step(cfg, opt)
    with relu_inputs() as pre:
        if state is None:
            out = step(params, opt.init(params), batch)
        else:
            out = step(params, tree_map(put, state), opt.init(params),
                       batch, masks=masks)
    return (float(out.loss), opt.grads,
            [x.detach().cpu() for x in tree_leaves(out.params)], before,
            pre)


def hold_step_against_cpu(name, run, paths, lr, noise=()):
    """A train step on the card against the same step on the CPU: the
    loss to 1e-5 relative; each gradient leaf to 1e-4 of its norm (a leaf
    under a path in `noise`, a conv bias that a training batch norm
    follows, whose gradient is zero but for rounding: to 1e-4 of the
    whole gradient's norm); the params after the step to 1e-5 wherever
    the sign of the gradient Adam takes (g_eff = clip * g + wd * p) is
    determined (|g_eff| above 10x its card-vs-CPU difference and above
    100 eps), elsewhere to 2 lr, since Adam's first update is lr *
    g_eff / (|g_eff| + eps), +-lr for any |g_eff| >> eps.

    The gradient of a relu network is piecewise: where a relu input lies
    within the two devices' rounding of zero, they differentiate
    different pieces and a leaf upstream may differ by far more than
    rounding.  The check counts the relu inputs whose sign differs
    between the devices; the per-leaf gradient bound holds where there is
    none (the f64 step is the one that holds it then)."""
    t0 = time.time()
    card = run("cuda")
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    cpu = run("cpu")
    t_cpu = time.time() - t0
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])

    def norm(grads):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))

    total = norm(cpu[1])
    clip = [min(1.0, STEP_CLIP / (norm(r[1]) + 1e-6)) for r in (card, cpu)]
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(card[4], cpu[4]))
    rels = []
    p_det, p_und, n_und, n_all = 0.0, 0.0, 0, 0
    for path, ga, gb, a, b, p0 in zip(paths, card[1], cpu[1], card[2],
                                      cpu[2], cpu[3]):
        is_noise = any(path.startswith(p) and path.endswith("conv/bias")
                       for p in noise)
        denom = total if is_noise else max(float(gb.norm()), 1e-30)
        rels.append((float((ga - gb).norm()) / denom, path))
        ea, eb = clip[0] * ga + STEP_WD * p0, clip[1] * gb + STEP_WD * p0
        det = (eb.abs() > 10 * (ea - eb).abs()) & (eb.abs() > 1e-6)
        err = (a - b).abs().double()
        p_det = max(p_det, float(err[det].max()) if det.any() else 0.0)
        if (~det).any():
            p_und = max(p_und, float(err[~det].max()))
        n_und += int((~det).sum())
        n_all += det.numel()
    rels.sort(reverse=True)
    grad_rel = rels[0][0]
    res = {"dtype": str(cpu[3][0].dtype), "loss_card": card[0],
           "loss_cpu": cpu[0], "loss_rel": loss_rel,
           "grad_rel_max": grad_rel, "grad_rel_worst": rels[:3],
           "relu_sign_flips": flips, "grad_norm_cpu": total,
           "param_max_abs_err": p_det,
           "param_max_abs_err_sign_undetermined": p_und,
           "sign_undetermined_share": n_und / n_all,
           "card_s": t_card, "cpu_s": t_cpu}
    log(f"train step {name}, card vs CPU: {json.dumps(res)}")
    if not (np.isfinite(card[0]) and loss_rel <= 1e-5
            and (grad_rel <= 1e-4 or flips > 0)
            and p_det <= 1e-5 and p_und <= 2 * lr * (1 + 1e-3)):
        raise AssertionError(f"{name} train step on the card disagrees "
                             f"with the CPU: {res}")
    return res


def tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def check_train_steps():
    """Phase 10 (a): one Tacotron2 and one WaveGlow train step at full
    width (TF32 off), card against CPU, from the same seeded params,
    batch and injected masks.  Tacotron2 in f64, where its per-leaf
    gradient bound always holds, and in f32, the dtype training runs;
    WaveGlow, which has no relu, in f32."""
    from fac_via_ppg_torch.configs.hparams import (
        Tacotron2Config,
        WaveGlowConfig,
    )
    from fac_via_ppg_torch.models import init_tacotron2, init_waveglow
    from fac_via_ppg_torch.models.waveglow import weight_norm_params
    from fac_via_ppg_torch.train.step import (
        make_tacotron2_train_step,
        make_waveglow_train_step,
    )

    lr = 1e-4
    cfg = Tacotron2Config()
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(SEED))
    B, T_in, T_out = T2_CHECK
    batch = t2_train_batch(cfg, B, T_in, T_out, SEED + 21)
    masks = t2_masks(cfg, B, T_in, T_out, SEED + 22)
    wg_cfg = WaveGlowConfig()
    g = torch.Generator().manual_seed(SEED + 23)
    wg = init_waveglow(wg_cfg, g)
    for wn in wg["wn"]:  # the end convs are zero at init
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 1e-2
    wg = weight_norm_params(wg)
    rng = np.random.RandomState(SEED + 24)
    frames = WG_SEGMENT // wg_cfg.hop_length + 1  # the STFT's count
    wg_batch = ((rng.randn(1, wg_cfg.n_mel_channels, frames) - 4).astype(
        np.float32), (rng.randn(1, WG_SEGMENT) * 0.1).astype(np.float32))
    out = {}
    for dtype in (torch.float64, torch.float32):
        key = str(dtype).split(".")[1]
        out[f"tacotron2_{key}"] = hold_step_against_cpu(
            f"tacotron2 {key}", lambda dev: one_step(
                make_tacotron2_train_step, cfg, params, batch, dev, lr,
                state, masks, dtype), tree_paths(params), lr,
            noise=("encoder/convolutions", "postnet/convolutions"))
    if out["tacotron2_float64"]["grad_rel_max"] > 1e-4:
        raise AssertionError("the f64 Tacotron2 gradients disagree")
    # no relu: the f32 step holds every bound itself
    out["waveglow_float32"] = hold_step_against_cpu(
        "waveglow float32", lambda dev: one_step(
            lambda c, o: make_waveglow_train_step(c, o, sigma=0.7071),
            wg_cfg, wg, wg_batch, dev, lr), tree_paths(wg), lr)
    return out


def timed_steps(module, name, frames_of):
    """Wrap `module.name`, a train-step factory, so that each step it
    makes is timed between two synchronizes and its loss and frames
    (`frames_of(batch)`) recorded; the fifth step also runs under the
    profiler.  Returns (the records, the profile, a restore function)."""
    orig = getattr(module, name)
    rec, prof = [], {}

    def factory(*a, **k):
        step = orig(*a, **k)

        def timed(*sa, **sk):
            if len(rec) == 4 and not prof:
                box = []
                prof.update(profile_run(lambda: box.append(step(*sa, **sk))))
                out = box[0]
                rec.append((None, float(out.loss), None))
                return out
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            rec.append((time.perf_counter() - t, float(out.loss),
                        frames_of(sa)))
            return out

        return timed

    setattr(module, name, factory)
    return rec, prof, lambda: setattr(module, name, orig)


def train_summary(card, rec, prof, unit, resumed_first, wall):
    times = [t for t, _, _ in rec if t is not None]
    steady = times[3:] if len(times) > 3 else times
    rates = [f / t for t, _, f in rec if t is not None][3:]
    losses = [loss for _, loss, _ in rec]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    return {"card": card, "iterations": len(rec),
            "s_per_iteration_median": float(np.median(steady)),
            "s_per_iteration_min": float(min(steady)),
            f"{unit}_per_s_median": float(np.median(rates)),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "first_loss": losses[0], "last_loss": losses[-1],
            "resumed_first_iteration": resumed_first, "wall_s": wall,
            "busy_share": prof.get("busy_share"),
            "profiled_step_wall_s": prof.get("wall_s_profiled"),
            "top": prof.get("top", [])[:5]}


def first_iteration(text, pattern):
    import re

    m = re.search(pattern, text)
    return int(m.group(1)) if m else None


def roundtrip(params, opt_state, tmp, model_state=None):
    """The trained state through save_checkpoint / load_checkpoint, bit
    for bit."""
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.utils.tree import tree_leaves

    path = f"{tmp}/roundtrip"
    ckpt.save_checkpoint(path, params, opt_state, 1e-5, 7, model_state)
    back = ckpt.load_checkpoint(path)
    for a, b in zip(tree_leaves((params, model_state)),
                    tree_leaves((back["params"], back.get("model_state")))):
        if a is not None and not torch.equal(a.cpu(), b):
            raise AssertionError("the checkpoint does not round-trip")
    if back["opt_state"]["state"].keys() != \
            opt_state.state_dict()["state"].keys():
        raise AssertionError("the optimizer state does not round-trip")


def run_train_ppg2mel(card, tmp):
    """Phase 10 (b): train_ppg2mel.main in-process at create_hparams()'s
    defaults (full PPG, batch 6, buckets of 128) on the substitute AM,
    24 seeded 2-4 s training wavs and 6 validation wavs: 20 iterations,
    validation and a checkpoint every 10, then auto-resume for 4 more;
    in f32 and bf16."""
    import contextlib
    import io

    from fac_via_ppg_torch.data import ppg_mel_dataset
    from fac_via_ppg_torch.scripts import train_ppg2mel

    wavs = write_wavs(tmp, n=T2_TRAIN_WAVS + T2_VAL_WAVS, seed=SEED + 31)
    Path(f"{tmp}/train.txt").write_text(
        "\n".join(wavs[:T2_TRAIN_WAVS]) + "\n")
    Path(f"{tmp}/val.txt").write_text("\n".join(wavs[T2_TRAIN_WAVS:]) + "\n")
    per_epoch = T2_TRAIN_WAVS // 6
    # the f32 run featurizes with the device front end (the training set
    # once: its first run writes the reference's feature cache, the later
    # ones read it; the validation set each run); the bf16 run with the
    # default preload, the host MFCC and the TDNN on the card
    cache = dict(is_cache_feats=True, feats_cache_path=f"{tmp}/feats.pkl")
    featurized = []
    orig_featurizer = ppg_mel_dataset.DeviceFeaturizer

    def counted_featurizer(*a, **k):
        feat = orig_featurizer(*a, **k)
        if feat.device.type != "cuda":
            raise AssertionError(f"the dataset featurizes on {feat.device}")

        def run(wavs, *ra, **rk):
            featurized.append(len(wavs))
            return feat(wavs, *ra, **rk)

        return run

    out = {}
    for dtype in ("float32", "bfloat16"):
        run_dir = f"{tmp}/t2_{dtype}"
        kw = dict(training_files=f"{tmp}/train.txt",
                  validation_files=f"{tmp}/val.txt",
                  output_directory=run_dir, train_dtype=dtype,
                  iters_per_checkpoint=10,
                  featurize_device=dtype == "float32", **cache)
        featurized.clear()
        ppg_mel_dataset.DeviceFeaturizer = counted_featurizer
        rec, prof, restore = timed_steps(
            train_ppg2mel, "make_tacotron2_train_step",
            lambda sa: int(sa[3][4].sum()))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                params, state, opt_state, it = train_ppg2mel.main(
                    epochs=T2_TRAIN_ITERS // per_epoch, **kw)
                wall = time.time() - t0
                n_first = len(rec)
                kw.update(is_cache_feats=False, load_feats_from_disk=True)
                cache = dict(feats_cache_path=kw["feats_cache_path"],
                             load_feats_from_disk=True)
                print("--- resume ---")
                _, _, _, it2 = train_ppg2mel.main(
                    epochs=10 // per_epoch + 1, checkpoint_path="auto", **kw)
        finally:
            restore()
            ppg_mel_dataset.DeviceFeaturizer = orig_featurizer
        text = buf.getvalue()
        resumed = first_iteration(text.split("--- resume ---")[1],
                                  r"Train loss (\d+) ")
        lines = text.splitlines()
        log(f"ppg2mel {dtype}: {len(lines)} lines of output; "
            + " | ".join(line for line in lines
                         if line.startswith(("Validation", "Loaded"))))
        if it != T2_TRAIN_ITERS or resumed != 11 or \
                it2 != 11 + per_epoch or len(rec) - n_first != per_epoch:
            raise AssertionError(f"ppg2mel {dtype}: iterations {it}, "
                                 f"resumed at {resumed} to {it2}")
        roundtrip(params, opt_state, tmp, state)
        res = train_summary(card, rec[:n_first], prof, "mel_frames",
                            resumed, wall)
        res["resumed_iterations"] = it2 - 11
        res["device_featurized_utterances"] = list(featurized)
        want = [T2_TRAIN_WAVS, T2_VAL_WAVS, T2_VAL_WAVS] \
            if dtype == "float32" else []
        if featurized != want:
            raise AssertionError(f"ppg2mel {dtype}: the device front end "
                                 f"featurized {featurized}, not {want}")
        res["validation_losses"] = [float(line.split()[3]) for line in lines
                                    if line.startswith("Validation loss")]
        log(f"train ppg2mel {dtype}: " + json.dumps(res))
        out[dtype] = res
    return out


def run_train_waveglow(card, tmp):
    """Phase 10 (c): train_waveglow.main in-process at the full
    WaveGlowConfig (12 flows x 8 layers, C = 256), batch 3, segments of
    10000 samples, 18 seeded wavs: 24 iterations, a checkpoint every 10,
    then auto-resume; in f32 and bf16."""
    import contextlib
    import io

    from fac_via_ppg_torch.configs import DEFAULT_WAVEGLOW_CONFIG_PATH
    from fac_via_ppg_torch.scripts import train_waveglow

    wavs = write_wavs(tmp, n=WG_TRAIN_WAVS, seed=SEED + 41)
    Path(f"{tmp}/wg.txt").write_text("\n".join(wavs) + "\n")
    per_epoch = WG_TRAIN_WAVS // 3
    out = {}
    for dtype in ("float32", "bfloat16"):
        config = json.loads(Path(DEFAULT_WAVEGLOW_CONFIG_PATH).read_text())
        config["train_config"].update(
            output_directory=f"{tmp}/wg_{dtype}", train_dtype=dtype,
            iters_per_checkpoint=10, epochs=WG_TRAIN_ITERS // per_epoch)
        config["data_config"].update(training_files=f"{tmp}/wg.txt",
                                     segment_length=WG_SEGMENT)
        cfg_path = f"{tmp}/wg_{dtype}.json"
        Path(cfg_path).write_text(json.dumps(config))
        rec, prof, restore = timed_steps(
            train_waveglow, "make_waveglow_train_step",
            lambda sa: sa[2][1].numel())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                params, opt_state, it = train_waveglow.main(cfg_path)
                wall = time.time() - t0
                n_first = len(rec)
                _, _, it2 = train_waveglow.main(cfg_path,
                                                checkpoint_path="auto")
        finally:
            restore()
        log(f"waveglow {dtype}: {len(buf.getvalue().splitlines())} lines "
            "of output")
        last = (WG_TRAIN_ITERS - 1) // 10 * 10
        if it != WG_TRAIN_ITERS or len(rec) - n_first != it2 - last - 1:
            raise AssertionError(f"waveglow {dtype}: iterations {it}, "
                                 f"resumed to {it2}")
        roundtrip(params, opt_state, tmp)
        res = train_summary(card, rec[:n_first], prof, "samples", last + 1,
                            wall)
        res["resumed_iterations"] = it2 - last - 1
        log(f"train waveglow {dtype}: " + json.dumps(res))
        out[dtype] = res
    return out


def run_training(card):
    """Phase 10: (a) card against CPU, (b) the PPG->mel trainer, (c) the
    vocoder trainer, each in f32 and bf16."""
    t0 = time.time()
    steps = check_train_steps()
    with tempfile.TemporaryDirectory() as tmp:
        t2 = run_train_ppg2mel(card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        wg = run_train_waveglow(card, tmp)
    log("train ppg2mel: " + json.dumps(
        {"card": card, **{k: {f: v[f] for f in (
            "s_per_iteration_median", "mel_frames_per_s_median",
            "max_memory_allocated_gb", "first_loss", "last_loss",
            "busy_share", "top")} for k, v in t2.items()}}))
    log("train waveglow: " + json.dumps(
        {"card": card, **{k: {f: v[f] for f in (
            "s_per_iteration_median", "samples_per_s_median",
            "max_memory_allocated_gb", "first_loss", "last_loss",
            "busy_share", "top")} for k, v in wg.items()}}))
    log(f"phase 10: {time.time() - t0:.1f} s")
    return steps, t2, wg


# ---------------------------------------------------------------- phase 11

def check_mfcc_torch():
    """Phase 11 (a): MfccTorch on the card against the numpy MFCC at
    dither 0 on wavs of odd lengths, with TF32 turned on globally and off
    (rtol 1e-3, atol 2e-2); TF32 is left off, as the script runs."""
    from fac_via_ppg_torch.frontend import mfcc as t_mfcc

    opts = t_mfcc.MfccOptions(frame_opts=t_mfcc.FrameExtractionOptions(
        snip_edges=False, allow_downsample=True, dither=0.0),
        use_energy=False)
    m = t_mfcc.MfccTorch(opts)
    rng = np.random.RandomState(SEED + 51)
    wavs = [rng.randn(n) * 3000 for n in (16001, 40123, 71999)]
    out = {}
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            errs = []
            for w in wavs:
                got = m(w).cpu().numpy()
                want = t_mfcc.compute_mfcc(w, 16000, opts, backend="numpy")
                if got.shape != want.shape:
                    raise AssertionError(f"MfccTorch shape {got.shape} vs "
                                         f"{want.shape}")
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-2)
                errs.append(float(np.abs(got - want).max()))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out["tf32_on" if tf32 else "tf32_off"] = errs
    log(f"MfccTorch on the card against numpy, max |err| per wav "
        f"({[len(w) for w in wavs]} samples): {out}")
    return out


def check_device_featurizer(tmp, deps):
    """Phase 11 (b): DeviceFeaturizer at full width (the substitute AM at
    make_bundle's defaults) over 32 make_corpus utterances (2-4.5 s, in
    length order, so two chunks of 16 in two T buckets) against the host
    path on the card at dither 0: each frame's max |error| over its
    largest posterior within FEAT_ROW_TOL (the posteriors are peaked,
    so an absolute bound reads only a frame's few large ones), rows
    summing to 1 within 1e-4.  The control, the same featurizer with its MFCC in float32,
    must exceed FEAT_ROW_TOL: the bound tells a sound front end from one
    that drifts."""
    from fac_via_ppg_torch.frontend import feat as feat_mod
    from fac_via_ppg_torch.frontend.ppg import (
        DeviceFeaturizer,
        compute_full_ppg_wrapper,
    )
    from fac_via_ppg_torch.scripts.make_corpus import make_corpus

    paths = make_corpus(f"{tmp}/corpus", n_train=32, n_val=0,
                        seed=SEED + 53)["wavs"]
    wavs = [feat_mod.read_wav(p)[1] for p in paths]
    wavs.sort(key=len)
    feat = DeviceFeaturizer(deps, dither=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = feat(wavs, 16000)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    host = [compute_full_ppg_wrapper(w, 16000, deps.nnet, deps.lda, 10,
                                     dither=0.0) for w in wavs]

    def errors(ppgs):
        """(max |error|, max over frames of |error| / largest posterior,
        max |row sum - 1|) against the host path."""
        err = rel = row_err = 0.0
        for d, h in zip(ppgs, host):
            if d.shape != h.shape or d.dtype != np.float32:
                raise AssertionError(f"device PPG {d.shape} {d.dtype} vs "
                                     f"host {h.shape}")
            diff = np.abs(d - h)
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff.max(axis=1) / h.max(axis=1)).max()))
            row_err = max(row_err, float(np.abs(d.sum(axis=1) - 1).max()))
        return err, rel, row_err

    err, rel, row_err = errors(dev)
    control = DeviceFeaturizer(deps, dither=0.0)
    mfcc = control._mfcc  # computes in its constants' dtype
    mfcc.window, mfcc.banks, mfcc.dct = (
        x.float() for x in (mfcc.window, mfcc.banks, mfcc.dct))
    c_err, c_rel, _ = errors(control(wavs, 16000))
    frames = [d.shape[0] for d in dev]
    buckets = sorted({-(-max(frames[lo:lo + 16]) // 128) * 128
                      for lo in range(0, len(frames), 16)})
    out = {"utterances": len(dev), "frames": [min(frames), max(frames)],
           "senones": dev[0].shape[1], "t_buckets": buckets,
           "device_s": dev_s, "max_abs_err": err, "max_row_rel_err": rel,
           "row_sum_err": row_err, "row_rel_tol": FEAT_ROW_TOL,
           "f32_mfcc_max_abs_err": c_err, "f32_mfcc_max_row_rel_err": c_rel}
    log("device featurizer: " + json.dumps(out))
    if rel > FEAT_ROW_TOL or row_err > 1e-4:
        raise AssertionError(f"DeviceFeaturizer disagrees with the host "
                             f"path: {rel} of a frame's largest posterior "
                             f"(rows {row_err})")
    if c_rel <= FEAT_ROW_TOL:
        raise AssertionError(f"the float32-MFCC control passes the bound "
                             f"({c_rel} <= {FEAT_ROW_TOL})")
    return out


def run_pickled_cli(wf, tmp):
    """Phase 11 (d): one seeded full-width WaveGlow, weight norm on,
    written three ways: a state dict (the port's exporter), the
    reference's pickled module (save_reference_waveglow_checkpoint) and
    the old unfused res / skip format (a state dict), upgraded by the
    converter CLI (train/convert_model.py).  The vocoder CLI (as phase 6:
    -b 8 --mel_bucket 64 -s 0.6 -d 0.005, bf16, --wn_impl flow) runs on
    each over 8 mels: 12 flow kernel launches each; the pickled module's
    wavs equal the state dict's bit for bit; the old format's folded
    res_skip weights within 8 ulp of the state dict's (weights.py's fold
    of the split rows against the whole), and its wavs within OLD_WAV_TOL
    int16 steps (equal where the weights are)."""
    from scipy.io import wavfile

    from fac_via_ppg_torch.models.waveglow import weight_norm_params
    from fac_via_ppg_torch.scripts import waveglow_inference as cli
    from fac_via_ppg_torch.train import convert_model
    from fac_via_ppg_torch.train.export_torch import (
        export_waveglow_state_dict,
        save_reference_waveglow_checkpoint,
    )
    from fac_via_ppg_torch.utils.inference import load_waveglow_model
    from fac_via_ppg_torch.utils.tree import tree_leaves

    t0 = time.time()
    cfg, params = waveglow_params(SEED + 57)
    params = weight_norm_params(params)
    sd = export_waveglow_state_dict(params, cfg)
    ckpts = {"state_dict": f"{tmp}/sd.pt", "pickled": f"{tmp}/module.pt",
             "old": f"{tmp}/old_upgraded.pt"}
    torch.save(sd, ckpts["state_dict"])
    save_reference_waveglow_checkpoint(ckpts["pickled"], params, cfg)
    # the old layout: each res_skip conv's rows as res_layers (the first
    # C) and skip_layers (the rest; the last layer has only skip rows),
    # weight norm per output row
    old, C = {k: v for k, v in sd.items() if ".res_skip_layers." not in k}, \
        cfg.wn_n_channels
    for k, wn in enumerate(params["wn"]):
        for i, p in enumerate(wn["res_skip_layers"]):
            parts = ({"res_layers": slice(0, C), "skip_layers": slice(C, None)}
                     if i < cfg.wn_n_layers - 1 else
                     {"skip_layers": slice(None)})
            for part, rows in parts.items():
                pre = f"WN.{k}.{part}.{i}"
                old[f"{pre}.weight_g"] = p["g"][rows].reshape(-1, 1, 1)
                old[f"{pre}.weight_v"] = p["v"][rows]
                old[f"{pre}.bias"] = p["bias"][rows]
    torch.save(old, f"{tmp}/old.pt")
    del sd, old
    convert_model.main([f"{tmp}/old.pt", ckpts["old"]])
    write_s = time.time() - t0
    paths, frames = write_mels(tmp, cfg.n_mel_channels, n=CLI_BATCH)
    with open(f"{tmp}/mels.txt", "w") as fh:
        fh.write("\n".join(paths) + "\n")

    folded = {name: load_waveglow_model(p, cfg) for name, p in ckpts.items()}
    ulp = 0
    for wa, wb in zip(folded["old"]["wn"], folded["state_dict"]["wn"]):
        for pa, pb in zip(wa["res_skip_layers"], wb["res_skip_layers"]):
            a, b = pa["weight"].numpy(), pb["weight"].numpy()
            ulp = max(ulp, float((np.abs(a - b) / np.spacing(
                np.maximum(np.abs(a), np.abs(b)))).max()))
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves(folded[a]), tree_leaves(folded[b])))

    same_weights = same("old", "state_dict")
    pickled_same = same("pickled", "state_dict")
    del folded

    wavs, launches = {}, {}
    for name, ckpt in ckpts.items():
        wf.launches = 0
        cli.main(f"{tmp}/mels.txt", ckpt, f"{tmp}/out_{name}", 0.6, 0.005,
                 batch_size=CLI_BATCH, compute_dtype="bfloat16",
                 wn_impl="flow", mel_bucket=64)
        launches[name] = wf.launches
        check_wavs(f"{tmp}/out_{name}", paths, frames, cfg.hop_length)
        wavs[name] = [wavfile.read(f"{tmp}/out_{name}/"
                                   f"{p.rsplit('/', 1)[1]}_synthesis.wav")[1]
                      for p in paths]
    pickled_diff = max(int(np.abs(a.astype(np.int32) - b).max())
                       for a, b in zip(wavs["pickled"], wavs["state_dict"]))
    old_diff = max(int(np.abs(a.astype(np.int32) - b).max())
                   for a, b in zip(wavs["old"], wavs["state_dict"]))
    out = {"write_s": write_s, "flow_launches": launches,
           "pickled_weights_equal": pickled_same,
           "pickled_wav_max_diff": pickled_diff,
           "old_res_skip_max_ulp": ulp, "old_weights_equal": same_weights,
           "old_wav_max_diff": old_diff, "old_wav_tol": OLD_WAV_TOL}
    log("pickled: " + json.dumps(out))
    if any(n != cfg.n_flows for n in launches.values()):
        raise AssertionError(f"expected {cfg.n_flows} flow kernel launches "
                             f"per run, got {launches}")
    if not pickled_same or pickled_diff != 0:
        raise AssertionError("the pickled module's wavs differ from the "
                             "state dict's")
    if ulp > 8 or old_diff > (0 if same_weights else OLD_WAV_TOL):
        raise AssertionError(f"the old format's weights ({ulp} ulp) or "
                             f"wavs ({old_diff} steps) differ")
    return out


def run_tools(card, wf):
    """Phase 11: (a) MfccTorch, (b) DeviceFeaturizer at full width, (c)
    featurize_bench.run_bench(32, 4.0), (d) the pickled-module WaveGlow
    and the old format through the vocoder CLI."""
    from fac_via_ppg_torch.eval.featurize_bench import run_bench
    from fac_via_ppg_torch.frontend.ppg import DependenciesPPG

    t0 = time.time()
    mfcc = check_mfcc_torch()
    deps = DependenciesPPG()
    with tempfile.TemporaryDirectory() as tmp:
        featurizer = check_device_featurizer(tmp, deps)
    bench = run_bench(32, 4.0, deps=deps)
    if bench["max_abs_err"] > 1e-4:
        raise AssertionError(f"featurize_bench: device and host paths "
                             f"differ by {bench['max_abs_err']}")
    log("featurize bench: " + json.dumps({"card": card, **bench}))
    with tempfile.TemporaryDirectory() as tmp:
        pickled = run_pickled_cli(wf, tmp)
    log(f"phase 11: {time.time() - t0:.1f} s")
    return {"mfcc": mfcc, "featurizer": featurizer, "bench": bench,
            "pickled": pickled}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-flow", metavar="CHECKOUT",
                    help="only check and time the flow kernel of the port "
                    "in CHECKOUT")
    ap.add_argument("--time-layer", metavar="CHECKOUT",
                    help="only check and time the layer kernel of the port "
                    "in CHECKOUT")
    ap.add_argument("--time-f32", metavar="CHECKOUT",
                    help="only check and time both kernels' f32 forms of "
                    "the port in CHECKOUT at the synthesis CLI's shape")
    ap.add_argument("--train", action="store_true",
                    help="only run phase 10, the trainers")
    ap.add_argument("--tools", action="store_true",
                    help="only run phase 11, the device front end and the "
                    "checkpoint tools")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.time_flow:
        return time_flow_at(args.time_flow)
    if args.time_layer:
        return time_layer_at(args.time_layer)
    if args.time_f32:
        return time_f32_at(args.time_f32)
    try:
        from fac_via_ppg_torch.ops import wn_flow as wf
        from fac_via_ppg_torch.ops import wn_layer as wl
        from fac_via_ppg_torch.weights import move
    except ImportError as e:
        print(f"chip_smoke: the port is missing: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    if args.train:
        run_training(card)
        return 0
    if args.tools:
        build_kernels((wf,))
        run_tools(card, wf)
        return 0

    reports = build_kernels((wl, wf))
    layer_res = kernel_resources(wl, reports[0], "wn_layer_bf16_kernel")
    layer_res.update(kernel_resources(wl, reports[0], "wn_layer_f32_kernel",
                                      torch.float32))
    max_err = check_kernel(wl)
    flow_err, flow_res = check_flow_kernel(wf, reports[1])

    wl.launches = 0
    synth, wg_cfg, wg_params = build_synth()
    log(f"denoiser bias pass: {wl.launches} WN kernel launches")
    check_waveglow(wg_cfg, move(wg_params, torch.device("cuda")))

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_wavs(tmp)
        launches, feat_s, dev_s, audio_s, wall = serve(synth, wl, paths)
        stages = stage_times(synth, paths)
        prof = profile_batch(synth, paths)
    log("stages: " + json.dumps(stages))
    log("profile: " + json.dumps(prof))
    ms, plain_ms, bound_ms, bound_by, ms32 = time_kernel(wl)
    log("timing: " + json.dumps({
        "card": card, "batches": len(launches), "batch": BATCH,
        "featurize_s_per_batch": feat_s, "device_s_per_batch": dev_s,
        "audio_s": audio_s, "wall_s": wall,
        "audio_s_per_wall_s": audio_s / wall}))
    del synth

    with tempfile.TemporaryDirectory() as tmp:
        cli, flow_launches, auto, int_mm_rows = run_cli(wf, tmp)
    log("cli: " + json.dumps({
        "card": card, "batch": CLI_BATCH, "mels": N_MELS,
        "vocoder_s_per_batch": [b["vocoder_s"] for b in cli["batches"]],
        "flow_launches_per_batch": [b["launches"] for b in cli["batches"]],
        "audio_s": cli["audio_s"], "wall_s": cli["wall_s"],
        "audio_s_per_wall_s": cli["audio_s"] / cli["wall_s"],
        "auto_cond_impl": auto["cond_impl"],
        "auto_gate_snr_db": auto["gate_snr_db"],
        "int_mm_rows_bit_equal": int_mm_rows}))
    flow_t = time_flow_kernel(wf)
    f_ms, f_plain_ms, f_bound_ms, f_bound_by = flow_t[torch.bfloat16]
    f32_synth = time_f32_at_synth(wl, wf)

    with tempfile.TemporaryDirectory() as tmp:
        synth_runs, synth_prof = run_synthesis(wl, wf, tmp)
    log("synth profile: " + json.dumps(synth_prof))
    c = synth_runs["c_batch"]
    log("synth: " + json.dumps({
        "card": card, "batch": SYNTH_BATCH, "frames": SYNTH_FRAMES,
        "wall_s": {k: r["wall_s"] for k, r in synth_runs.items()},
        "c_audio_s_per_wall_s": c["audio_s_per_wall_s"],
        "c_device_s_per_batch": [b["device_s"] for b in c["batches"]],
        "d_device_s_per_batch": [b["device_s"] for b in
                                 synth_runs["d_int8"]["batches"]],
        "e_cond_impl": synth_runs["e_auto"]["cond_impl"],
        "e_calibration_snr_db": synth_runs["e_auto"]["calibration_snr_db"],
        "launches": {k: [r["wn_layer_launches"], r["wn_flow_launches"]]
                     for k, r in synth_runs.items()}}))
    synth_launches = {
        name: sum(r[f"{name}_launches"] for r in synth_runs.values())
        for name in ("wn_layer", "wn_flow")}

    from fac_via_ppg_torch.models import tacotron2 as tt

    graphs = check_decode_graphs()
    sweep, dec_prof, n_graphs = time_decode()
    log("decode: " + json.dumps({
        "card": card, "B": DEC_B, "T_in": DEC_T_IN, "steps": DEC_M,
        "chunk": tt.DECODE_CHUNK,
        "s_per_1000_steps": {str(k): v for k, v in sweep.items()},
        "busy_share_graph": dec_prof["graph"]["busy_share"],
        "busy_share_eager": dec_prof["eager"]["busy_share"],
        "device_busy_s_graph": dec_prof["graph"]["device_busy_s"],
        "device_kernels_graph": dec_prof["graph"]["device_kernels"],
        "graphs_cached": n_graphs, "parity": graphs}))
    log("decode profile: " + json.dumps(dec_prof))
    with tempfile.TemporaryDirectory() as tmp:
        stream = run_streaming(wl, wf, tmp)
    log("stream: " + json.dumps({"card": card, "wavs": STREAM_WAVS,
                                 "batch": STREAM_BATCH, **stream}))
    with tempfile.TemporaryDirectory() as tmp:
        stream_cli = run_streaming_cli(tmp)
    log("stream cli: " + json.dumps({"card": card, **stream_cli}))
    run_training(card)
    tools = run_tools(card, wf)
    log(json.dumps({"kernels": [{
        "name": "wn_layer", "route": "cuda",
        "source": "fac_via_ppg_torch/csrc/wn_layer.cu",
        "replaces": "fac_via_ppg_tpu/ops/wn_pallas.py:129",
        "launches": int(sum(launches)),
        "max_abs_err": max(max_err.values()),
        "max_abs_err_f32": max_err[torch.float32],
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "ms_f32": ms32,
        **f32_synth["wn_layer"],
        "launches_synth": synth_launches["wn_layer"],
        "launches_stream": stream["wn_layer_launches"],
        **layer_res, "library_ms": None}, {
        "name": "wn_flow", "route": "cuda",
        "source": "fac_via_ppg_torch/csrc/wn_flow.cu",
        "replaces": "fac_via_ppg_tpu/ops/wn_flow_pallas.py:245",
        "launches": int(flow_launches),
        "max_abs_err": max(flow_err.values()),
        "max_abs_err_f32": flow_err[torch.float32],
        "max_abs_err_bf16": flow_err[torch.bfloat16],
        "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": f_bound_ms,
        "bound_by": f_bound_by, "ms_f32": flow_t[torch.float32][0],
        **f32_synth["wn_flow"],
        "launches_synth": synth_launches["wn_flow"],
        "launches_stream_int8": stream["int8_wn_flow_launches"],
        "launches_pickled_cli": sum(
            tools["pickled"]["flow_launches"].values()),
        **flow_res, "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
