"""Throughput / real-time-factor harnesses (the port of
fac_via_ppg_tpu/eval/rtf.py).

Measures, on one device:
  * WaveGlow synthesis RTF (the batched vocoder),
  * Tacotron2 decoder mel-frames/sec (teacher-forced),
  * the two training steps' seconds per iteration.

Every timed window is measured with CUDA events on the card (the host's
clock on the CPU) and closed by a synchronize, and every timed call ends
in a scalar read back to the host, as in the JAX package, so a call is
counted only once its result exists.  Weights are random and seeded: the
work is that of trained ones.  Each function takes its sizes as
arguments, so that a test can run it tiny with `device="cpu"`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.utils.device import resolve_device


class Window:
    """Seconds between `__enter__` and `__exit__` on `device`: CUDA events
    recorded on the current stream and a synchronize on the card, the
    host's clock on the CPU.  `.seconds` after the block."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = None

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record()
            torch.cuda.synchronize(self.device)
            self.seconds = self._start.elapsed_time(self._end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        return False


def scalar(out) -> torch.Tensor:
    """The sum of a call's output (its first element if a tuple) as an f32
    scalar, still on the device."""
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out.float().sum()


def readback(out) -> float:
    """`scalar(out)` read back to the host: the call is finished."""
    return float(scalar(out).item())


def _device_of(args, out) -> torch.device:
    for x in (out, *args):
        while isinstance(x, (tuple, list)) and x:
            x = x[0]
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def timed(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Mean seconds per call of `fn(*args)`, each call's scalar read back
    (the window on the device of its output)."""
    out = None
    with torch.no_grad():
        for _ in range(warmup):
            out = fn(*args)
            readback(out)
        dev = _device_of(args, out)
        with Window(dev) as w:
            for _ in range(iters):
                readback(fn(*args))
    return w.seconds / iters


def waveglow_rtf(batch: int = 4, seconds: float = 10.0, sigma: float = 0.6,
                 warmup: int = 3, iters: int = 10,
                 cfg: Optional[WaveGlowConfig] = None,
                 wn_impl: str = "flow", device=None) -> dict:
    """f32 WaveGlow inference at `batch` x `seconds` of audio: seconds of
    audio per second (its coupling nets on `wn_impl`)."""
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        remove_weightnorm,
        serving_form,
        waveglow_serve,
    )
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    cfg = cfg or WaveGlowConfig()
    sr = 16000
    n_frames = int(seconds * sr) // cfg.hop_length
    params = remove_weightnorm(
        init_waveglow(cfg, torch.Generator().manual_seed(0)))
    form = serving_form(cfg, move(params, dev), wn_impl=wn_impl)
    mel = torch.as_tensor(
        np.random.RandomState(0).randn(batch, cfg.n_mel_channels, n_frames)
        * 0.5 - 5.0, dtype=torch.float32, device=dev)

    def infer(i):
        g = torch.Generator(dev).manual_seed(i)
        return waveglow_serve(form, mel, sigma, g)

    with torch.no_grad():
        for i in range(warmup):
            readback(infer(i))
        with Window(dev) as w:
            for i in range(iters):
                readback(infer(100 + i))
    audio_seconds = iters * batch * (n_frames * cfg.hop_length) / sr
    return {
        "rtf": audio_seconds / w.seconds,
        "batch": batch,
        "seconds_per_utt": seconds,
    }


def tacotron2_decoder_throughput(batch: int = 8, t_in: int = 500,
                                 t_out: int = 500, warmup: int = 2,
                                 iters: int = 5,
                                 cfg: Optional[Tacotron2Config] = None,
                                 device=None) -> dict:
    """Teacher-forced decoder mel-frames per second (the reference's
    per-frame Python loop is the headline PPG2Mel bottleneck)."""
    from fac_via_ppg_torch.models.tacotron2 import (
        init_tacotron2,
        tacotron2_forward,
    )
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    cfg = cfg or Tacotron2Config()
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(0))
    params, state = move(params, dev), move(state, dev)
    rng = np.random.RandomState(0)
    ppg = torch.as_tensor(np.abs(rng.rand(batch, cfg.n_symbols, t_in)),
                          dtype=torch.float32, device=dev)
    in_len = torch.full((batch,), t_in, dtype=torch.int64, device=dev)
    mel = torch.as_tensor(rng.randn(batch, cfg.n_acoustic_feat_dims, t_out)
                          * 0.1, dtype=torch.float32, device=dev)
    out_len = torch.full((batch,), t_out, dtype=torch.int64, device=dev)

    def fwd(i):
        g = torch.Generator(dev).manual_seed(i)
        return tacotron2_forward(cfg, params, state, ppg, in_len, mel,
                                 out_len, generator=g, training=True)[0][0]

    with torch.no_grad():
        for i in range(warmup):
            readback(fwd(i))
        with Window(dev) as w:
            for i in range(iters):
                readback(fwd(50 + i))
    elapsed = w.seconds / iters
    frames = batch * t_out
    return {
        "mel_frames_per_sec": frames / elapsed,
        "sec_per_batch": elapsed,
        "batch": batch,
        "t_out": t_out,
        # 100 mel frames == 1 s of audio at the 10 ms hop
        "rtf": frames / elapsed / 100.0,
    }


def train_step_times(warmup: int = 2, iters: int = 5,
                     t2_cfg: Optional[Tacotron2Config] = None,
                     wg_cfg: Optional[WaveGlowConfig] = None,
                     t2_shape: tuple = (6, 400, 400),
                     wg_shape: tuple = (3, 10000),
                     device=None) -> dict:
    """Per-iteration seconds of the two training steps at the reference
    operating points: PPG2Mel at batch 6 x 400 frames (`t2_shape` = (B,
    T_in, T_out)), WaveGlow at batch 3 x 10000 samples (`wg_shape`)."""
    from fac_via_ppg_torch.models.tacotron2 import init_tacotron2
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        weight_norm_params,
    )
    from fac_via_ppg_torch.train.optim import make_optimizer
    from fac_via_ppg_torch.train.step import (
        make_tacotron2_train_step,
        make_waveglow_train_step,
    )
    from fac_via_ppg_torch.weights import move

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    out = {}

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    cfg = t2_cfg or Tacotron2Config()
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(0))
    params, state = move(params, dev), move(state, dev)
    opt = make_optimizer(1e-4, 1e-6, 1.0)
    opt_state = opt.init(params)
    step = make_tacotron2_train_step(cfg, opt)
    B, T_in, T_out = t2_shape
    batch = (t(np.abs(rng.rand(B, cfg.n_symbols, T_in))),
             t(np.full((B,), T_in), torch.int64),
             t(rng.randn(B, cfg.n_acoustic_feat_dims, T_out) * 0.1),
             t(np.zeros((B, T_out))),
             t(np.full((B,), T_out), torch.int64))

    def t2_step(i):
        g = torch.Generator(dev).manual_seed(i)
        return step(params, state, opt_state, batch, g).loss

    for i in range(warmup):
        readback(t2_step(i))
    with Window(dev) as w:
        for i in range(iters):
            readback(t2_step(i))
    out["ppg2mel_s_per_iter"] = w.seconds / iters

    wcfg = wg_cfg or WaveGlowConfig()
    wg_params = move(weight_norm_params(
        init_waveglow(wcfg, torch.Generator().manual_seed(0))), dev)
    wg_opt = make_optimizer(1e-5)
    wg_opt_state = wg_opt.init(wg_params)
    wg_step = make_waveglow_train_step(wcfg, wg_opt, sigma=0.7071)
    wb, seg = wg_shape
    frames = (seg + wcfg.hop_length // 2) // wcfg.hop_length
    wg_batch = (t(rng.randn(wb, wcfg.n_mel_channels, frames) * 0.5 - 5.0),
                t(rng.randn(wb, seg) * 0.1))
    for _ in range(warmup):
        readback(wg_step(wg_params, wg_opt_state, wg_batch).loss)
    with Window(dev) as w:
        for _ in range(iters):
            readback(wg_step(wg_params, wg_opt_state, wg_batch).loss)
    out["waveglow_s_per_iter"] = w.seconds / iters
    return out


if __name__ == "__main__":
    import json

    print(json.dumps({
        "waveglow": waveglow_rtf(),
        "tacotron2_decoder": tacotron2_decoder_throughput(),
        "train_steps": train_step_times(),
    }, indent=2))
