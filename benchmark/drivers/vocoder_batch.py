"""Traffic kind `vocoder_batch`: batch vocoding of a corpus of mels in the
vocoder CLI's serving form (fac_via_ppg_torch/scripts/waveglow_inference.py),
closed loop, one batch in flight, each batch's audio read back to pinned
host memory as the CLI does before it writes wavs.

The corpus: `batch` utterances in each `mel_bucket`-frame bucket between
`min_frames` and `max_frames`, their lengths spread evenly over the
bucket, each padded to its bucket by repeating its last frame
(`bucket_mels`), so every batch is one bucket's `batch` mels.  Every seed
gets the same lengths and batches in the same order (long and short
buckets alternating, so any stretch of the window holds a like mix); the
seed draws the mels' values, the weights and each call's noise.

`audio_rt` is the seconds of unpadded audio in the batches completed in
the window over the window's seconds."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import weights
from benchmark.core.seeds import generator, sub_seed
from benchmark.core.window import sync
from benchmark.counts.models import waveglow_flow_channels
from benchmark.counts.models import waveglow_infer_flops
from benchmark.reference import waveglow as reference
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.models.waveglow import (
    cast_params,
    pack_waveglow_flow,
    pack_waveglow_int8cond,
    remove_weightnorm,
    waveglow_infer,
)

MAX_WAV_VALUE = 32768.0
ROWS_PER_BLOCK = 8   # the reference's rows at a time, to bound its memory
DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def corpus_lengths(traffic: dict) -> list:
    """[(bucket frames, [true frames] * batch)], buckets in serving order:
    longest, shortest, second longest, second shortest, ..."""
    b, lo, hi = traffic["mel_bucket"], traffic["min_frames"], \
        traffic["max_frames"]
    n = traffic["batch"]
    ends = list(range(-(-lo // b) * b, -(-hi // b) * b + 1, b))
    buckets = []
    for end in ends:
        first, last = max(end - b + 1, lo), min(end, hi)
        width = last - first + 1
        buckets.append((end, [first + (width * j + width // 2) // n
                              for j in range(n)]))
    order, i, j = [], len(buckets) - 1, 0
    while i >= j:
        order.append(buckets[i])
        if i != j:
            order.append(buckets[j])
        i, j = i - 1, j + 1
    return order


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.wg = config["waveglow_config"]
        self.hop = config["data_config"]["hop_length"]
        self.sr = config["data_config"]["sampling_rate"]
        self.traffic = t = cell["traffic"]
        self.check_spec = cell["check"]
        self.cell = cell
        self.seed, self.dev = seed, torch.device(device)
        self.cfg = WaveGlowConfig.from_dict(self.wg)
        self.sigma = float(t["sigma"])
        self.attempted = self.failed = 0
        self.window = {}

        # the benchmark's weights, f32 on the device; kept for the reference
        self.weights = weights.waveglow(self.wg, seed, self.dev,
                                        config["weights"]["wn_end_bound"])
        # the vocoder CLI's serving form, built once
        params = remove_weightnorm(self.weights)
        self.dtype = DTYPES[t["dtype"]]
        serve = params if self.dtype is None else cast_params(params,
                                                              self.dtype)
        self.serve = serve
        self.packed_wn = (pack_waveglow_flow(self.cfg, serve)
                          if t["wn_impl"] == "flow" else None)
        self.packed_cond = (pack_waveglow_int8cond(self.cfg, params)
                            if t["cond_impl"] == "int8" else None)
        self.infer = self._program

        # the corpus: one (bucket, true lengths, padded host mels) a batch
        lengths = corpus_lengths(t)
        M = self.wg["n_mel_channels"]
        total = sum(len(ls) * end for end, ls in lengths)
        g = generator(self.dev, seed, "mels")
        flat = (torch.randn(total * M, generator=g, device=self.dev)
                * t["mel_std"] + t["mel_mean"]).cpu().numpy()
        self.batches, pos = [], 0
        for end, ls in lengths:
            mels = flat[pos: pos + len(ls) * end * M].reshape(len(ls), M,
                                                              end)
            pos += len(ls) * end * M
            for r, n in enumerate(ls):   # bucket_mels: repeat the last frame
                mels[r, :, n:] = mels[r, :, n - 1: n]
            self.batches.append((end, ls, mels))
        self.outputs = {}

    # ---------------------------------------------------------------- program
    def _program(self, mel: torch.Tensor, gen: torch.Generator):
        return waveglow_infer(
            self.cfg, self.serve, mel.to(self.dtype or torch.float32),
            self.sigma, gen, wn_impl=self.traffic["wn_impl"],
            packed_wn=self.packed_wn, cond_impl=self.traffic["cond_impl"],
            packed_cond=self.packed_cond)

    def use_control(self) -> None:
        """Put the control in the program's place: the reference with every
        coupling-net product in fp8, on the same mels and noise."""
        def control(mel, gen):
            G = mel.shape[2] * self.hop // self.wg["n_group"]
            noise = reference.draw_noise(self.wg, mel.shape[0], G, gen,
                                         self.dev)
            return reference.infer(self.wg, self.hop, self.weights,
                                   mel.float(), self.sigma, noise, "fp8")

        self.infer = control

    def _call(self, i: int) -> torch.Tensor:
        """Call i of the stream: the CLI's launch and readback of batch
        i mod the corpus's batches, its noise from its own generator."""
        end, ls, mels = self.batches[i % len(self.batches)]
        with torch.no_grad():
            mel = torch.as_tensor(np.ascontiguousarray(mels), device=self.dev)
            audio = self.infer(mel, generator(self.dev, self.seed, "call", i))
            audio = audio.float() * MAX_WAV_VALUE
        host = torch.empty(audio.shape, dtype=torch.float32,
                           pin_memory=self.dev.type == "cuda")
        host.copy_(audio, non_blocking=self.dev.type == "cuda")
        sync(self.dev)
        return host

    def warm(self) -> None:
        for i in range(len(self.batches)):   # every bucket's shape once
            self._call(-1 - i)

    def measure(self, seconds: float) -> dict:
        n, audio_s, samples = 0, 0.0, 0
        t0 = time.perf_counter()
        while True:
            self.outputs[n] = self._call(n)
            ls = self.batches[n % len(self.batches)][1]
            audio_s += sum(ls) * self.hop / self.sr
            samples += sum(ls) * self.hop
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.calls = n
        self.attempted = sum(len(self.batches[i % len(self.batches)][1])
                             for i in range(n))
        self.window = {"seconds": wall, "calls": n, "audio_s": audio_s,
                       "model_flops": waveglow_infer_flops(
                           self.wg, self.hop, samples)}
        return {"audio_rt": audio_s / wall}

    def traced(self, tracer) -> tuple:
        """The next `trace.calls` calls of the stream under the profiler;
        aux: each flow kernel launch's (B, T, n_half) in launch order."""
        first = self.calls
        n = int(self.cell["trace"]["calls"])
        launches = []
        with tracer(self.dev) as t:
            for i in range(first, first + n):
                self._call(i)
                end, ls, _ = self.batches[i % len(self.batches)]
                T = end * self.hop // self.wg["n_group"]
                chans = waveglow_flow_channels(self.wg)
                launches += [(len(ls), T, chans[k] // 2)
                             for k in reversed(range(self.wg["n_flows"]))]
        return t.data, {"flow_launches": launches,
                        "dtype": self.traffic["dtype"]}

    def release(self) -> None:
        self.serve = self.packed_wn = self.packed_cond = None

    # ---------------------------------------------------------------- check
    def check(self) -> dict:
        """The reference over a sample of the window's calls, drawn from
        the seed with the longest batch in it.  Per utterance, the
        relative error of its unpadded audio against the float32
        reference, over the error that storing the audio between flows
        in the serving dtype alone makes (the yardstick, which follows how
        far these weights amplify a rounding); the largest ratio."""
        outs = self.outputs
        self.failed = sum(int((~torch.isfinite(h)).any(dim=1).sum())
                          for h in outs.values())
        calls = sorted(outs)
        longest = max(calls[:len(self.batches)],
                      key=lambda i: self.batches[i % len(self.batches)][0])
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        rest = [i for i in calls if i != longest]
        k = min(int(self.check_spec["calls"]) - 1, len(rest))
        sample = [longest] + [int(i) for i in
                              rng.choice(rest, size=k, replace=False)]
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            worst = max(self.error_ratio(i, outs[i]) for i in sample)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        self.outputs = {}
        return {"audio_err_ratio": (worst, float(
            self.check_spec["audio_err_ratio"]))}

    def error_ratio(self, i: int, host: torch.Tensor) -> float:
        end, ls, mels = self.batches[i % len(self.batches)]
        B = mels.shape[0]
        G = end * self.hop // self.wg["n_group"]
        noise = reference.draw_noise(self.wg, B, G,
                                     generator(self.dev, self.seed, "call",
                                               i), self.dev)
        store = self.dtype or torch.float32
        rows = ROWS_PER_BLOCK
        norm = torch.linalg.vector_norm
        worst = 0.0
        with torch.no_grad():
            for r0 in range(0, len(ls), rows):
                r1 = min(r0 + rows, len(ls))
                mel = torch.as_tensor(mels[r0:r1], device=self.dev)
                z = [n[r0:r1] for n in noise]
                ref = reference.infer(self.wg, self.hop, self.weights, mel,
                                      self.sigma, z)
                yard = reference.infer(self.wg, self.hop, self.weights, mel,
                                       self.sigma, z, store=store)
                got = host[r0:r1].to(self.dev) / MAX_WAV_VALUE
                for r in range(r1 - r0):
                    n = ls[r0 + r] * self.hop
                    base = norm(ref[r, :n])
                    err = norm(got[r, :n] - ref[r, :n]) / base
                    unit = norm(yard[r, :n] - ref[r, :n]) / base
                    worst = max(worst, float(err / unit))
        return worst
