"""Featurization throughput: the host path per utterance against the
batched device path (the port of fac_via_ppg_tpu/eval/featurize_bench.py).

The training preload (data/ppg_mel_dataset.py, reference
data_utils.py:204-215) featurizes the corpus before training starts.  This
harness measures utterances per second for

  * host:   `compute_full_ppg_wrapper`: the MFCC on the host (native C++
            or numpy), CMN, splice and LDA in numpy, then the TDNN per
            utterance on the device (the default preload path);
  * device: `frontend.ppg.DeviceFeaturizer`: the whole MFCC -> CMN ->
            splice -> LDA -> TDNN chain on the device, one batched program
            per length bucket (`hparams.featurize_device`).

Each pass is timed between two `torch.cuda.synchronize()` on the card;
the paths take turns, REPEATS passes each after an untimed one, and the
median pass is reported with every pass's time.

    python -m fac_via_ppg_torch.eval.featurize_bench [n_utts] [seconds]

runs on the CUDA card at the default substitute AM; `run_bench(...,
device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from fac_via_ppg_torch.frontend.ppg import (
    DependenciesPPG,
    DeviceFeaturizer,
    compute_full_ppg_wrapper,
)
from fac_via_ppg_torch.utils.device import resolve_device

REPEATS = 5  # timed passes a path


def synth_corpus(n: int, seconds: float, fs: int = 16000,
                 seed: int = 0) -> List[np.ndarray]:
    """Length-jittered noise utterances (int16 scale, like read_wav)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = int(fs * seconds * (0.8 + 0.4 * rng.rand()))
        out.append((rng.randn(s) * 3000.0).astype(np.float64))
    return out


def run_bench(n_utts: int = 32, seconds: float = 4.0,
              deps: Optional[DependenciesPPG] = None,
              dither: float = 0.0, check: bool = True,
              device: Optional[torch.device] = None) -> dict:
    """Time each path REPEATS times, in turns (host, device, host, ...),
    after one untimed pass of each over the same utterances (so the same
    shapes, chunks and buckets); report the median pass and every pass."""
    device = resolve_device(device)
    deps = deps or DependenciesPPG()
    wavs = synth_corpus(n_utts, seconds)
    fs = 16000
    featurizer = DeviceFeaturizer(deps, dither=dither, device=device)

    def host_pass():
        return [compute_full_ppg_wrapper(w, fs, deps.nnet, deps.lda, 10,
                                         dither=dither, device=device)
                for w in wavs]

    def device_pass():
        return featurizer(wavs, fs)

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, res

    host, dev = host_pass(), device_pass()  # warm-up, as a real preload
    host_runs, dev_runs = [], []
    for _ in range(REPEATS):
        host_runs.append(timed(host_pass)[0])
        dev_runs.append(timed(device_pass)[0])
    host_s, dev_s = float(np.median(host_runs)), float(np.median(dev_runs))

    out = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_utts": n_utts,
        "utt_seconds": seconds,
        "host_s": host_s,
        "device_s": dev_s,
        "host_utts_per_s": n_utts / host_s,
        "device_utts_per_s": n_utts / dev_s,
        "speedup": host_s / dev_s,
        "host_s_runs": host_runs,
        "device_s_runs": dev_runs,
    }
    if check and dither == 0.0:
        out["max_abs_err"] = max(float(np.abs(h - d).max())
                                 for h, d in zip(host, dev))
        assert host[0].shape[1] == dev[0].shape[1]
    return out


if __name__ == "__main__":
    import json
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    sec = float(sys.argv[2]) if len(sys.argv) > 2 else 4.0
    print(json.dumps(run_bench(n, sec)))
