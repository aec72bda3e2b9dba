"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files (BENCHMARK.json, configs, workloads, metric readers) that a test may
change, with the harness pointed at it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


class BenchCopy:
    def __init__(self, root: Path):
        self.root = root
        self.bench = root / "benchmark"

    def load(self, kind: str, name: str) -> dict:
        with open(self.bench / kind / f"{name}.json") as f:
            return json.load(f)

    def save(self, kind: str, name: str, data: dict) -> None:
        with open(self.bench / kind / f"{name}.json", "w") as f:
            json.dump(data, f)

    def benchmark(self) -> dict:
        with open(self.root / "BENCHMARK.json") as f:
            return json.load(f)

    def save_benchmark(self, data: dict) -> None:
        with open(self.root / "BENCHMARK.json", "w") as f:
            json.dump(data, f)

    def run(self, workload: str, seed: int = 2200000011, seconds=0.01,
            trace: int = 0, hook=None) -> dict:
        from benchmark import run

        return run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        device="cpu", driver_hook=hook)


@pytest.fixture
def bench(tmp_path, monkeypatch):
    from benchmark.core import registry

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for kind in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "benchmark" / kind,
                        tmp_path / "benchmark" / kind)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(registry, "BENCH", tmp_path / "benchmark")
    return BenchCopy(tmp_path)


def shrink_vocoder(b: BenchCopy, channels=None) -> None:
    """vocoder-batch at CPU size: 2 buckets of 2 short mels, and
    optionally narrower coupling nets."""
    w = b.load("workloads", "vocoder-batch")
    w["traffic"].update(batch=2, min_frames=20, max_frames=40,
                        mel_bucket=16)
    b.save("workloads", "vocoder-batch", w)
    if channels:
        c = b.load("configs", "waveglow-16k")
        c["waveglow_config"]["WN_config"]["n_channels"] = channels
        b.save("configs", "waveglow-16k", c)


def shrink_train(b: BenchCopy) -> None:
    """ppg2mel-train at CPU size: 12 utterances of 10-20 frames padded to
    8-frame buckets, the published widths."""
    w = b.load("workloads", "ppg2mel-train")
    w["traffic"].update(utterances=12, min_frames=10, max_frames=20)
    b.save("workloads", "ppg2mel-train", w)
    c = b.load("configs", "fac-vc-16k")
    c["train"]["length_bucket_size"] = 8
    b.save("configs", "fac-vc-16k", c)


def shrink_wgtrain(b: BenchCopy) -> None:
    """waveglow-train at CPU size: 6 half-second wavs, 1600-sample crops,
    64-channel coupling nets."""
    w = b.load("workloads", "waveglow-train")
    w["traffic"].update(wavs=6, wav_seconds=0.5)
    b.save("workloads", "waveglow-train", w)
    c = b.load("configs", "waveglow-16k")
    c["data_config"]["segment_length"] = 1600
    c["waveglow_config"]["WN_config"]["n_channels"] = 64
    b.save("configs", "waveglow-16k", c)
