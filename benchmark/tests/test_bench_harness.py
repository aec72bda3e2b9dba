"""The harness on the CPU: cells, configurations and metrics are found by
name, a new one is taken as data, the drivers run at CPU size with the
kernels' plain forms, the same seed gives the same inputs, and nothing
loaded is JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from benchmark.tests.conftest import (
    ROOT,
    shrink_train,
    shrink_vocoder,
    shrink_wgtrain,
)


def test_registry_finds_files_by_name(bench):
    from benchmark.core import registry

    b = registry.benchmark()
    for w in b["workloads"]:
        cell = registry.workload(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert registry.config(cell["config"])["name"] == w["config"]
        assert hasattr(registry.driver(cell["driver"]), "Driver")
    for m in b["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)
    e2e, layer = registry.cell_metrics(b, "vocoder-batch")
    assert {m["name"] for m in e2e} == {"audio_rt", "setup_s"}
    assert {m["name"] for m in layer} == {
        "device_idle.vocoder", "wn_flow_roofline.vocoder", "mfu.vocoder"}


def test_new_cell_and_metric_are_data(bench):
    """A cell, a configuration and a per-layer metric added as new files
    and entries run without an edit to any existing file."""
    shrink_vocoder(bench, channels=32)
    c = bench.load("configs", "waveglow-16k")
    c["name"] = "waveglow-small"
    bench.save("configs", "waveglow-small", c)
    w = bench.load("workloads", "vocoder-batch")
    w.update(name="vocoder-small", config="waveglow-small")
    bench.save("workloads", "vocoder-small", w)
    (bench.bench / "metrics" / "calls.small.py").write_text(
        "def read(run):\n    return run.window['calls']\n")
    b = bench.benchmark()
    b["workloads"].append({"name": "vocoder-small", "config":
                           "waveglow-small", "traffic": "vocoder-small",
                           "chips": 1, "why": "a test cell"})
    b["end_to_end"][0]["workloads"].append("vocoder-small")
    b["per_layer"].append({"name": "calls.small", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "vocoder", "moves": "audio_rt",
                           "workloads": ["vocoder-small"]})
    bench.save_benchmark(b)
    out = bench.run("vocoder-small", trace=1)
    assert out["correct"] is True
    assert out["metrics"]["calls.small"]["value"] >= 1
    assert "wn_flow_roofline.vocoder" not in out["metrics"]
    out = bench.run("vocoder-small")
    assert set(out["metrics"]) == {"audio_rt", "setup_s"}
    assert list(out)[-1] == "checks"


def test_vocoder_driver_inputs_follow_the_seed(bench):
    from benchmark.core import registry
    from benchmark.drivers.vocoder_batch import Driver, corpus_lengths

    shrink_vocoder(bench, channels=32)
    cell = registry.workload("vocoder-batch")
    cfg = registry.config("waveglow-16k")
    a, b, c = (Driver(cfg, cell, s, "cpu") for s in (7, 7, 8))
    for (ea, la, ma), (eb, lb, mb), (ec, lc, mc) in zip(a.batches,
                                                         b.batches,
                                                         c.batches):
        assert ea == eb == ec and la == lb == lc
        np.testing.assert_array_equal(ma, mb)
        assert not np.array_equal(ma, mc)
    torch.testing.assert_close(a.weights["wn"][0]["end"]["weight"],
                               b.weights["wn"][0]["end"]["weight"])
    # every bucket holds one batch; long and short alternate
    full = bench.load("workloads", "vocoder-batch")["traffic"]
    full.update(batch=24, min_frames=200, max_frames=1000, mel_bucket=64)
    ends = [e for e, _ in corpus_lengths(full)]
    assert ends[:4] == [1024, 256, 960, 320] and len(ends) == 13
    for end, ls in corpus_lengths(full):
        assert len(ls) == 24 and all(end - 64 < n <= end for n in ls)
        assert all(200 <= n <= 1000 for n in ls)


def test_train_driver_inputs_follow_the_seed(bench):
    from benchmark.core import registry
    from benchmark.drivers.train_step import Driver, spread

    shrink_train(bench)
    cell = registry.workload("ppg2mel-train")
    cfg = registry.config("fac-vc-16k")
    a, b, c = (Driver(cfg, cell, s, "cpu") for s in (7, 7, 8))
    for (pa, ma), (pb, mb), (pc, _) in zip(a.job.dataset, b.job.dataset,
                                           c.job.dataset):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
        assert pa.shape == pc.shape and not np.array_equal(pa, pc)
        np.testing.assert_allclose(pa.sum(axis=1), 1.0, rtol=1e-5)
    for d in (a, b, c):
        d.release()
    lengths = spread(60, 200, 600)
    assert min(lengths) >= 200 and max(lengths) <= 600
    assert abs(np.mean(lengths) - 400) < 4


def test_wgtrain_driver_inputs_follow_the_seed(bench):
    from benchmark.core import registry
    from benchmark.drivers.train_step import Driver

    shrink_wgtrain(bench)
    cell = registry.workload("waveglow-train")
    cfg = registry.config("waveglow-16k")
    drivers = [Driver(cfg, cell, s, "cpu") for s in (7, 7, 8)]
    batches = [next(d.feed) for d in drivers]
    for d in drivers:
        d.release()
    for x, y, z in zip(*batches):
        torch.testing.assert_close(x, y)
        assert x.shape == z.shape and not torch.equal(x, z)


def add_training_cells(b) -> None:
    """The training cells' entries, as a later change adds them: their
    files are in benchmark/ already."""
    bj = b.benchmark()
    bj["configs"].append({"name": "fac-vc-16k", "source": "x",
                          "file": "benchmark/configs/fac-vc-16k.json",
                          "reduced": [], "why": "x"})
    for cell, config in (("ppg2mel-train", "fac-vc-16k"),
                         ("waveglow-train", "waveglow-16k")):
        bj["workloads"].append({"name": cell, "config": config,
                                "traffic": cell, "chips": 1, "why": "x"})
    cells = ["ppg2mel-train", "waveglow-train"]
    bj["end_to_end"].append({"name": "train_step_s", "unit": "s/step",
                             "better": "lower", "bound": 0.25,
                             "source": "host_clock", "workloads": cells})
    for name in ("device_idle.train", "mfu.train"):
        bj["per_layer"].append({"name": name, "unit": "%",
                                "better": "lower", "source": "device_trace",
                                "layer": "x", "moves": "train_step_s",
                                "workloads": cells})
    b.save_benchmark(bj)


def test_every_cell_runs_correct_on_the_cpu(bench):
    shrink_vocoder(bench)
    shrink_train(bench)
    shrink_wgtrain(bench)
    add_training_cells(bench)
    out = bench.run("vocoder-batch", trace=1)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"mfu.vocoder"}   # no device trace here
    out = bench.run("ppg2mel-train")
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["train_step_s"]["value"] > 0
    out = bench.run("waveglow-train", trace=1)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"mfu.train"}


def test_no_jax_is_loaded(tmp_path):
    """A whole run in a fresh process, every driver and reader imported:
    no loaded module's top-level name is JAX's or the JAX package's."""
    script = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.core import registry
from benchmark import run
b = registry.benchmark()
for w in b["workloads"]:
    registry.driver(registry.workload(w["name"])["driver"])
for m in b["per_layer"]:
    registry.metric_reader(m["name"])
import benchmark.tools.readings
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    from benchmark import run

    assert run.forbidden_modules() == [] or all(
        m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jaxtyping_like_pkg", object())
    monkeypatch.setitem(sys.modules, "fac_via_ppg_tpu.models", object())
    found = run.forbidden_modules()
    assert "fac_via_ppg_tpu.models" in found
    assert "jaxtyping_like_pkg" not in found
    assert not any(m.startswith("fac_via_ppg_torch") for m in found)


def test_no_card_means_no_result(tmp_path):
    """Without a card the command exits nonzero and prints no result."""
    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "vocoder-batch", "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for w in b["workloads"]:
        cell = json.loads((ROOT / "benchmark" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"] and len(w["why"]) <= 200
