"""The benchmark of fac_via_ppg_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Each run is one fresh process: it sets the cell up from `--seed` (weights,
traffic, the program's objects) and warms the shapes the cell uses, which
is `setup_s`; measures for `--seconds`; with `--trace 1` also profiles a
few whole batches, requests or steps; reads its peak device memory; frees
the program's state; holds what the timed path produced against the plain
reference; and prints, as its last line, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (also the last
lines of standard error).  It exits nonzero, with no result, without the
cards the cell asks for, or if JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_ext")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "fac_via_ppg_tpu")
# host threads for PyTorch's CPU work: the load of one process with few
# threads, beside the program's own data threads
HOST_THREADS = 4


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a metric reader reads: the cell and its configuration, the
    window's figures (`window`), the traced run's `trace` (core/trace.py's
    TraceData, or None) and what the driver noted beside it (`aux`)."""

    def __init__(self, cell, config, window, trace, aux):
        self.cell, self.config = cell, config
        self.window, self.trace, self.aux = window, trace, aux


def _device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(args, device=None, driver_hook=None) -> dict:
    """One run; returns the result object.  `device` other than None
    (tests only) skips the look for cards; `driver_hook(driver)` lets a
    test break the timed path underneath."""
    import torch

    from benchmark.core import registry, trace as tr
    from benchmark.core.window import sync

    t_start = time.perf_counter()
    bench = registry.benchmark()
    cell = registry.workload(args.workload)
    if cell["name"] != args.workload:
        raise ValueError(f"workloads/{args.workload}.json names "
                         f"{cell['name']!r}")
    config = registry.config(cell["config"])
    e2e, per_layer = registry.cell_metrics(bench, args.workload)
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"{args.workload} needs {chips} cards, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(HOST_THREADS)

    drv = registry.driver(cell["driver"]).Driver(config, cell, args.seed,
                                                 device)
    if driver_hook is not None:
        driver_hook(drv)
    drv.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start

    values = drv.measure(args.seconds)
    values["setup_s"] = setup_s
    trace_data, aux = None, {}
    if args.trace:
        trace_data, aux = drv.traced(tr.Traced)
    info = _device_info(device, chips)
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()

    out = {"correct": None, "attempted": int(drv.attempted),
           "failed": int(drv.failed), "metrics": {}, "device": info}
    if args.trace:
        run_view = Run(cell, config, drv.window, trace_data, aux)
        for m in per_layer:
            value = registry.metric_reader(m["name"]).read(run_view)
            if value is not None:
                out["metrics"][m["name"]] = {"value": float(value),
                                             "unit": m["unit"]}
        info["busy_s"] = tr.busy_seconds(trace_data)
        info["window_s"] = trace_data.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(trace_data),
                            "idle_gaps": tr.idle_gaps(trace_data)}
    else:
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"the {cell['driver']} driver gives no "
                               f"{m['name']}")
            out["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    out["correct"] = bool(ok and drv.failed == 0 and drv.attempted > 0)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None, device=None, driver_hook=None) -> dict:
    args = parse_args(argv)
    out = run(args, device, driver_hook)
    bad = forbidden_modules()
    if bad:
        print("loaded in the result's process: " + ", ".join(bad),
              file=sys.stderr)
        raise SystemExit(3)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
