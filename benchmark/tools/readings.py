"""The readings that a cell's limits are set from: the program's sound
runs and the control's, each seed a driver set up anew, measured for a
short window and checked, in one process.

    python3 benchmark/tools/readings.py --workload CELL --seeds 11,12,13
        [--seconds 5] [--control]

prints one JSON line per seed: {"seed", "control", "checks", "attempted",
"failed"}.  `--control` puts the cell's control in the program's place
(the driver's `use_control`)."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, seconds: float, control: bool,
             device=None) -> list:
    import torch

    from benchmark.core import registry

    cell = registry.workload(workload)
    config = registry.config(cell["config"])
    dev = torch.device(device or "cuda")
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = registry.driver(cell["driver"]).Driver(config, cell, seed,
                                                     dev)
        if control:
            drv.use_control()
        drv.warm()
        drv.measure(seconds)
        drv.release()
        checks = drv.check()
        line = {"seed": seed, "control": control,
                "checks": {k: v[0] for k, v in checks.items()},
                "attempted": drv.attempted, "failed": drv.failed,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
        del drv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.seconds, args.control)


if __name__ == "__main__":
    main()
