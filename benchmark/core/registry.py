"""Everything the harness runs is found by name: a cell's file
`workloads/<cell>.json` names its configuration `configs/<config>.json`
and its traffic kind, whose driver is `drivers/<kind>.py`; a per-layer
metric `<metric>` of BENCHMARK.json is read by `metrics/<metric>.py`.
A later change adds a cell, a configuration, a driver or a metric as new
files and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
# where the data files are found: the checkout's (a test may point these
# at a copy)
BENCH = PACKAGE
ROOT = PACKAGE.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} does not exist")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def driver(kind: str) -> ModuleType:
    if not (PACKAGE / "drivers" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no driver benchmark/drivers/{kind}.py")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str) -> ModuleType:
    """`metrics/<name>.py` (names hold dots, so it is loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics that `cell` reports: those
    whose `workloads` name it, those without `workloads` in every cell
    (a per-layer one: every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
