"""Per-kernel device roofline analysis from a torch.profiler trace (the port
of fac_via_ppg_tpu/eval/roofline.py).

The JAX tool reads each TPU kernel's bytes and FLOPs from the kernel's own
trace event.  A torch.profiler chrome trace (`prof.export_chrome_trace`)
carries each CUDA kernel as a complete event ("cat": "kernel") with its
name, start and duration, and neither count.  So the time comes from the
trace and the counts from a table the caller passes: `counts` maps a
substring of a kernel's name to the launches of that kernel in one call,
each `(flops, bytes, dtype)`.  The hand kernels' counts are here
(`layer_counts`, `flow_counts`, `cond_counts`, `waveglow_counts`), and
so are their
bounds (`layer_bound`, `flow_bound`), which chip_smoke.py quotes, so that
a bound in PERF.md and a floor in this table come from one formula.  A
kernel with no count gets `floor_ms` None, never a guessed one.

Usage (as a library):
    path = capture(lambda: run_the_program(), "trace.json", calls=n)
    rows = kernel_table(path, calls=n, counts=waveglow_counts(...))
    print(format_table(group_families(rows)))

Or CLI over an existing trace (a .json / .json.gz file, or a directory of
them):
    python -m fac_via_ppg_torch.eval.roofline TRACE --calls N \\
        [--counts counts.json]

Peaks are an H100 SXM's (dense): 67 TFLOP/s f32 on the CUDA cores, 989
TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, 3.35 TB/s HBM3.  The floor of a launch
is max(bytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]); a kernel's floor
is the sum over its launches in one call.  A kernel at ~100 % of its
floor cannot be made faster without changing its bytes or operations.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Optional

import torch

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 1979e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def floor_ms(flops: float, nbytes: float, dtype) -> tuple:
    """(the least ms of work of `flops` operations in `dtype` moving
    `nbytes`, what bounds it: "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[_dtype(dtype)] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def layer_counts(B: int, T: int, dtype, C: int = 256,
                 last: bool = False) -> tuple:
    """(FLOP, bytes) of one WN layer launch: FLOP 2*B*T*(3C*2C + C*R) with
    R = 2C (C on the last layer); bytes: x, cond, both outputs (the skip
    alone on the last layer) once, and the weights and biases once, in the
    layer pack's dtype."""
    esz = 2 if _dtype(dtype) == torch.bfloat16 else 4
    R = C if last else 2 * C
    flops = 2 * B * T * (3 * C * 2 * C + C * R)
    nbytes = (B * T * (C + 2 * C + (0 if last else C) + C)
              + 3 * C * 2 * C + 2 * C + C * R + R) * esz
    return flops, nbytes


def layer_bound(B: int, T: int, dtype, C: int = 256,
                last: bool = False) -> tuple:
    """(FLOP, bytes, least ms, "operations" or "bytes") of one layer."""
    flops, nbytes = layer_counts(B, T, dtype, C, last)
    return (flops, nbytes) + floor_ms(flops, nbytes, dtype)


def flow_counts(B: int, T: int, n_half: int, dtype, C: int = 256,
                L: int = 8) -> tuple:
    """(FLOP, bytes) of one whole-net launch: FLOP per time row
    2*(n_half*C + L*3C*2C + (L-1)*C*2C + C*C + C*2*n_half); bytes: audio,
    cond and output once, the weights once, biases in f32."""
    esz = 2 if _dtype(dtype) == torch.bfloat16 else 4
    flops = 2 * B * T * (n_half * C + L * 6 * C * C + (L - 1) * 2 * C * C
                         + C * C + 2 * C * n_half)
    nbytes = (esz * (B * T * (n_half + L * 2 * C + 2 * n_half)
                     + n_half * C + L * 6 * C * C + L * 2 * C * C
                     + 2 * C * n_half)
              + 4 * (C + 4 * L * C + 2 * n_half))
    return flops, nbytes


def flow_bound(B: int, T: int, n_half: int, dtype, C: int = 256,
               L: int = 8) -> tuple:
    """(FLOP, bytes, least ms, "operations" or "bytes") of one net."""
    flops, nbytes = flow_counts(B, T, n_half, dtype, C, L)
    return (flops, nbytes) + floor_ms(flops, nbytes, dtype)


def cond_counts(M: int, K: int, N: int, dtype) -> tuple:
    """(int8 operations, bytes) of one int8 cond projection launch
    (ops/cond_int8.py): operations 2*M*K*N; bytes: the (M, K) codes, the
    (N, K) weights, the (M, N) output in `dtype` once, the row scales and
    the f32 w_scale and bias."""
    esz = 2 if _dtype(dtype) == torch.bfloat16 else 4
    return 2 * M * K * N, M * K + N * K + M * N * esz + 4 * (M + 2 * N)


def kernel_name(op: str, dtype, C: int = 256, last: bool = False) -> str:
    """The CUDA kernel (as a trace names it, demangled) that a WN op
    ("layer" or "flow") launches in `dtype`: the Hopper tiles at C = 256,
    where the layer kernel is instantiated apart for the last layer; the
    generic tile, one instance a dtype, at other widths."""
    bf16 = _dtype(dtype) == torch.bfloat16
    if C != 256:
        return f"wn_{op}_tile_kernel<{'__nv_bfloat16' if bf16 else 'float'}>"
    name = f"wn_{op}_{'bf16' if bf16 else 'f32'}_kernel"
    if op == "layer":
        name += "<true>" if last else "<false>"
    return name


def waveglow_counts(cfg, batch: int, n_frames: int, dtype,
                    wn_impl: str, cond_impl: str = "dense"
                    ) -> Dict[str, list]:
    """The hand kernels' launches in one `waveglow_infer` call on a
    (batch, n_mel, n_frames) mel: {kernel name: [(flops, bytes, dtype),
    ...]}: the WN kernels of `wn_impl` (none for "conv"), and with
    cond_impl "int8" the cond kernel's, one a flow (its operations in
    int8)."""
    from fac_via_ppg_torch.models.waveglow import flow_channels

    dtype = _dtype(dtype) or torch.float32
    T = n_frames * cfg.hop_length // cfg.n_group
    C, L = cfg.wn_n_channels, cfg.wn_n_layers
    counts: Dict[str, list] = collections.defaultdict(list)
    for k in reversed(range(cfg.n_flows)):
        n_half = flow_channels(cfg)[k] // 2
        if wn_impl == "flow":
            counts[kernel_name("flow", dtype, C)].append(
                flow_counts(batch, T, n_half, dtype, C, L) + (dtype,))
        elif wn_impl == "layer":
            for i in range(L):
                last = i == L - 1
                counts[kernel_name("layer", dtype, C, last)].append(
                    layer_counts(batch, T, dtype, C, last) + (dtype,))
        if cond_impl == "int8":
            counts["cond_int8_kernel"].append(cond_counts(
                batch * T, cfg.n_mel_channels * cfg.n_group, L * 2 * C,
                dtype) + (torch.int8,))
    return dict(counts)


# ------------------------------------------------------------- the trace

def capture(fn, path: str, calls: int = 1) -> str:
    """Run `fn` `calls` times under torch.profiler (CPU and CUDA activity)
    and write its chrome trace to `path`; returns `path`.  `fn` runs
    calls + 1 times in all: one more call runs first, in the profiler's
    warm-up step, whose records are dropped (a freshly started profiler
    loses the kernel records of its first tens of milliseconds, the first
    flows of a vocoder call), so a counter read around `capture` counts
    calls + 1 calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)

    def step():
        if cuda:
            torch.cuda.synchronize()
        prof.step()

    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        fn()
        step()
        for _ in range(calls):
            fn()
        step()
    return path


def _trace_files(trace: str) -> List[str]:
    if os.path.isfile(trace):
        return [trace]
    out: List[str] = []
    for pat in ("*.json", "*.json.gz"):
        out += glob.glob(os.path.join(trace, "**", pat), recursive=True)
    if not out:
        raise FileNotFoundError(f"no trace json under {trace}")
    return sorted(out)


def load_events(trace: str) -> List[dict]:
    events = []
    for path in _trace_files(trace):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events += (data.get("traceEvents", []) if isinstance(data, dict)
                   else data)
    return events


def _self_times(kept: List[dict]) -> Dict[int, float]:
    """SELF time per event: a span that contains other events on its
    (pid, tid) row keeps only the time its children do not cover
    (flamegraph-style stack walk per row), so nothing is counted twice
    where events nest, as inside a CUDA graph's replay."""
    by_row: Dict[tuple, List[dict]] = collections.defaultdict(list)
    for e in kept:
        by_row[(e.get("pid"), e.get("tid"))].append(e)
    self_us: Dict[int, float] = {}
    for lst in by_row.values():
        lst.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        stack: List[dict] = []
        for e in lst:
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            while stack and float(stack[-1].get("ts", 0.0)) + float(
                    stack[-1].get("dur", 0.0)) <= ts + 1e-9:
                stack.pop()
            self_us[id(e)] = dur
            if stack:
                self_us[id(stack[-1])] -= dur
            stack.append(e)
    return self_us


def _count_key(name: str, counts: dict) -> Optional[str]:
    hits = [k for k in counts if k in name]
    if len(hits) > 1:
        raise ValueError(f"kernel {name!r} matches several counts: {hits}")
    return hits[0] if hits else None


def kernel_table(trace: str, calls: int = 1,
                 counts: Optional[Dict[str, list]] = None) -> List[dict]:
    """Aggregate the trace's CUDA kernel events by name.

    Returns rows {name, ms (self time per call), count (launches per
    call), gb, gflops, floor_ms, pct_of_floor, bound} sorted by time.
    `calls`: identical program executions inside the trace window
    (durations and launch counts divide by it).  `counts`: {substring of
    a kernel's name: [(flops, bytes, dtype) per launch in ONE call]}; a
    kernel it does not name gets gb, gflops, floor_ms, pct_of_floor and
    bound None.  Each count must match one kernel of the trace."""
    counts = counts or {}
    kept = [e for e in load_events(trace) if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() == "kernel"]
    self_us = _self_times(kept)
    agg: Dict[str, dict] = collections.defaultdict(
        lambda: {"us": 0.0, "count": 0})
    for e in kept:
        a = agg[e.get("name", "?")]
        a["us"] += max(self_us[id(e)], 0.0)
        a["count"] += 1

    rows, used = [], set()
    for name, a in agg.items():
        ms = a["us"] / 1e3 / calls
        row = {"name": name, "ms": ms, "count": a["count"] // max(calls, 1),
               "gb": None, "gflops": None, "floor_ms": None,
               "pct_of_floor": None, "bound": None}
        key = _count_key(name, counts)
        if key is not None:
            if key in used:
                raise ValueError(f"count {key!r} matches several kernels")
            used.add(key)
            launches = counts[key]
            t_ops = sum(floor_ms(f, 0, dt)[0] for f, _, dt in launches)
            t_bytes = sum(b for _, b, _ in launches) / PEAK_BYTES * 1e3
            row.update(
                gb=sum(b for _, b, _ in launches) / 1e9,
                gflops=sum(f for f, _, _ in launches) / 1e9,
                floor_ms=sum(floor_ms(f, b, dt)[0]
                             for f, b, dt in launches),
                bound="operations" if t_ops >= t_bytes else "bytes")
            row["pct_of_floor"] = (100.0 * row["floor_ms"] / ms if ms > 0
                                   else 0.0)
        rows.append(row)
    missing = set(counts) - used
    if missing:
        raise ValueError(f"counts name kernels the trace lacks: "
                         f"{sorted(missing)}")
    rows.sort(key=lambda r: -r["ms"])
    return rows


# CUDA kernel families by substring of the lower-cased name (first hit
# wins): the hand kernels, cuDNN convolutions (whose names may also say
# gemm), cuBLAS GEMMs, cuFFT, then PyTorch's own kernels.
FAMILIES = {
    "wn_flow (hand)": ("wn_flow",),
    "wn_layer (hand)": ("wn_layer",),
    "cond_int8 (hand)": ("cond_int8",),
    "conv (cuDNN)": ("conv", "fprop", "dgrad", "wgrad", "winograd"),
    "gemm (cuBLAS)": ("gemm", "gemv", "xmma", "cutlass", "kernel2"),
    "fft (cuFFT)": ("fft",),
    "reduction": ("reduce",),
    "elementwise": ("elementwise", "vectorized", "unrolled"),
    "copy/cat/index": ("copy", "cat", "index", "gather", "scatter", "fill"),
}


def group_families(rows: List[dict], patterns: Optional[dict] = None):
    """Group kernels into named families by substring match of the
    lower-cased name (first hit wins; default FAMILIES).  A family's
    floor_ms sums its counted kernels' floors (None if none is counted),
    and its pct_of_floor divides that by those kernels' ms."""
    patterns = patterns or FAMILIES
    fams: Dict[str, dict] = collections.defaultdict(
        lambda: {"ms": 0.0, "floor_ms": None, "counted_ms": 0.0,
                 "kernels": 0, "gb": None, "gflops": None})
    for r in rows:
        low = r["name"].lower()
        fam = "other"
        for name, pats in patterns.items():
            if any(p in low for p in pats):
                fam = name
                break
        f = fams[fam]
        f["ms"] += r["ms"]
        f["kernels"] += max(r["count"], 1)
        if r["floor_ms"] is not None:
            f["counted_ms"] += r["ms"]
            for k in ("floor_ms", "gb", "gflops"):
                f[k] = (f[k] or 0.0) + r[k]
    for f in fams.values():
        f["pct_of_floor"] = (100.0 * f["floor_ms"] / f["counted_ms"]
                             if f["floor_ms"] is not None
                             and f["counted_ms"] > 0 else None)
    return dict(sorted(fams.items(), key=lambda kv: -kv[1]["ms"]))


def totals(rows: List[dict]) -> dict:
    """Device ms per call; the floors' sum over the counted kernels and
    their share of those kernels' ms; the ms of kernels with no count."""
    ms = sum(r["ms"] for r in rows)
    counted = [r for r in rows if r["floor_ms"] is not None]
    counted_ms = sum(r["ms"] for r in counted)
    floor = sum(r["floor_ms"] for r in counted)
    return {
        "device_ms_per_call": ms,
        "sum_kernel_floor_ms": floor,
        "pct_of_perkernel_sol": (100.0 * floor / counted_ms
                                 if counted_ms else None),
        "uncounted_ms": ms - counted_ms,
    }


def _fmt(x, spec: str, width: int) -> str:
    return f"{'-':>{width}}" if x is None else f"{x:>{width}{spec}}"


def format_table(fams: dict, top: int = 12) -> str:
    lines = [f"{'family':<28}{'ms':>9}{'GB':>8}{'GFLOP':>9}"
             f"{'%floor':>8}  kernels"]
    for name, f in list(fams.items())[:top]:
        lines.append(
            f"{name:<28}{f['ms']:>9.2f}{_fmt(f['gb'], '.2f', 8)}"
            f"{_fmt(f['gflops'], '.1f', 9)}"
            f"{_fmt(f['pct_of_floor'], '.1f', 8)}  {f['kernels']}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("trace", help="a chrome trace (.json / .json.gz) or a "
                                 "directory of them")
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--counts", default=None,
                   help="JSON {kernel name substring: [[flops, bytes, "
                        "dtype], ...] per launch in one call}")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    counts = None
    if args.counts:
        with open(args.counts) as f:
            counts = {k: [tuple(x) for x in v]
                      for k, v in json.load(f).items()}
    rows = kernel_table(args.trace, calls=args.calls, counts=counts)
    if args.json:
        print(json.dumps({"kernels": rows[:args.top],
                          "families": group_families(rows),
                          "totals": totals(rows)}))
        return
    print(format_table(group_families(rows)))
    t = totals(rows)
    sol = ("-" if t["pct_of_perkernel_sol"] is None
           else f"{t['pct_of_perkernel_sol']:.1f}")
    print(f"\ndevice {t['device_ms_per_call']:.3f} ms/call; counted "
          f"kernels' floor {t['sum_kernel_floor_ms']:.3f} ms ({sol}% of "
          f"their time); uncounted {t['uncounted_ms']:.3f} ms")
    print(f"\n{'kernel':<64}{'ms':>9}{'%floor':>8}  bound")
    for r in rows[:args.top]:
        print(f"{r['name'][:63]:<64}{r['ms']:>9.3f}"
              f"{_fmt(r['pct_of_floor'], '.1f', 8)}  {r['bound'] or '-'}")


if __name__ == "__main__":
    main()
