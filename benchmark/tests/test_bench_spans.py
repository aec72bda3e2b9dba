"""The readers of the program's spans on the CPU: the cond counts against
hand sums; `cond_roofline.vocoder` and `coupling_roofline.vocoder` on a
shrunk `vocoder-batch` run with `--trace 1` (a device operation put into
its trace, since the CPU has none), and None where the records and the
trace disagree, where there are no records or no device operations; and a
fused stand-in timed at its own least time reads no more than 100 %."""

from __future__ import annotations

import math

import pytest

from benchmark.counts import cond, peaks, wn
from benchmark.tests.conftest import shrink_vocoder

READERS = ("cond_roofline.vocoder", "coupling_roofline.vocoder")


def test_project_counts_by_hand():
    M, K, N = 307200, 640, 4096
    ops, nbytes = cond.project_counts(M, K, N, "int8", 2)
    assert ops == 2 * 307200 * 640 * 4096
    # codes, int8 weights, then row scales, column scales and bias in f32
    assert nbytes == 307200 * 640 + 640 * 4096 + 4 * 307200 + 8 * 4096
    ops, nbytes = cond.project_counts(M, K, N, "dense", 2)
    assert ops == 2 * 307200 * 640 * 4096
    assert nbytes == 2 * 307200 * 640 + 2 * 640 * 4096 + 4 * 4096
    with pytest.raises(ValueError):
        cond.project_counts(M, K, N, "fp8", 1)
    assert cond.project_dtype("int8", 2) == "int8"
    assert cond.project_dtype("dense", 2) == "bfloat16"
    assert cond.project_dtype("dense", 4) == "tf32"
    # the mean bucket's floor: ~0.81 ms a flow, compute-bound at int8
    f = peaks.floor_seconds(*cond.project_counts(M, K, N, "int8", 2), "int8")
    assert f == pytest.approx(2 * M * K * N / 1979e12)
    assert 0.80e-3 < f < 0.82e-3


def test_quantize_counts_by_hand():
    assert cond.quantize_counts(307200, 640, 2) == (
        0, 2 * 307200 * 640 + 307200 * 640 + 4 * 307200)
    assert cond.quantize_counts(3, 5, 4) == (0, 60 + 15 + 12)


def _traced_run(bench):
    """A shrunk vocoder-batch run with --trace 1, its Run view for the
    readers rebuilt from what the driver's traced() returned."""
    from benchmark import run as run_mod
    from benchmark.core import registry
    from fac_via_ppg_torch.train import profiling

    profiling.reset_spans()     # another test's traced run in this process
    seen = {}

    def hook(drv):
        traced = drv.traced

        def keep(tracer):
            seen["trace"], seen["aux"] = traced(tracer)
            seen["window"] = drv.window
            return seen["trace"], seen["aux"]

        drv.traced = keep

    shrink_vocoder(bench, channels=32)
    out = bench.run("vocoder-batch", trace=1, hook=hook)
    assert out["correct"] is True
    # no device operation in a CPU trace: the readers leave both out
    assert not seen["trace"].device
    assert not set(READERS) & set(out["metrics"])
    cell = registry.workload("vocoder-batch")
    config = registry.config("waveglow-16k")
    return run_mod.Run, cell, config, seen


def _with_device(trace, host=None):
    """The trace with one device operation over its window (the card's
    stand-in) and, given, other host events."""
    w0, w1 = trace.window
    return trace._replace(device=[("kernel", w0, w1)],
                          host=trace.host if host is None else host)


def test_readers_on_a_shrunk_traced_run(bench):
    from benchmark.core import registry
    from fac_via_ppg_torch.train import profiling

    Run, cell, config, seen = _traced_run(bench)
    trace = _with_device(seen["trace"])
    anchors = [e for e in trace.host if e[0] == "waveglow.coupling"]
    calls = int(cell["trace"]["calls"])
    assert len(anchors) == calls * 12
    recs = profiling.spans()
    assert sum(r.name == "waveglow.coupling" for r in recs) == len(anchors)
    run = Run(cell, config, seen["window"], trace, seen["aux"])
    for name in READERS:
        value = registry.metric_reader(name).read(run)
        assert value is not None and math.isfinite(value) and value > 0

    # the records and the trace disagree: one traced coupling fewer
    host = [e for e in trace.host if e is not anchors[-1]]
    odd = Run(cell, config, seen["window"], _with_device(trace, host),
              seen["aux"])
    # no device operation: a span's seconds are the host's
    cpu = Run(cell, config, seen["window"], seen["trace"], seen["aux"])
    for name in READERS:
        reader = registry.metric_reader(name)
        assert reader.read(odd) is None
        assert reader.read(cpu) is None
    profiling.reset_spans()
    for name in READERS:
        assert registry.metric_reader(name).read(run) is None


def _fake_run(records, monkeypatch):
    """A traced run of one call whose program recorded `records`."""
    from benchmark.core.trace import TraceData
    from fac_via_ppg_torch.train import profiling

    monkeypatch.setattr(profiling, "spans", lambda: records)
    n = sum(r.name == "waveglow.coupling" for r in records)
    host = [("waveglow.coupling", 10 + i, 11 + i) for i in range(n)]
    trace = TraceData((0, 1000), [("kernel", 0, 1000)], host)

    class Run:
        pass

    run = Run()
    run.trace = trace
    return run


def test_a_fused_stand_in_reads_at_most_100(monkeypatch):
    """A projection fused into its consumer writes no output: timed at
    the least time its inputs and products need, it reads 100 %, not
    more; so does a coupling whose projection runs inside the net."""
    from benchmark.core import registry
    from fac_via_ppg_torch.train.profiling import Span

    M, K, N = 307200, 640, 4096
    need = max(2 * M * K * N / peaks.INT8_OPS,
               (M * K + K * N + 4 * (M + 2 * N)) / peaks.HBM_BYTES)
    attrs = {"M": M, "K": K, "N": N, "impl": "int8", "esz": 2}
    fused = [Span("waveglow.coupling", None, need, 0.0,
                  {"B": 24, "T": 12800, "n_half": 4, "C": 256, "L": 8,
                   "esz": 2}),
             Span("waveglow.cond.project", 0, need, need, attrs)]
    read = registry.metric_reader("cond_roofline.vocoder").read
    assert read(_fake_run(fused, monkeypatch)) == pytest.approx(100.0)

    # the whole coupling at its least time: projection and net together
    flops, nbytes = wn.flow_counts(24, 12800, 4, "bfloat16")
    whole = max(2 * M * K * N / peaks.INT8_OPS + flops / peaks.BF16_FLOPS,
                (M * K + K * N + 4 * (M + 2 * N) + nbytes)
                / peaks.HBM_BYTES)
    fused[0] = fused[0]._replace(seconds=whole)
    read = registry.metric_reader("coupling_roofline.vocoder").read
    assert read(_fake_run(fused, monkeypatch)) == pytest.approx(100.0)
    # any slower reads less
    fused[0] = fused[0]._replace(seconds=2 * whole)
    assert read(_fake_run(fused, monkeypatch)) == pytest.approx(50.0)
