"""The port's spans (train/profiling.py::span) on the CPU: nothing happens
with the profiler off; under it each span is kept with its parent (per
thread), attrs and seconds; `trace()` starts from no records; and
`waveglow_infer` records one span per layer boundary with the call's
shapes, its audio unchanged bit for bit."""

import collections
import threading
import time

import pytest
import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.train import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]
# two flows with an early output between them
CFG = WaveGlowConfig(n_mel_channels=16, hop_length=32, n_flows=5, n_group=8,
                     n_early_every=2, n_early_size=2, wn_n_layers=2,
                     wn_n_channels=16, wn_kernel_size=3,
                     upsample_kernel_size=256)


@pytest.fixture(autouse=True)
def _no_records():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_span_off_records_nothing_and_enters_no_record_function(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first = profiling.span("a", None, x=1)
    with first:
        with profiling.span("b", torch.device("cpu"), y=2):
            torch.ones(4).sum()
    assert profiling.span("c") is first      # one shared no-op context
    assert profiling.spans() == []


def test_span_records_under_the_profiler():
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("outer", None, B=2, impl="int8"):
            time.sleep(0.02)
            with profiling.span("inner", None, M=5):
                time.sleep(0.03)
            with profiling.span("inner", None, M=6):
                time.sleep(0.01)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer") == 1 and names.count("inner") == 2
    outer, a, b = profiling.spans()
    assert (outer.name, outer.parent, outer.attrs) == ("outer", None,
                                                       {"B": 2,
                                                        "impl": "int8"})
    assert (a.name, a.parent, a.attrs) == ("inner", 0, {"M": 5})
    assert (b.name, b.parent, b.attrs) == ("inner", 0, {"M": 6})
    assert a.seconds >= 0.03 and b.seconds >= 0.01
    assert outer.seconds >= 0.06
    assert outer.self_seconds == pytest.approx(
        outer.seconds - a.seconds - b.seconds, abs=1e-12)
    assert 0.02 <= outer.self_seconds < outer.seconds
    assert a.self_seconds == a.seconds
    # spans() reads without clearing
    assert [s.name for s in profiling.spans()] == ["outer", "inner", "inner"]


def test_span_parents_are_per_thread(monkeypatch):
    """Two threads open and close nested spans in lockstep, so their
    records interleave; each inner span's parent is its own thread's."""
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.span("outer", None, tag=tag):
            gate.wait()
            with profiling.span("inner", None, tag=tag):
                gate.wait()
                with profiling.span("leaf", None, tag=tag):
                    gate.wait()
            gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.spans()
    assert collections.Counter(s.name for s in recs) == {
        "outer": 2, "inner": 2, "leaf": 2}
    want = {"outer": None, "inner": "outer", "leaf": "inner"}
    for s in recs:
        if want[s.name] is None:
            assert s.parent is None
        else:
            p = recs[s.parent]
            assert p.name == want[s.name] and p.attrs == s.attrs


def test_trace_starts_from_no_records(tmp_path):
    with torch.profiler.profile(activities=CPU):
        with profiling.span("before"):
            pass
    assert [s.name for s in profiling.spans()] == ["before"]
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("inside", None, k=1):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert [(s.name, s.attrs) for s in profiling.spans()] == [
        ("inside", {"k": 1})]


def _infer(params, mel, **kw):
    return twg.waveglow_infer(CFG, params, mel, 0.6,
                              torch.Generator().manual_seed(11), **kw)


@pytest.mark.parametrize("wn_impl,cond_impl", [
    ("conv", "dense"), ("conv", "int8"), ("flow", "int8"),
    ("flow", "dense"), ("layer", "dense")])
def test_waveglow_infer_spans(wn_impl, cond_impl):
    params = twg.init_waveglow(CFG, torch.Generator().manual_seed(3))
    for wn in params["wn"]:     # non-trivial couplings
        wn["end"]["weight"].normal_(0, 0.1, generator=torch.Generator()
                                    .manual_seed(4))
    B, F = 2, 6
    mel = torch.randn(B, 16, F, generator=torch.Generator().manual_seed(5))
    off = _infer(params, mel, wn_impl=wn_impl, cond_impl=cond_impl)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=CPU):
        on = _infer(params, mel, wn_impl=wn_impl, cond_impl=cond_impl)
    assert torch.equal(on, off)

    recs = profiling.spans()
    G, K = F * CFG.hop_length // CFG.n_group, 16 * CFG.n_group
    C, L = CFG.wn_n_channels, CFG.wn_n_layers
    int8 = cond_impl == "int8"
    n = CFG.n_flows
    want = collections.Counter({
        "waveglow.infer": 1, "waveglow.upsample": 1,
        "waveglow.cond.quantize": int(int8), "waveglow.coupling": n,
        "waveglow.cond.project": n, "waveglow.inverse": n})
    assert collections.Counter(s.name for s in recs) == +want  # no zeros
    assert len(recs) == 2 + int(int8) + 3 * n
    root = recs[0]
    assert root.name == "waveglow.infer" and root.parent is None
    assert root.attrs == {"B": B, "G": G, "flows": n}
    chans = list(reversed(twg.flow_channels(CFG)))
    couplings = inverses = 0
    for s in recs[1:]:
        parent = recs[s.parent].name
        assert s.seconds >= s.self_seconds >= 0
        if s.name == "waveglow.upsample":
            assert parent == "waveglow.infer"
            assert s.attrs == {"B": B, "frames": F}
        elif s.name == "waveglow.cond.quantize":
            assert parent == "waveglow.infer"
            assert s.attrs == {"M": B * G, "K": K, "esz": 4}
        elif s.name == "waveglow.coupling":
            assert parent == "waveglow.infer"
            # no clustered flow kernel runs on the CPU
            assert s.attrs == {"B": B, "T": G,
                               "n_half": chans[couplings] // 2,
                               "C": C, "L": L, "esz": 4, "cluster": 0}
            couplings += 1
        elif s.name == "waveglow.cond.project":
            assert parent == "waveglow.coupling"
            assert s.attrs == {"M": B * G, "K": K, "N": L * 2 * C,
                               "impl": cond_impl, "esz": 4}
        else:
            assert s.name == "waveglow.inverse"
            assert parent == "waveglow.infer"
            assert s.attrs == {"B": B, "T": G, "c": chans[inverses]}
            inverses += 1
    assert couplings == inverses == n


@pytest.mark.parametrize("wn_impl,want", [("flow", 2), ("conv", 0),
                                          ("layer", 0)])
def test_coupling_span_carries_the_flow_kernels_cluster(monkeypatch, wn_impl,
                                                        want):
    """`waveglow.coupling`'s `cluster` is ops/wn_flow.cluster_size of the
    call's dtype, width and device where the flow kernel runs (stood in for
    here: the CPU runs none), else 0."""
    seen = []

    def size(dtype, C, device):
        seen.append((dtype, C, torch.device(device).type))
        return 2

    monkeypatch.setattr(twg, "cluster_size", size)
    params = twg.init_waveglow(CFG, torch.Generator().manual_seed(3))
    mel = torch.randn(1, 16, 4, generator=torch.Generator().manual_seed(5))
    with torch.profiler.profile(activities=CPU):
        _infer(params, mel, wn_impl=wn_impl, cond_impl="dense")
    got = {s.attrs["cluster"] for s in profiling.spans()
           if s.name == "waveglow.coupling"}
    assert got == {want}
    assert seen == ([(torch.float32, CFG.wn_n_channels, "cpu")]
                    if wn_impl == "flow" else [])
