"""The port's measurement tools against the JAX package's, on the CPU at
tiny widths: `eval/roofline.py` (its tables against the JAX tool's on the
same rows, its chrome-trace reader on a synthetic trace), `eval/rtf.py`,
`utils/compilation_cache.py`, and the two repairs: the vocoder CLI's JAX
`--wn_impl` names and the packages' public names.  The checking tools
(parity, duration check, SNR ladder) are in
tests/test_torch_port_checks.py.

Tolerances: roofline tables exact (the same arithmetic); vocoder CLI wavs
within one int16 step (f32, the same arithmetic in another order).
"""

import ast
import functools
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import native as t_native
from fac_via_ppg_torch.configs import hparams as t_hp
from fac_via_ppg_torch.eval import roofline as t_roof
from fac_via_ppg_torch.eval import rtf as t_rtf
from fac_via_ppg_torch.ops import cuda_lib, wn_flow
from fac_via_ppg_torch.scripts import train_ppg2mel as t_train_ppg2mel
from fac_via_ppg_torch.scripts import train_waveglow as t_train_waveglow
from fac_via_ppg_torch.scripts import waveglow_inference as t_cli
from fac_via_ppg_torch.utils import compilation_cache as t_cc
from fac_via_ppg_tpu.configs import hparams as j_hp
from fac_via_ppg_tpu.eval import roofline as j_roof
from fac_via_ppg_tpu.eval import rtf as j_rtf
from fac_via_ppg_tpu.models import waveglow as j_wg
from fac_via_ppg_tpu.scripts import waveglow_inference as j_cli
from fac_via_ppg_tpu.train import checkpoint as j_ckpt
from fac_via_ppg_tpu.train.export_torch import (
    save_reference_waveglow_checkpoint,
)
from fac_via_ppg_tpu.utils import compilation_cache as j_cc
from tests.torch_port_helpers import TINY_T2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WG = dict(n_mel_channels=80, hop_length=160, n_flows=2, n_group=8,
          n_early_every=4, n_early_size=2, wn_n_layers=2, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=1024)
T2 = dict(TINY_T2, max_decoder_steps=12)


# ------------------------------------------------------------- roofline

def _trace_events():
    """Two CUDA kernels on one stream and a host span (ignored), then the
    same two kernels again (a second call); a graph-replay span nests
    the second call's first kernel."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0, "dur": 9999.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "wn_flow_bf16_kernel(FlowArgs)",
         "pid": 0, "tid": 7, "ts": 0, "dur": 2000.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn",
         "pid": 0, "tid": 7, "ts": 2000, "dur": 1000.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "graph replay span", "pid": 0,
         "tid": 8, "ts": 5000, "dur": 2500.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "wn_flow_bf16_kernel(FlowArgs)",
         "pid": 0, "tid": 8, "ts": 5000, "dur": 2000.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn",
         "pid": 0, "tid": 7, "ts": 7500, "dur": 1000.0,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 9000, "dur": 500.0, "args": {}},
    ]
    return ev


def _write_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
def test_roofline_reader_self_time_calls_and_counts(tmp_path, gz):
    """Nested spans keep only their self time, `calls` divides times and
    launch counts, a counted kernel's floor is its launches' bounds'
    sum (chip_smoke.py's formula), an uncounted one's None."""
    name = "trace.json.gz" if gz else "trace.json"
    trace = _write_trace(tmp_path / name, _trace_events(), gz)
    launch = t_roof.flow_counts(8, 10240, 4, torch.bfloat16) \
        + (torch.bfloat16,)
    rows = {r["name"]: r for r in t_roof.kernel_table(
        trace, calls=2,
        counts={"wn_flow_bf16_kernel": [launch, launch]})}
    assert set(rows) == {"wn_flow_bf16_kernel(FlowArgs)",
                         "ampere_sgemm_128x64_nn", "graph replay span"}
    flow, gemm = rows["wn_flow_bf16_kernel(FlowArgs)"], \
        rows["ampere_sgemm_128x64_nn"]
    assert flow["ms"] == pytest.approx(2.0) and flow["count"] == 1
    assert gemm["ms"] == pytest.approx(1.0) and gemm["count"] == 1
    # the replay span keeps 0.5 ms of its 2.5 (the nested kernel's 2.0 out)
    assert rows["graph replay span"]["ms"] == pytest.approx(0.25)
    bound = t_roof.flow_bound(8, 10240, 4, torch.bfloat16)
    assert flow["floor_ms"] == pytest.approx(2 * bound[2], rel=1e-12)
    assert flow["bound"] == bound[3] == "operations"
    assert flow["pct_of_floor"] == pytest.approx(100 * 2 * bound[2] / 2.0)
    assert gemm["floor_ms"] is None and gemm["bound"] is None
    t = t_roof.totals(list(rows.values()))
    assert t["device_ms_per_call"] == pytest.approx(3.25)
    assert t["uncounted_ms"] == pytest.approx(1.25)
    fams = t_roof.group_families(list(rows.values()))
    assert fams["wn_flow (hand)"]["floor_ms"] == flow["floor_ms"]
    assert fams["gemm (cuBLAS)"]["floor_ms"] is None
    assert "-" in t_roof.format_table(fams)


def test_roofline_counts_must_name_a_traced_kernel(tmp_path):
    trace = _write_trace(tmp_path / "t.json", _trace_events())
    with pytest.raises(ValueError, match="lacks"):
        t_roof.kernel_table(trace, counts={"wn_layer_bf16_kernel": []})


def test_roofline_tables_match_jax():
    """group_families, totals and format_table on the same rows (every
    kernel counted, the JAX tool's fields) as the JAX tool's."""
    rows = [
        {"name": "convolution.3", "ms": 2.5, "count": 4, "gb": 0.5,
         "gflops": 900.0, "floor_ms": 1.2, "pct_of_floor": 48.0,
         "bound": "operations"},
        {"name": "fusion.7", "ms": 1.0, "count": 2, "gb": 2.0,
         "gflops": 1.0, "floor_ms": 0.6, "pct_of_floor": 60.0,
         "bound": "bytes"},
        {"name": "copy.1", "ms": 0.25, "count": 0, "gb": 0.1,
         "gflops": 0.0, "floor_ms": 0.03, "pct_of_floor": 12.0,
         "bound": "bytes"},
        {"name": "odd", "ms": 0.5, "count": 1, "gb": 0.0, "gflops": 0.0,
         "floor_ms": 0.0, "pct_of_floor": 0.0, "bound": "bytes"},
    ]
    pats = {"conv": ("convolution",), "fusion": ("fusion",),
            "copy": ("copy",)}
    want = j_roof.group_families(rows, pats)
    got = t_roof.group_families(rows, pats)
    assert list(got) == list(want)
    for name, w in want.items():
        for k, v in w.items():
            assert got[name][k] == pytest.approx(v), (name, k)
    assert t_roof.format_table(got) == j_roof.format_table(want)
    tw, tg = j_roof.totals(rows), t_roof.totals(rows)
    for k, v in tw.items():
        assert tg[k] == pytest.approx(v), k


def test_roofline_bounds_are_the_smokes_formula():
    """layer_bound / flow_bound at the main paths' shapes: the FLOP and
    byte counts chip_smoke.py quoted before they moved here."""
    f, b, ms, by = t_roof.layer_bound(4, 10000, torch.bfloat16)
    C = 256
    assert f == 2 * 4 * 10000 * (3 * C * 2 * C + C * 2 * C)
    assert b == (4 * 10000 * 5 * C + 6 * C * C + 2 * C + 2 * C * C
                 + 2 * C) * 2
    assert by == "operations" and ms == pytest.approx(f / 989e12 * 1e3)
    f, b, ms, by = t_roof.flow_bound(8, 20000, 4, torch.float32)
    assert ms == pytest.approx(f / 67e12 * 1e3) and by == "operations"
    counts = t_roof.waveglow_counts(t_hp.WaveGlowConfig(), 8, 512,
                                    torch.bfloat16, "layer")
    # the layer kernel's two instances: the last layer's and the others'
    assert {k: len(v) for k, v in counts.items()} == {
        "wn_layer_bf16_kernel<false>": 84, "wn_layer_bf16_kernel<true>": 12}
    assert {fl for fl, _, _ in counts["wn_layer_bf16_kernel<true>"]} == {
        t_roof.layer_counts(8, 10240, "bfloat16", last=True)[0]}
    assert list(t_roof.waveglow_counts(
        t_hp.WaveGlowConfig(wn_n_channels=128), 8, 512, None, "layer")) \
        == ["wn_layer_tile_kernel<float>"]
    flows = t_roof.waveglow_counts(t_hp.WaveGlowConfig(), 8, 512, None,
                                   "flow")["wn_flow_f32_kernel"]
    assert [fl for fl, _, _ in flows] == [
        t_roof.flow_counts(8, 10240, n, torch.float32)[0]
        for n in (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)]


def test_roofline_cond_counts():
    """The int8 cond kernel's counts: 2*M*K*N operations at int8's peak,
    its codes, weights, output, scales and bias once; one launch a flow
    in waveglow_counts with cond_impl "int8", none without it."""
    f, b = t_roof.cond_counts(307200, 640, 4096, torch.bfloat16)
    assert f == 2 * 307200 * 640 * 4096
    assert b == (307200 * 640 + 4096 * 640 + 307200 * 4096 * 2
                 + 4 * (307200 + 2 * 4096))
    ms, by = t_roof.floor_ms(f, b, torch.int8)
    assert by == "operations" and ms == pytest.approx(f / 1979e12 * 1e3)
    assert t_roof.cond_counts(8, 640, 1024, torch.float32)[1] == \
        8 * 640 + 1024 * 640 + 8 * 1024 * 4 + 4 * (8 + 2 * 1024)
    cfg = t_hp.WaveGlowConfig()
    counts = t_roof.waveglow_counts(cfg, 24, 640, torch.bfloat16, "flow",
                                    cond_impl="int8")
    M = 24 * 640 * cfg.hop_length // cfg.n_group
    assert {k: len(v) for k, v in counts.items()} == {
        "wn_flow_bf16_kernel": 12, "cond_int8_kernel": 12}
    assert set(counts["cond_int8_kernel"]) == {
        t_roof.cond_counts(M, 640, 4096, torch.bfloat16) + (torch.int8,)}
    assert "cond_int8_kernel" not in t_roof.waveglow_counts(
        cfg, 24, 640, torch.bfloat16, "flow")
    assert list(t_roof.waveglow_counts(cfg, 24, 640, torch.bfloat16, "conv",
                                       cond_impl="int8")) == [
        "cond_int8_kernel"]


def test_roofline_capture_runs_one_more_call(tmp_path):
    """capture() runs `fn` calls + 1 times: the first in the profiler's
    warm-up step, whose records are dropped."""
    ran = []
    t_roof.capture(lambda: ran.append(1), str(tmp_path / "t.json"), calls=2)
    assert len(ran) == 3


def test_roofline_capture_and_cli(tmp_path, capsys):
    """capture() writes a chrome trace torch.profiler can produce here
    (CPU events only: no kernel rows), and the CLI reads a trace."""
    path = t_roof.capture(lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                          str(tmp_path / "cpu.json"))
    assert t_roof.kernel_table(path) == []
    trace = _write_trace(tmp_path / "t.json", _trace_events())
    counts = tmp_path / "counts.json"
    counts.write_text(json.dumps({"wn_flow_bf16": [[1e9, 1e6, "bfloat16"]]}))
    t_roof.main([trace, "--calls", "2", "--counts", str(counts), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert out["totals"]["device_ms_per_call"] == pytest.approx(3.25)
    t_roof.main([str(tmp_path), "--calls", "2"])
    assert "wn_flow (hand)" in capsys.readouterr().out


# ------------------------------------------------------------------ rtf

def test_timed_reads_back_every_call():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2, x

    s = t_rtf.timed(fn, torch.ones(4), warmup=2, iters=3)
    assert s > 0 and len(calls) == 5
    assert t_rtf.readback((torch.ones(3), None)) == 3.0


def test_rtf_harnesses_have_the_jax_keys(monkeypatch):
    """waveglow_rtf and tacotron2_decoder_throughput at the same tiny
    sizes in both packages: the same keys; train_step_times' keys."""
    monkeypatch.setattr(j_hp, "WaveGlowConfig",
                        functools.partial(j_hp.WaveGlowConfig, **WG))
    monkeypatch.setattr(j_hp, "Tacotron2Config",
                        functools.partial(j_hp.Tacotron2Config, **T2))
    want = j_rtf.waveglow_rtf(batch=2, seconds=0.05, warmup=1, iters=1)
    got = t_rtf.waveglow_rtf(batch=2, seconds=0.05, warmup=1, iters=1,
                             cfg=t_hp.WaveGlowConfig(**WG), device="cpu")
    assert set(got) == set(want) and got["rtf"] > 0
    want = j_rtf.tacotron2_decoder_throughput(2, 9, 7, 1, 1)
    got = t_rtf.tacotron2_decoder_throughput(
        2, 9, 7, 1, 1, cfg=t_hp.Tacotron2Config(**T2), device="cpu")
    assert set(got) == set(want)
    assert (got["batch"], got["t_out"]) == (want["batch"], want["t_out"])
    steps = t_rtf.train_step_times(
        1, 1, t2_cfg=t_hp.Tacotron2Config(**T2),
        wg_cfg=t_hp.WaveGlowConfig(**WG), t2_shape=(2, 9, 7),
        wg_shape=(2, 1600), device="cpu")
    assert set(steps) == {"ppg2mel_s_per_iter", "waveglow_s_per_iter"}
    assert min(steps.values()) > 0


# ---------------------------------------------------- compilation cache

def test_compilation_cache_resolution_and_unleak(tmp_path, monkeypatch):
    """Resolved as the JAX helper resolves it (explicit, else the
    environment variable, else None); both library lookups follow it, and
    disabling points them back at the package's build/."""
    default = os.path.join(REPO, "fac_via_ppg_torch", "build")
    lib = cuda_lib.CudaLibrary("wn_flow", {})
    monkeypatch.delenv("FACPPG_COMPILATION_CACHE", raising=False)
    assert t_cc.enable_compilation_cache(None) is None \
        is j_cc.enable_compilation_cache(None)
    assert str(lib.library) == os.path.join(default, "libwn_flow.so")
    try:
        d = tmp_path / "cache"
        got = t_cc.enable_compilation_cache(str(d))
        want = j_cc.enable_compilation_cache(str(d))
        assert got == want == str(d) and d.is_dir()
        assert lib.library == d / "libwn_flow.so" and lib._stale()
        assert wn_flow._LIB.library.parent == d
        assert t_native.LIBRARY == d / "libfacppg_native.so"
        monkeypatch.setenv("FACPPG_COMPILATION_CACHE", str(tmp_path / "env"))
        got = t_cc.enable_compilation_cache(None)
        assert got == j_cc.enable_compilation_cache(None) \
            == str(tmp_path / "env")
        assert cuda_lib.BUILD_DIR == tmp_path / "env"
    finally:
        t_cc.disable_compilation_cache()
        j_cc.disable_compilation_cache()
    assert str(cuda_lib.BUILD_DIR) == default
    assert str(t_native.LIBRARY) == os.path.join(default,
                                                 "libfacppg_native.so")


def test_clis_and_trainers_take_the_cache_dir(tmp_path, monkeypatch):
    """--compilation_cache_dir on the vocoder, synthesis and streaming
    CLIs; both trainers enable the cache from hparams / their argument
    instead of raising."""
    from fac_via_ppg_torch.eval import streaming
    from fac_via_ppg_torch.scripts import generate_synthesis

    d = str(tmp_path / "c")
    assert t_cli.parse_args(["-f", "x", "-w", "y", "-o", "z",
                             "--compilation_cache_dir", d]
                            ).compilation_cache_dir == d
    for mod, req in ((generate_synthesis, ["--teacher_utterance_path", "t",
                                           "--output_dir", "o"]),
                     (streaming, ["--filelist", "f", "--output_dir", "o"])):
        args = mod.parse_args(["--ppg2mel_model", "a", "--waveglow_model",
                               "b", *req, "--compilation_cache_dir", d])
        assert args.compilation_cache_dir == d

    class Stop(Exception):
        pass

    seen = []

    def enable(path):
        seen.append(path)
        raise Stop

    for mod in (t_train_ppg2mel, t_train_waveglow):
        monkeypatch.setattr(mod, "enable_compilation_cache", enable)
    with pytest.raises(Stop):
        t_train_ppg2mel.main(device="cpu", compilation_cache_dir=d,
                             output_directory=str(tmp_path / "r"))
    with pytest.raises(Stop):
        t_train_waveglow.main(device="cpu", compilation_cache_dir=d,
                              output_directory=str(tmp_path / "w"))
    assert seen == [d, d]


# ----------------------------------------------------- the two repairs

@pytest.mark.parametrize("jax_name,port_name", [("xla", "conv"),
                                                ("pallas", "layer")])
def test_vocoder_cli_takes_the_jax_wn_impl_names(tmp_path, jax_name,
                                                 port_name):
    """`--wn_impl xla|pallas` parse and run as the port's conv|layer: the
    JAX CLI's wavs (its xla path; its pallas kernel has no CPU form) within
    one int16 step, on one reference `.pt` and orbax checkpoint of the
    same weights."""
    tiny = {"n_mel_channels": 80, "hop_length": 160, "n_flows": 2,
            "n_group": 8, "n_early_every": 4, "n_early_size": 2,
            "WN_config": {"n_layers": 2, "n_channels": 16,
                          "kernel_size": 3}}
    cfg = j_hp.WaveGlowConfig.from_dict(tiny)
    params = j_wg.init_waveglow(jax.random.PRNGKey(3), cfg)
    rng = np.random.RandomState(3)
    for wn in params["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.02, jnp.float32)
    j_ckpt.save_checkpoint(str(tmp_path / "ckpt"), params, {}, 1e-4, 0)
    save_reference_waveglow_checkpoint(str(tmp_path / "wg.pt"), params, cfg)
    (tmp_path / "config.json").write_text(json.dumps(
        {"waveglow_config": tiny}))
    mels = []
    for i, frames in enumerate((20, 24)):
        mels.append(tmp_path / f"m{i}.npy")
        np.save(mels[-1], (rng.randn(80, frames) * 0.5 - 5).astype(
            np.float32))
    (tmp_path / "mels.txt").write_text("\n".join(map(str, mels)) + "\n")
    args = t_cli.parse_args(["-f", str(tmp_path / "mels.txt"), "-w",
                             str(tmp_path / "wg.pt"), "-o",
                             str(tmp_path / "t"), "-s", "0", "-d", "0.01",
                             "--wn_impl", jax_name,
                             "-c", str(tmp_path / "config.json")])
    assert args.wn_impl == jax_name
    kw = dict(batch_size=2, config_path=str(tmp_path / "config.json"))
    j_cli.main(str(tmp_path / "mels.txt"), str(tmp_path / "ckpt"),
               str(tmp_path / "j"), 0.0, 0.01, wn_impl="xla", **kw)
    t_cli.main(args.filelist_path, args.waveglow_path, args.output_dir, 0.0,
               0.01, wn_impl=args.wn_impl, device="cpu", **kw)
    for m in mels:
        name = m.name + "_synthesis.wav"
        _, got = wavfile.read(tmp_path / "t" / name)
        _, want = wavfile.read(tmp_path / "j" / name)
        assert len(got) == len(want) and np.abs(want).max() > 0
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    from fac_via_ppg_torch.models.waveglow import resolve_wn_impl
    assert resolve_wn_impl(jax_name) == port_name
    with pytest.raises(SystemExit, match="wn_impl"):
        t_cli.main(args.filelist_path, args.waveglow_path, args.output_dir,
                   0.0, 0.0, wn_impl="tpu", device="cpu")


def _jax_public_names(pkg_dir):
    """The names the JAX package's `__init__.py` imports or defines."""
    path = os.path.join(REPO, "fac_via_ppg_tpu", pkg_dir, "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "fac_via_ppg_tpu"):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


PACKAGES = ("configs", "dsp", "frontend", "eval")


@pytest.fixture(scope="module")
def port_imports():
    """For each package, the JAX package's public names that fail to
    import from the port's, in one fresh process (which must load
    neither JAX nor the JAX package)."""
    names = {pkg: sorted(_jax_public_names(pkg)) for pkg in PACKAGES}
    code = ("import importlib, json, sys\n"
            f"names = {names!r}\n"
            "missing = {p: [n for n in ns if not hasattr(importlib."
            "import_module('fac_via_ppg_torch.' + p), n)] "
            "for p, ns in names.items()}\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'fac_via_ppg_tpu'))]\n"
            "print(json.dumps(missing))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return names, json.loads(res.stdout)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_public_names_match_jax(pkg, port_imports):
    """Every public name of the JAX package's `configs`, `dsp`, `frontend`
    and `eval` packages imports from the port's."""
    names, missing = port_imports
    assert names[pkg] and missing[pkg] == []


def test_waveglow_config_and_plotting_repairs(tmp_path):
    from fac_via_ppg_torch.configs import load_waveglow_config
    from fac_via_ppg_torch.train.plotting import plot_ppg_to_numpy
    from fac_via_ppg_tpu.configs import load_waveglow_config as j_load

    ours, theirs = load_waveglow_config(), j_load()
    # the port's copy names torch.distributed's backend, the JAX one ICI
    assert ours["dist_config"].pop("dist_backend") == "nccl"
    theirs["dist_config"].pop("dist_backend")
    assert ours == theirs
    img = plot_ppg_to_numpy(np.random.RandomState(0).rand(16, 40))
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    logger = t_train_ppg2mel.prepare_directories_and_logger(
        str(tmp_path / "out"), "logs")
    assert os.path.isdir(tmp_path / "out" / "logs") and logger is not None
