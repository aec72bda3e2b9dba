"""The port's benchmark (`fac_via_ppg_torch/bench.py`) against the JAX
package's root `bench.py`, tiny on the CPU.

Each configuration runs in both packages at the same tiny size (the JAX
bench's full-size model factories monkeypatched to tiny ones, its fixed
sizes passed to the port's functions as arguments): the port's line must
have the JAX line's keys, minus `vs_baseline` (a TPU target), with the
JAX detail's keys less `int8_snr_note` (the JAX package's SNRs) and plus
`tf32`, and the same metric and unit.  Values are timings and are not
compared.  The staged configurations, whose JAX compiles take
longest, are in tests/test_torch_port_bench_staged.py.  The JAX bench's
`--wn_impl` default, xla, is the port's conv formulation; on the CPU the
port's kernel wrappers take their plain versions.
"""

import functools

import pytest
import torch

from fac_via_ppg_torch import bench as t_bench
from fac_via_ppg_torch.configs import hparams as t_hp
from tests.torch_port_bench_cases import (  # noqa: F401 (fixtures)
    WG,
    bundle,
    check_line,
    jax_tiny,
    t_models,
)


@pytest.mark.parametrize("config", ["rtf", "e2e_fused", "e2e_fused_batch",
                                    "streaming", "streaming_fused",
                                    "train_waveglow"])
def test_bench_line_has_the_jax_keys(config, t_models, jax_tiny):
    check_line(config, t_models)


@pytest.mark.parametrize("kw,flag", [
    (dict(wn_int8_flows=4), "--wn_int8_flows"),
    (dict(wn_int8_rs_flows=12), "--wn_int8_rs_flows"),
    (dict(wn_int8_quant="tensor"), "--wn_int8_quant"),
])
def test_bench_unported_rtf_flags_raise(kw, flag):
    """(The name is older than the rungs, which raised then.)  The WN int8
    rung flags run on the conv formulation (tiny, on the CPU): a rung's line records them and, as the JAX bench's, leaves out
    the dense and f32 figures.  On the flow kernel a rung raises the JAX
    package's error (its waveglow_infer refuses them off its xla path)."""
    tiny = dict(batch=2, seconds=0.1, warmup=1, iters=1,
                cfg=t_hp.WaveGlowConfig(**WG), device="cpu")
    line = t_bench.bench_waveglow_rtf(wn_impl="conv", **tiny, **kw)
    d = line["detail"]
    assert line["value"] > 0 and d["wn_impl"] == "conv"
    rung = bool(kw.get("wn_int8_flows") or kw.get("wn_int8_rs_flows"))
    assert d["wn_int8_flows"] == kw.get("wn_int8_flows", 0)
    assert d["wn_int8_rs_flows"] == kw.get("wn_int8_rs_flows", 0)
    assert ("rtf_bf16_dense" in d) is not rung
    assert ("rtf_float32" in d) is not rung
    if rung:
        with pytest.raises(ValueError, match=f"{flag}.*requires wn_impl"
                                              "='xla'"):
            t_bench.bench_waveglow_rtf(**tiny, **kw)


def test_bench_unported_grouped_upsample_raises():
    """(The name is older than the flag, which raised then.)  The CLI takes
    --grouped_upsample for the JAX bench's sake; the train step (tiny, on
    the CPU) runs the port's one upsampler, and the line records the
    flag."""
    assert t_bench.parse_args(["--config", "train_waveglow",
                               "--grouped_upsample"]).grouped_upsample
    line = t_bench.bench_train_waveglow(
        warmup=1, iters=1, batch=1, segment=1600, grouped_upsample=True,
        cfg=t_hp.WaveGlowConfig(**WG), device="cpu")
    assert line["value"] > 0
    assert line["detail"]["grouped_upsample"] is True


def test_bench_layer_kernel_takes_no_int8_cond():
    """The JAX bench quietly serves dense for pallas + int8; the port
    refuses the combination."""
    with pytest.raises(ValueError, match="requires --wn_impl flow"):
        t_bench.bench_waveglow_rtf(wn_impl="pallas", cond_impl="int8",
                                   device="cpu")


def test_bench_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_bench.bench_waveglow_rtf(batch=1, seconds=0.1,
                                   cfg=t_hp.WaveGlowConfig(**WG))


def test_bench_cli_prints_one_json_line(capsys, monkeypatch):
    """main() with the rtf defaults on the CPU, the sizes cut through the
    function's defaults: one line, the flow kernel's plain version and
    the int8 cond."""
    monkeypatch.setattr(t_bench, "bench_waveglow_rtf", functools.partial(
        t_bench.bench_waveglow_rtf, batch=2, seconds=0.1, warmup=1,
        iters=1, cfg=t_hp.WaveGlowConfig(**WG)))
    out = t_bench.main(["--cpu", "--repeats", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("{")
    d = out["detail"]
    assert (d["wn_impl"], d["cond_impl"], d["repeats"]) == ("flow", "int8",
                                                            2)
    assert len(d["rtf_runs"]) == 2 and d["f32_batch"] == 2
