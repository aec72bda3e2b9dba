"""WaveGlow's one serving form (models/waveglow.py::serving_form,
waveglow_serve) on the CPU: a form built once gives `waveglow_infer`'s
audio bit for bit on every path it serves, call after call; the
constructor refuses what the port does not serve, with the messages the
CLIs and the bench have always given, before it touches the weights;
serving a built form casts and packs nothing; and its int8 codes come
from the params as given, while `waveglow_infer(dtype=)` keeps packing
the cast params."""

import dataclasses

import pytest
import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.parallel.mesh import Mesh

CFG = WaveGlowConfig(n_mel_channels=16, hop_length=32, n_flows=5, n_group=8,
                     n_early_every=2, n_early_size=2, wn_n_layers=2,
                     wn_n_channels=16, wn_kernel_size=3,
                     upsample_kernel_size=256)
B, FRAMES = 2, 6
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def model():
    """Seeded f32 params (remove_weightnorm form) with nonzero end convs,
    so that every coupling and the cond matter, and a mel batch."""
    g = torch.Generator().manual_seed(3)
    params = twg.remove_weightnorm(twg.init_waveglow(CFG, g))
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.1
        wn["end"]["bias"] = torch.randn(wn["end"]["bias"].shape,
                                        generator=g) * 0.1
    mel = torch.randn((B, CFG.n_mel_channels, FRAMES), generator=g) - 4.0
    return params, mel


def _gen():
    return torch.Generator().manual_seed(11)


PATHS = [(dtype, wn_impl, cond_impl)
         for dtype in (None, BF16)
         for wn_impl in ("conv", "layer", "flow")
         for cond_impl in ("dense", "int8")
         if not (wn_impl == "layer" and cond_impl == "int8")]


@pytest.mark.parametrize("dtype,wn_impl,cond_impl", PATHS)
def test_form_built_once_gives_waveglow_infer_audio(model, dtype, wn_impl,
                                                    cond_impl):
    """Two calls in a row on one form equal `waveglow_infer` with the
    int8 pack every serving caller makes (from the f32 params)."""
    params, mel = model
    form = twg.serving_form(CFG, params, dtype=dtype, wn_impl=wn_impl,
                            cond_impl=cond_impl)
    packed_cond = (twg.pack_waveglow_int8cond(CFG, params)
                   if cond_impl == "int8" else None)
    want = twg.waveglow_infer(CFG, params, mel, 0.6, _gen(), dtype=dtype,
                              wn_impl=wn_impl, cond_impl=cond_impl,
                              packed_cond=packed_cond)
    for _ in range(2):
        got = twg.waveglow_serve(form, mel, 0.6, _gen())
        assert got.dtype == (dtype or torch.float32)
        assert torch.equal(got, want)


@pytest.mark.parametrize("wn_impl,cond_impl,dtype",
                         [("flow", "int8", BF16), ("layer", "dense", None),
                          ("conv", "int8", BF16)])
def test_waveglow_infer_uses_the_packs_it_is_given(model, wn_impl,
                                                   cond_impl, dtype):
    """The vocoder-batch cell's call: the cast weights and their packs
    handed to `waveglow_infer` without `dtype` are served as they are, as
    the form that holds them serves them."""
    params, mel = model
    form = twg.serving_form(CFG, params, dtype=dtype, wn_impl=wn_impl,
                            cond_impl=cond_impl)
    got = twg.waveglow_infer(
        CFG, form.params, mel.to(dtype or torch.float32), 0.6, _gen(),
        wn_impl=wn_impl,
        packed_wn=None if wn_impl == "conv" else form.wn,
        cond_impl=cond_impl, packed_cond=form.packed_cond)
    assert torch.equal(got, twg.waveglow_serve(form, mel, 0.6, _gen()))


REFUSED = [
    (dict(wn_impl="layer", cond_impl="int8"),
     ["requires --wn_impl flow"]),
    (dict(wn_impl="flow", wn_int8_flows=1),
     ["--wn_int8_flows.*requires wn_impl='xla'",
      "wn_int8_flows/rs requires wn_impl='xla'"]),
    (dict(wn_impl="layer", wn_int8_rs_flows=1),
     ["--wn_int8_rs_flows.*requires wn_impl='xla'",
      "wn_int8_flows/rs requires wn_impl='xla'"]),
    (dict(wn_impl="flow", mesh=Mesh(1, 2, torch.device("cpu"))),
     ["conv formulation", "--wn_impl conv"]),
    (dict(wn_impl="conv", wn_int8_flows=1, wn_int8_quant="row"),
     ["unknown wn_int8_quant"]),
    (dict(wn_impl="tpu"), ["unknown wn_impl"]),
    (dict(wn_impl="conv", cond_impl="fp8"), ["unknown cond_impl"]),
    (dict(wn_impl="conv", cond_impl="int8", cond_quant="row"),
     ["unknown cond_quant"]),
]


@pytest.mark.parametrize("kw,matches", REFUSED)
def test_constructor_refuses_before_it_reads_the_weights(kw, matches):
    """Each refusal comes from the constructor's one check, on params it
    never reads (an empty dict), with every phrase the CLI, bench and
    `waveglow_infer` tests match."""
    for match in matches:
        with pytest.raises(ValueError, match=match):
            twg.serving_form(CFG, {}, **kw)
        with pytest.raises(ValueError, match=match):
            twg.check_serving(CFG, kw["wn_impl"], kw.get("cond_impl",
                                                         "dense"),
                              kw.get("cond_quant", "column"),
                              kw.get("wn_int8_flows", 0),
                              kw.get("wn_int8_rs_flows", 0),
                              kw.get("wn_int8_quant", "column"),
                              kw["mesh"].shape["model"] if "mesh" in kw
                              else 1)


def test_constructor_refuses_wn_int8_off_kernel_size_3():
    cfg = dataclasses.replace(CFG, wn_kernel_size=5)
    with pytest.raises(ValueError, match="wn_kernel_size=3 only, got 5"):
        twg.serving_form(cfg, {}, wn_impl="conv", wn_int8_flows=1)


@pytest.mark.parametrize("kw", [
    dict(dtype=BF16, wn_impl="flow", cond_impl="int8"),
    dict(dtype=BF16, wn_impl="layer"),
    dict(wn_impl="flow", cond_impl="dense"),
    dict(dtype=BF16, wn_impl="conv", cond_impl="int8", wn_int8_flows=2,
         wn_int8_rs_flows=3),
    dict(wn_impl="conv", cond_impl="int8", cond_quant="tensor",
         wn_int8_flows=5, wn_int8_quant="tensor"),
])
def test_serving_a_built_form_casts_and_packs_nothing(model, monkeypatch,
                                                      kw):
    params, mel = model
    form = twg.serving_form(CFG, params, **kw)
    want = twg.waveglow_serve(form, mel, 0.6, _gen())

    def refuse(*a, **k):
        raise AssertionError("packed or cast while serving a built form")

    for name in ("cast_params", "pack_waveglow_layer", "pack_waveglow_flow",
                 "pack_waveglow_int8cond", "pack_waveglow_wn_int8",
                 "tp_shard_waveglow", "tp_shard_int8cond",
                 "tp_shard_wn_int8", "pack_wn_flow", "pack_wn_layer"):
        monkeypatch.setattr(twg, name, refuse)
    assert torch.equal(twg.waveglow_serve(form, mel, 0.6, _gen()), want)


@pytest.mark.parametrize("wn_impl", ["flow", "conv"])
def test_int8_codes_come_from_the_params_as_given(model, wn_impl):
    """A bf16 form packs the f32 params' codes; `waveglow_infer(dtype=
    bf16)` without a pack casts first and packs the cast params' codes,
    as the JAX package does, and its audio is the form's on the cast
    params, not the f32-packed form's."""
    params, mel = model
    form = twg.serving_form(CFG, params, dtype=BF16, wn_impl=wn_impl,
                            cond_impl="int8")
    f32 = twg.pack_waveglow_int8cond(CFG, params)
    cast = twg.pack_waveglow_int8cond(CFG, twg.cast_params(params, BF16))
    for got, want in zip(form.packed_cond, f32):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(not torch.equal(a["wq"], b["wq"]) for a, b in zip(f32, cast))

    lazy = twg.waveglow_infer(CFG, params, mel, 0.6, _gen(), dtype=BF16,
                              wn_impl=wn_impl, cond_impl="int8")
    cast_form = twg.serving_form(CFG, twg.cast_params(params, BF16),
                                 dtype=BF16, wn_impl=wn_impl,
                                 cond_impl="int8")
    assert torch.equal(lazy, twg.waveglow_serve(cast_form, mel, 0.6,
                                                _gen()))
    assert not torch.equal(lazy, twg.waveglow_serve(form, mel, 0.6, _gen()))
