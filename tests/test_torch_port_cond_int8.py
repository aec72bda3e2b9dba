"""The int8 cond projection's call structure on the CPU
(ops/cond_int8.py, models/waveglow.py::quantize_cond / _cond_int8): the
grouped spect's codes are made channels-last once a call and every flow's
projection takes them; the plain version is exact (an int32 product, the
f32 chain); and `waveglow_infer(cond_impl="int8")` gives the audio of the
chain it replaced (`torch._int_mm`'s int32 product over (B, K, G) codes,
then the four f32 passes), bit for bit, on both coupling-net paths that
take int8 cond, per column and per tensor.  The kernel itself is held
against the plain version on the card by tests/test_torch_port_card.py."""

import pytest
import torch

from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.ops import cond_int8 as ci8

CFG = WaveGlowConfig(n_mel_channels=16, hop_length=32, n_flows=5, n_group=8,
                     n_early_every=2, n_early_size=2, wn_n_layers=2,
                     wn_n_channels=16, wn_kernel_size=3,
                     upsample_kernel_size=256)
B, FRAMES = 2, 6


@pytest.fixture(scope="module")
def model():
    """Seeded params with nonzero end convs (zero ones would make the
    couplings the identity and the cond unused), and a mel batch."""
    g = torch.Generator().manual_seed(3)
    params = twg.remove_weightnorm(twg.init_waveglow(CFG, g))
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 0.1
        wn["end"]["bias"] = torch.randn(wn["end"]["bias"].shape,
                                        generator=g) * 0.1
    mel = torch.randn((B, CFG.n_mel_channels, FRAMES), generator=g) - 4.0
    return params, mel


def _parent_cond_int8(codes, s_scale, pk, out_dtype):
    """The projection as the port computed it before the kernel, on the
    (B, K, G) view of the codes: one (B*G, K) @ (K, N) int32 product
    (`_int8_conv1x1`), then acc.float() * s * w_scale + bias, cast."""
    acc = twg._int8_conv1x1(pk["wq"], codes.transpose(1, 2))
    s = s_scale if s_scale.dim() == 0 else s_scale[:, :, None]
    return (acc.float() * s * pk["w_scale"] + pk["bias"]).to(out_dtype)


def _infer(params, mel, wn_impl, quant, dtype):
    noise = twg.waveglow_noise(CFG, B, FRAMES * CFG.hop_length // CFG.n_group,
                               torch.Generator().manual_seed(7), "cpu")
    return twg.waveglow_infer(CFG, params, mel, 0.6, dtype=dtype,
                              noise=noise, wn_impl=wn_impl, cond_impl="int8",
                              cond_quant=quant)


@pytest.mark.parametrize("quant", ["column", "tensor"])
def test_quantize_cond_gives_channels_last_codes(quant):
    x = torch.randn((2, 128, 37), generator=torch.Generator().manual_seed(1))
    x[1, :, 4] = 0.0                      # an all-zero column: scale 1e-8
    codes, s = twg.quantize_cond(x, quant)
    quantize = (twg.quantize_per_column_int8 if quant == "column"
                else twg.quantize_per_tensor_int8)
    q, s_want = quantize(x)
    assert codes.shape == (2, 37, 128) and codes.is_contiguous()
    assert torch.equal(codes, q.transpose(1, 2))
    assert torch.equal(s, s_want)


@pytest.mark.parametrize("quant", ["column", "tensor"])
@pytest.mark.parametrize("wn_impl", ["flow", "conv"])
def test_codes_made_once_a_call_and_taken_by_every_flow(model, monkeypatch,
                                                        wn_impl, quant):
    params, mel = model
    made, taken = [], []

    def quantize_cond(spect_grouped, q):
        out = quantize(spect_grouped, q)
        made.append(out[0])
        return out

    def cond_int8(codes, s_scale, pk, out_dtype):
        taken.append(codes)
        return project(codes, s_scale, pk, out_dtype)

    quantize, project = twg.quantize_cond, twg.cond_int8
    monkeypatch.setattr(twg, "quantize_cond", quantize_cond)
    monkeypatch.setattr(twg, "cond_int8", cond_int8)
    _infer(params, mel, wn_impl, quant, None)
    G = FRAMES * CFG.hop_length // CFG.n_group
    assert len(made) == 1 and len(taken) == CFG.n_flows
    assert made[0].shape == (B, G, CFG.n_mel_channels * CFG.n_group)
    assert made[0].is_contiguous()
    assert all(codes is made[0] for codes in taken)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("quant", ["column", "tensor"])
@pytest.mark.parametrize("wn_impl", ["flow", "conv"])
def test_int8_audio_equals_the_replaced_chain(model, monkeypatch, wn_impl,
                                              quant, dtype):
    params, mel = model
    got = _infer(params, mel, wn_impl, quant, dtype)
    monkeypatch.setattr(twg, "cond_int8", _parent_cond_int8)
    want = _infer(params, mel, wn_impl, quant, dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_tensor", [False, True])
def test_plain_is_the_exact_product_and_the_f32_chain(out_dtype, per_tensor):
    """At the vocoder's K = 640 with codes at +-127 (sums near 10^7): the
    plain version's product equals a float64 one, and its cond the f32
    chain over it; a row of zero codes gives the bias."""
    g = torch.Generator().manual_seed(5)
    K, N, G = 640, 48, 9
    codes = torch.randint(-127, 128, (2, G, K), generator=g).to(torch.int8)
    codes[0, 0] = 127
    codes[1, 3] = 0
    wq = torch.randint(-127, 128, (N, K), generator=g).to(torch.int8)
    wq[5] = 127
    pk = {"wq": wq, "w_scale": torch.rand((N,), generator=g) * 1e-2,
          "bias": torch.randn((N,), generator=g)}
    s = (torch.rand((), generator=g) if per_tensor
         else torch.rand((2, G), generator=g)) * 1e-2
    acc = ci8.int8_product(codes, wq)
    exact = torch.matmul(codes.double().reshape(-1, K), wq.double().T)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.reshape(-1, N).double(), exact)
    assert acc[0, 0, 5].item() == 127 * 127 * K
    got = ci8.cond_int8(codes, s, pk, out_dtype)
    assert torch.equal(got, ci8.dequantize(acc, s, pk, out_dtype))
    assert torch.equal(got, _parent_cond_int8(codes, s, pk, out_dtype))
    assert torch.equal(got[1, 3], pk["bias"].to(out_dtype))
