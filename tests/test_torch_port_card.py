"""The WN kernels (the layer kernel, the whole-net flow kernel) against
their plain PyTorch versions, on the card; and one tile's GEMM 1 of the
bf16 wgmma tile (its cp.async ring, weight image, swizzle and wgmma
descriptors) against torch.matmul, and the same for the f32 SIMT tile.
The clustered bf16 flow kernel also against the same arithmetic on the
layer kernel, bit for bit (torch.equal), at an odd tile count (a masked
partner tile), B = 1, ragged T, a dilation past T, n_half 4 / 3 / 2 and
the vocoder cell's 640-frame bucket.
At C = 256 bf16 runs both kernels on the wgmma tile (csrc/wn_wgmma.cuh)
and f32 on the SIMT tile (csrc/wn_simt.cuh); other widths on
wn_tile.cuh's.  Tolerances: f32 atol 1e-4 (TF32 off; the same arithmetic
summed in another order), bf16 3e-2 (x max(1, max|plain|) for a net).

Also the Tacotron2 decode's CUDA graphs (models/tacotron2.py::decode)
against the eager chunk loop, their plain version, on the same masks:
lengths and end steps exact, outputs within 1e-5.

And training: one Tacotron2 and one WaveGlow train step on the card
against the CPU (TF32 off; chip_smoke.py's phase 10 (a) at smaller
shapes), and the async checkpoint saver on CUDA tensors.

And the data tools: MfccTorch with TF32 forced on, DeviceFeaturizer
against the host path, the pickled-module WaveGlow written from card
tensors, and the mel dump CLI on the card against the CPU.

And the measurement tools: eval/rtf.py's `timed` against a CUDA-event
loop of the same calls (within 15 %), and eval/roofline.py's reader
finding both hand kernels in a real torch.profiler trace, with their
launch counts and floors.

And the WN int8 rungs' products: torch._int_mm at the rungs' shapes of
the vocoder CLI's batch (exact against a float64 product of the codes),
its shape guard, the tap products on the card against the CPU (the same
codes, within 1e-6 of the output's scale); and the grouped upsampler's
spect feeding both kernels, bit for bit equal to the two-step spect's.

And the int8 cond projection's kernel (ops/cond_int8.py) against its
plain version, bit for bit (torch.equal), at the vocoder cell's shortest
and longest buckets, a ragged single utterance, N = 4096 / 2048 / 1024
(whole, and a rank's rows under tensor parallelism), per-column and
per-tensor scales, bf16 and f32; its launch count per `waveglow_infer`
call and the shapes it refuses.

And several GPUs' collectives: a 1-rank NCCL group and 2 gloo ranks
sharing cuda:0 (NCCL refuses two ranks on one card), each collective the
port relies on and the global batch norm against one process's.

Needs CUDA and nvcc; skips without a card.  This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_card.py
"""

import numpy as np
import pytest
import torch

from fac_via_ppg_torch.ops import wn_flow as wf
from fac_via_ppg_torch.ops import wn_layer as wl


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(seed, B, T, C, last, dtype, device):
    rng = np.random.RandomState(seed)
    R = C if last else 2 * C

    def mk(shape, s):
        return torch.tensor(rng.randn(*shape) * s, dtype=dtype, device=device)

    return (mk((B, T, C), 0.3), mk((B, T, 2 * C), 0.3), mk((3 * C, 2 * C), 0.05),
            mk((2 * C,), 0.1), mk((C, R), 0.05), mk((R,), 0.1))


def _image(args):
    """The layer's weight image where the wgmma tile runs it (bf16 at
    C = 256), as pack_wn_layer stores it; else nothing."""
    x, w_in, w_rs = args[0], args[2], args[4]
    if x.dtype != torch.bfloat16 or x.shape[2] != wl.KERNEL_C:
        return {}
    img = wl.layer_images([w_in], [w_rs])
    return {"in_img": img["in_img"][0], "rs_img": img["rs_img"][0]}


def _layer_check(args, dilation, last, atol):
    """One counted launch of the layer kernel against wn_layer_plain."""
    n0 = wl.launches
    a_k, s_k = wl.wn_layer(*args, dilation=dilation, last=last,
                           **_image(args))
    torch.cuda.synchronize()
    assert wl.launches == n0 + 1
    a_p, s_p = wl.wn_layer_plain(*args, dilation=dilation, last=last)
    torch.testing.assert_close(s_k.float(), s_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(a_k.float(), a_p.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dilation,last", [(1, False), (2, False),
                                           (8, False), (128, False),
                                           (64, True)])
def test_kernel_matches_plain(card, dtype, atol, dilation, last):
    _layer_check(_layer(dilation, 2, 1000, 256, last, dtype, card), dilation,
                 last, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("last", [False, True])
def test_layer_kernel_bf16_one_batch_row(card, last):
    """B=1, T=1000: 16 tiles, fewer than the card's blocks."""
    _layer_check(_layer(3, 1, 1000, 256, last, torch.bfloat16, card), 8, last,
                 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("T", [97, 64 * 5 + 1])
def test_layer_kernel_bf16_ragged_time(card, T, last):
    """Ragged T: the tail tile's rows past T (zero taps and cond, masked
    stores), at a dilation that reaches past both ends."""
    _layer_check(_layer(T, 2, T, 256, last, torch.bfloat16, card), 64, last,
                 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 3, 7])
def test_layer_kernel_bf16_strided_cond(card, layer):
    """cond as the per-layer slice of the stacked (B, T, L*2C) projection,
    as wn_apply_layer passes it (time stride L*2C, offset 2C*layer)."""
    C, L, B, T = 256, 8, 2, 700
    args = list(_layer(layer, B, T, C, layer == L - 1, torch.bfloat16, card))
    cond_all = torch.tensor(np.random.RandomState(layer).randn(B, T, L * 2 * C)
                            * 0.3, dtype=torch.bfloat16, device=card)
    args[1] = cond_all[:, :, 2 * C * layer: 2 * C * (layer + 1)]
    assert not args[1].is_contiguous()
    _layer_check(tuple(args), 2 ** layer, layer == L - 1, 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 512])
def test_layer_kernel_bf16_other_widths(card, C):
    """bf16 at widths other than the wgmma tile's 256 runs wn_tile.cuh's
    tile (no image), within the same tolerance."""
    args = _layer(C, 2, 300, C, False, torch.bfloat16, card)
    assert _image(args) == {}
    _layer_check(args, 4, False, 3e-2)


@pytest.mark.cuda
def test_layer_kernel_bf16_needs_the_weight_image(card):
    """bf16 at C=256 without the weight image raises, and so does a cond
    whose time stride the kernel's 16-byte copies cannot take; nothing is
    launched."""
    args = _layer(5, 1, 128, 256, False, torch.bfloat16, card)
    n0 = wl.launches
    with pytest.raises(ValueError, match="weight image"):
        wl.wn_layer(*args, dilation=1)
    odd = torch.zeros((1, 128, 2 * 256 + 1), dtype=torch.bfloat16,
                      device=card)[:, :, :2 * 256]
    with pytest.raises(ValueError, match="strides"):
        wl.wn_layer(args[0], odd, *args[2:], dilation=1, **_image(args))
    assert wl.launches == n0


def _flow(seed, B, T, n_half, dtype, device, C=256, L=8):
    """A random flow pack (pack_wn_flow's layout, the last layer's
    residual columns zero, the bf16 kernel's weight image at its width),
    audio and cond."""
    rng = np.random.RandomState(seed)

    def mk(shape, s, dt=dtype):
        return torch.tensor(rng.randn(*shape) * s, dtype=dt, device=device)

    f32 = torch.float32
    packed = {"w_start": mk((n_half, C), 0.3), "b_start": mk((C,), 0.1, f32),
              "w_in": mk((L, 3 * C, 2 * C), 0.05),
              "b_in": mk((L, 2 * C), 0.1, f32),
              "w_rs": mk((L, C, 2 * C), 0.05),
              "b_rs": mk((L, 2 * C), 0.1, f32),
              "w_end": mk((C, 2 * n_half), 0.05),
              "b_end": mk((2 * n_half,), 0.1, f32)}
    packed["w_rs"][L - 1, :, :C] = 0
    packed["b_rs"][L - 1, :C] = 0
    if dtype == torch.bfloat16 and C == wf.KERNEL_C:
        packed.update(wf.weight_image(packed))
    return packed, mk((B, n_half, T), 1.0), mk((B, T, L * 2 * C), 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n_half", [4, 3, 2])
def test_flow_kernel_matches_plain(card, dtype, atol, n_half):
    """One launch per net; f32 within 1e-4, bf16 within 3e-2 x max(1,
    max|plain|) (8 layers of bf16 rounding in another order)."""
    got = _flow_check(*_flow(n_half, 2, 1000, n_half, dtype, card), atol)
    assert got.shape == (2, 2 * n_half, 1000)


def _flow_check(packed, audio, cond, atol):
    """One counted launch against wn_flow_plain, finite, within atol
    (bf16: atol x max(1, max|plain|)); returns the kernel's output."""
    n0 = wf.launches
    got = wf.wn_flow(packed, audio, cond)
    torch.cuda.synchronize()
    assert wf.launches == n0 + 1
    want = wf.wn_flow_plain(packed, audio, cond).float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = max(1.0, want.abs().max().item()) \
        if audio.dtype == torch.bfloat16 else 1.0
    torch.testing.assert_close(got.float(), want, atol=atol * scale, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("t0,dilation", [(0, 1), (448, 64), (960, 128)])
def test_flow_gemm1_tile_matches_matmul(card, t0, dilation):
    """GEMM 1 of one tile (taps of rows t0.., zero outside [0, T); the
    tile at t0=960 runs past T=1000) through the ring and wgmma, against
    the same bf16 data in f32 torch.matmul: only the summation order
    differs (atol 1e-3 on sums of magnitude ~1)."""
    rng = np.random.RandomState(dilation)
    T, C = 1000, 256
    x = torch.tensor(rng.randn(T, C) * 0.3, dtype=torch.bfloat16,
                     device=card)
    w_in = torch.tensor(rng.randn(3 * C, 2 * C) * 0.05,
                        dtype=torch.bfloat16, device=card)
    img = wf.weight_image({"w_in": w_in[None],
                           "w_rs": w_in.new_zeros((1, C, 2 * C))})["w_in_img"][0]
    got = wf.gemm1_tile(x, img, t0, dilation)
    torch.cuda.synchronize()
    rows = torch.arange(t0, t0 + 64, device=card)
    taps = []
    for j in range(3):
        t = rows + (j - 1) * dilation
        ok = (t >= 0) & (t < T)
        taps.append(torch.where(ok[:, None], x[t.clamp(0, T - 1)].float(),
                                0.0))
    want = torch.matmul(torch.cat(taps, 1), w_in.float())
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_half", [4, 2])
@pytest.mark.parametrize("T", [97, 64 * 5 + 1])
def test_flow_kernel_bf16_ragged_time(card, n_half, T):
    """Ragged T: the tail tile's rows past T (zero taps, cond and skip,
    masked stores)."""
    _flow_check(*_flow(T, 2, T, n_half, torch.bfloat16, card), 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
def test_flow_kernel_one_batch_row(card, dtype, atol):
    """B=1, T=1000: 16 tiles, fewer than the card's blocks."""
    _flow_check(*_flow(11, 1, 1000, 4, dtype, card), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 512])
def test_flow_kernel_bf16_other_widths(card, C):
    """bf16 at widths other than the wgmma tile's 256 (a WaveGlow config's
    n_channels) runs wn_tile.cuh's tile, within the same tolerance."""
    _flow_check(*_flow(C, 2, 300, 4, torch.bfloat16, card, C=C), 3e-2)


@pytest.mark.cuda
def test_flow_kernel_bf16_needs_the_weight_image(card):
    """A bf16 pack at C=256 without weight_image's arrays raises; nothing
    is launched."""
    packed, audio, cond = _flow(5, 1, 128, 4, torch.bfloat16, card)
    del packed["w_in_img"], packed["w_rs_img"]
    n0 = wf.launches
    with pytest.raises(ValueError, match="weight image"):
        wf.wn_flow(packed, audio, cond)
    assert wf.launches == n0


@pytest.mark.cuda
def test_flow_kernel_bf16_cond_strides(card):
    """A cond view whose strides and address the 16-byte copies can take
    runs and matches; a time stride that is not a multiple of 8, or an
    address off 16 bytes, raises as wn_layer does, with no copy and
    nothing launched."""
    packed, audio, cond = _flow(6, 2, 300, 4, torch.bfloat16, card)
    B, T, W = cond.shape
    wide = torch.zeros((B, T, W + 8), dtype=cond.dtype, device=card)
    wide[:, :, :W] = cond
    _flow_check(packed, audio, wide[:, :, :W], 3e-2)
    odd = torch.zeros((B, T, W + 1), dtype=cond.dtype, device=card)[:, :, :W]
    shifted = torch.zeros(B * T * W + 1, dtype=cond.dtype,
                          device=card)[1:].view(B, T, W)
    n0 = wf.launches
    for bad in (odd, shifted):
        with pytest.raises(ValueError, match="strides a multiple of 8"):
            wf.wn_flow(packed, audio, bad)
    assert wf.launches == n0


def _flow_exact(seed, B, T, n_half, device):
    """A random bf16 flow (as `_flow`) whose f32 biases hold bf16 values,
    so that the layer kernel, which takes its biases in bf16, adds the same
    numbers; drawn on the card (the cell's shape is large)."""
    g = torch.Generator(device).manual_seed(seed)
    C, L, bf = 256, 8, torch.bfloat16

    def mk(shape, s, dt=bf):
        return (torch.randn(shape, generator=g, device=device) * s).to(dt)

    packed = {"w_start": mk((n_half, C), 0.3),
              "b_start": mk((C,), 0.1).float(),
              "w_in": mk((L, 3 * C, 2 * C), 0.05),
              "b_in": mk((L, 2 * C), 0.1).float(),
              "w_rs": mk((L, C, 2 * C), 0.05),
              "b_rs": mk((L, 2 * C), 0.1).float(),
              "w_end": mk((C, 2 * n_half), 0.05),
              "b_end": mk((2 * n_half,), 0.1).float()}
    packed["w_rs"][L - 1, :, :C] = 0
    packed["b_rs"][L - 1, :C] = 0
    packed.update(wf.weight_image(packed))
    return packed, mk((B, n_half, T), 1.0), mk((B, T, L * 2 * C), 0.3)


def _flow_by_layers(packed, audio, cond):
    """The bf16 flow kernel's arithmetic, with each layer on the layer
    kernel (csrc/wn_layer.cu: the same wgmma tile, gate and epilogue, fed
    by its cp.async ring): the start conv as the flow kernel's FMA chain
    over n_half (a product of two bf16 is exact in f32, so each FMA is one
    rounded add), x and the skip sum rounded to bf16 after each layer, and
    the end conv as its warp sums it (8 channels in order a lane, then a
    butterfly over the 32 lanes).  The flow kernel's output, bit for bit."""
    f32, bf = torch.float32, torch.bfloat16
    B, n_half, T = audio.shape
    L, C, n_out = packed["b_in"].shape[0], packed["b_start"].shape[0], 2 * n_half
    acc = torch.zeros((B, T, C), dtype=f32, device=audio.device)
    for j in range(n_half):
        acc = acc + audio[:, j, :, None].float() * packed["w_start"][j].float()
    x = (acc + packed["b_start"]).to(bf)
    skip_sum = None
    for i in range(L):
        last = i == L - 1
        lo = C if last else 0
        b_in, b_rs = packed["b_in"][i].to(bf), packed["b_rs"][i][lo:].to(bf)
        assert torch.equal(b_in.float(), packed["b_in"][i])
        assert torch.equal(b_rs.float(), packed["b_rs"][i][lo:])
        x, skip = wl.wn_layer(
            x, cond[:, :, 2 * C * i: 2 * C * (i + 1)], packed["w_in"][i], b_in,
            packed["w_rs"][i][:, lo:].contiguous(), b_rs, dilation=2 ** i,
            last=last, in_img=packed["w_in_img"][i],
            rs_img=packed["w_rs_img"][i])
        skip_sum = skip if skip_sum is None else skip_sum + skip
    prod = (skip_sum.float().view(B, T, 32, 8, 1)
            * packed["w_end"].float().view(32, 8, n_out))
    part = torch.zeros((B, T, 32, n_out), dtype=f32, device=audio.device)
    for q in range(8):
        part = part + prod[:, :, :, q]
    lane = torch.arange(32, device=audio.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, :, lane ^ off]
    return (part[:, :, 0] + packed["b_end"]).to(bf).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,n_half", [
    (1, 64 * 5, 4),          # 5 tiles: the third cluster's second block masked
    (3, 64 * 89, 3),         # 267 tiles: two rounds of 132, a masked partner in the third
    (1, 1000, 4),            # B = 1: 16 tiles, fewer than the card's blocks
    (2, 97, 2),              # ragged T; layer 7's dilation (128) reaches past T
    (2, 64 * 5 + 1, 4),      # ragged T, an odd tile count
    (1, 50, 3),              # one tile: one cluster, its second block masked
    (2, 1000, 2),
    (24, 640 * 160 // 8, 4),  # vocoder-batch's 640-frame bucket
])
def test_flow_kernel_bf16_bit_equal_to_its_layers(card, B, T, n_half):
    """The clustered bf16 flow kernel against the same arithmetic on the
    layer kernel (`_flow_by_layers`): equal bit for bit (torch.equal), one
    launch counted, in clusters; and within the plain version's bound."""
    packed, audio, cond = _flow_exact(B * 7919 + T + n_half, B, T, n_half,
                                      card)
    n0, c0 = wf.launches, wf.cluster_launches
    got = wf.wn_flow(packed, audio, cond)
    torch.cuda.synchronize()
    assert (wf.launches, wf.cluster_launches) == (n0 + 1, c0 + 1)
    want = _flow_by_layers(packed, audio, cond)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    if B * T <= 4000:
        plain = wf.wn_flow_plain(packed, audio, cond).float()
        scale = max(1.0, plain.abs().max().item())
        torch.testing.assert_close(got.float(), plain, atol=3e-2 * scale,
                                   rtol=0)


@pytest.mark.cuda
def test_flow_kernel_bf16_resources(card):
    """The bf16 flow kernel: one block of 384 threads per SM, clusters of
    two, as many clusters at once as the card has TPCs; the f32 kernel's
    resources keep their form."""
    blocks, smem, size, active = wf.kernel_resources(torch.bfloat16)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert (blocks, size) == (1, wf.CLUSTER)
    assert 200_000 < smem <= 232_448
    assert 0 < active * size <= sms
    assert len(wf.kernel_resources(torch.float32)) == 2
    assert wf.cluster_size(torch.bfloat16, 256, card) == wf.CLUSTER


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["layer", "flow"])
def test_f32_kernels_at_the_synthesis_length(card, kernel):
    """f32 at B=2, T=20,000 (the synthesis CLI's 1000 frames): the flow
    kernel's persistent grid and ping-pong buffers, and the layer kernel
    at dilation 128, against their plain versions within 1e-4."""
    B, T, C, L = 2, 20000, 256, 8
    g = torch.Generator(card).manual_seed(20000)

    def mk(shape, s):
        return torch.randn(shape, generator=g, device=card) * s

    if kernel == "flow":
        packed, _, _ = _flow(7, 1, 1, 4, torch.float32, card)
        out = _flow_check(packed, mk((B, 4, T), 1.0),
                          mk((B, T, L * 2 * C), 0.3), 1e-4)
        assert out.shape == (B, 8, T)
        return
    args = (mk((B, T, C), 0.3), mk((B, T, 2 * C), 0.3),
            mk((3 * C, 2 * C), 0.05), mk((2 * C,), 0.1),
            mk((C, 2 * C), 0.05), mk((2 * C,), 0.1))
    _layer_check(args, 128, False, 1e-4)


# f32: the SIMT tile at C = 256 (the synthesis CLI's default path), the
# old tile at other widths; all within 1e-4 of the plain versions


@pytest.mark.cuda
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("T", [65, 97])
def test_layer_kernel_f32_ragged_time(card, T, last):
    """Ragged T: the tail tile's rows past T (zero taps, masked stores), at
    a dilation of 128, past both ends of the sequence."""
    _layer_check(_layer(T + 1, 2, T, 256, last, torch.float32, card), 128,
                 last, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("last", [False, True])
def test_layer_kernel_f32_one_batch_row(card, last):
    """B=1, T=1000: 16 tiles, fewer than the card's blocks."""
    _layer_check(_layer(4, 1, 1000, 256, last, torch.float32, card), 8, last,
                 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 3, 7])
def test_layer_kernel_f32_strided_cond(card, layer):
    """cond as the per-layer slice of the stacked (B, T, L*2C) projection,
    as wn_apply_layer passes it (time stride L*2C, offset 2C*layer)."""
    C, L, B, T = 256, 8, 2, 700
    args = list(_layer(layer + 20, B, T, C, layer == L - 1, torch.float32,
                       card))
    cond_all = torch.tensor(np.random.RandomState(layer).randn(B, T, L * 2 * C)
                            * 0.3, dtype=torch.float32, device=card)
    args[1] = cond_all[:, :, 2 * C * layer: 2 * C * (layer + 1)]
    assert not args[1].is_contiguous()
    _layer_check(tuple(args), 2 ** layer, layer == L - 1, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 512])
def test_layer_kernel_f32_other_widths(card, C):
    """f32 at widths other than the SIMT tile's 256 runs wn_tile.cuh's
    tile, within the same tolerance."""
    for last in (False, True):
        _layer_check(_layer(C + last, 2, 300, C, last, torch.float32, card),
                     4, last, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [65, 97])
def test_flow_kernel_f32_ragged_time(card, T):
    """Ragged T: the tail tile's rows past T, and dilations up to 128 >= T
    in the net's later layers."""
    _flow_check(*_flow(T + 1, 2, T, 4, torch.float32, card), 1e-4)


@pytest.mark.cuda
def test_flow_kernel_f32_strided_cond(card):
    """The net's (B, T, L*2C) cond as a view of a wider projection (time
    stride L*2C + 4), as a caller may slice it."""
    packed, audio, cond = _flow(12, 2, 300, 4, torch.float32, card)
    B, T, W = cond.shape
    wide = torch.zeros((B, T, W + 4), dtype=cond.dtype, device=card)
    wide[:, :, 4:] = cond
    view = wide[:, :, 4:]
    assert not view.is_contiguous()
    _flow_check(packed, audio, view, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 512])
def test_flow_kernel_f32_other_widths(card, C):
    """f32 at widths other than 256 runs wn_tile.cuh's tile."""
    _flow_check(*_flow(C + 1, 2, 300, 4, torch.float32, card, C=C), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("t0,dilation", [(0, 1), (448, 64), (960, 128)])
def test_flow_gemm1_tile_f32_matches_matmul(card, t0, dilation):
    """GEMM 1 of one tile of the f32 SIMT tile (its ring, the taps' zero
    fill, the thread ownership of rows and columns) against torch.matmul
    in f32, TF32 off: only the summation order differs (atol 1e-4)."""
    rng = np.random.RandomState(dilation + 1)
    T, C = 1000, 256
    x = torch.tensor(rng.randn(T, C) * 0.3, dtype=torch.float32, device=card)
    w_in = torch.tensor(rng.randn(3 * C, 2 * C) * 0.05, dtype=torch.float32,
                        device=card)
    got = wf.gemm1_tile(x, w_in, t0, dilation)
    torch.cuda.synchronize()
    rows = torch.arange(t0, t0 + 64, device=card)
    taps = []
    for j in range(3):
        t = rows + (j - 1) * dilation
        ok = (t >= 0) & (t < T)
        taps.append(torch.where(ok[:, None], x[t.clamp(0, T - 1)], 0.0))
    want = torch.matmul(torch.cat(taps, 1), w_in)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_f32_kernels_reject_cond_strides(card):
    """An f32 cond whose time stride is not a multiple of 4, or whose
    address is off 16 bytes, raises in both wrappers; nothing is
    launched."""
    args = _layer(6, 1, 128, 256, False, torch.float32, card)
    packed, audio, cond = _flow(6, 1, 128, 4, torch.float32, card)
    n_l, n_f = wl.launches, wf.launches
    for width, call in ((2 * 256, lambda c: wl.wn_layer(
            args[0], c, *args[2:], dilation=1)),
                        (cond.shape[2], lambda c: wf.wn_flow(packed, audio,
                                                             c))):
        odd = torch.zeros((1, 128, width + 1), device=card)[:, :, :width]
        shifted = torch.zeros(128 * width + 1, device=card)[1:].view(
            1, 128, width)
        for bad in (odd, shifted):
            with pytest.raises(ValueError, match="strides a multiple of 4"):
                call(bad)
    assert (wl.launches, wf.launches) == (n_l, n_f)


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("k", [1, 7, 32])
def test_decode_graph_matches_eager(card, monkeypatch, k, single):
    """Phase 9 (a) of chip_smoke.py, smaller (full-width Tacotron2, B=4,
    T_in=128, M=200): gate held off, then at a gate setting that stops the
    sequences apart, with the graph replayed at the new gate values."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.models import decode_graph
    from fac_via_ppg_torch.models import tacotron2 as tt

    monkeypatch.setattr(tt, "DECODE_CHUNK", k)
    B, T_in, M = (1 if single else 4), 128, 200
    cfg, params, state, ppg, lengths = smoke.decode_inputs(B, T_in, M, 5)
    n0 = decode_graph.replays
    held, _, logits = smoke.hold_decodes(tt, cfg, params, state, ppg,
                                         lengths, 6, single)
    assert held == [M] * B and decode_graph.replays > n0
    sign, th, expect = smoke.stop_gate(logits + 10.0, M, k)
    gate = params["decoder"]["gate_layer"]
    gate["weight"].mul_(sign * smoke.GATE_SCALE)
    gate["bias"].fill_(-th * smoke.GATE_SCALE)
    stops, _, _ = smoke.hold_decodes(tt, cfg, params, state, ppg, lengths, 6,
                                     single)
    assert stops == expect and max(stops) < M


@pytest.mark.cuda
def test_decode_graph_cache_is_keyed_and_bounded(card):
    """A graph is captured once per shape and weights, replayed after
    that, and the cache holds at most MAX_GRAPHS."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.models import decode_graph
    from fac_via_ppg_torch.models import tacotron2 as tt

    decode_graph.clear()
    cfg, params, state, ppg, lengths = smoke.decode_inputs(2, 64, 40, 7)
    n0 = decode_graph.captures
    for _ in range(2):
        tt.tacotron2_inference_batched(cfg, params, state, ppg, lengths,
                                       torch.Generator("cuda").manual_seed(0))
    assert decode_graph.captures == n0 + 1
    for T in range(64, 64 * (decode_graph.MAX_GRAPHS + 3), 64):
        x = torch.softmax(torch.randn((2, cfg.n_symbols, T), device=card),
                          dim=1)
        tt.tacotron2_inference_batched(cfg, params, state, x,
                                       torch.full((2,), T, device=card),
                                       torch.Generator("cuda").manual_seed(0))
    assert decode_graph.count() == decode_graph.MAX_GRAPHS
    assert decode_graph.captures == n0 + decode_graph.MAX_GRAPHS + 2


@pytest.mark.cuda
def test_tacotron2_train_step_card_matches_cpu(card):
    """One full-width Tacotron2 train step (B=2, T_in=T_out=32, every
    dropout mask injected) on the card against the CPU, TF32 off, held as
    chip_smoke.hold_step_against_cpu holds it: loss 1e-5 relative,
    gradients 1e-4 of each leaf's norm, params 1e-5 where the gradient's
    sign is determined."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.configs.hparams import Tacotron2Config
    from fac_via_ppg_torch.models import init_tacotron2
    from fac_via_ppg_torch.train.step import make_tacotron2_train_step

    cfg = Tacotron2Config()
    params, state = init_tacotron2(cfg, torch.Generator().manual_seed(3))
    batch = smoke.t2_train_batch(cfg, 2, 32, 32, 4)
    masks = smoke.t2_masks(cfg, 2, 32, 32, 5)
    smoke.hold_step_against_cpu(
        "tacotron2", lambda dev: smoke.one_step(
            make_tacotron2_train_step, cfg, params, batch, dev, 1e-4, state,
            masks), smoke.tree_paths(params), 1e-4,
        noise=("encoder/convolutions", "postnet/convolutions"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_waveglow_train_step_card_matches_cpu(card, dtype):
    """One WaveGlow train step at the full config on a 4000-sample
    segment, card against CPU: f32 as the Tacotron2 step; bf16 (the JAX
    package's policy on both devices) loss within 1e-2 relative."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models import init_waveglow
    from fac_via_ppg_torch.models.waveglow import weight_norm_params
    from fac_via_ppg_torch.train.step import make_waveglow_train_step

    cfg = WaveGlowConfig()
    g = torch.Generator().manual_seed(6)
    wg = init_waveglow(cfg, g)
    for wn in wg["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 1e-2
    wg = weight_norm_params(wg)
    rng = np.random.RandomState(7)
    batch = ((rng.randn(1, 80, 4000 // 160 + 1) - 4).astype(np.float32),
             (rng.randn(1, 4000) * 0.1).astype(np.float32))
    compute = None if dtype == "float32" else torch.bfloat16

    def run(dev):
        return smoke.one_step(
            lambda c, o: make_waveglow_train_step(c, o, 0.7071,
                                                  compute_dtype=compute),
            cfg, wg, batch, dev, 1e-4)

    if compute is None:
        smoke.hold_step_against_cpu("waveglow", run, smoke.tree_paths(wg),
                                    1e-4)
    else:
        card_loss, cpu_loss = run("cuda")[0], run("cpu")[0]
        assert np.isfinite(card_loss)
        assert abs(card_loss - cpu_loss) <= 1e-2 * abs(cpu_loss)


@pytest.mark.cuda
def test_async_saver_on_cuda_tensors(card, tmp_path):
    """The saver's snapshot is a copy on the card: an in-place update
    right after save() does not reach the file; the file holds CPU
    tensors that load back equal."""
    from fac_via_ppg_torch.train import checkpoint as ckpt
    from fac_via_ppg_torch.train.optim import make_optimizer

    params = {"w": torch.randn(256, 256, device=card),
              "layers": [{"b": torch.randn(256, device=card)}]}
    opt = make_optimizer(1e-3)
    opt_state = opt.init(params)
    opt.apply(opt_state, [torch.ones_like(params["w"]),
                          torch.ones_like(params["layers"][0]["b"])])
    want = params["w"].cpu()
    saver = ckpt.AsyncCheckpointSaver()
    saver.save(str(tmp_path / "c"), params, opt_state, 1e-3, 3)
    params["w"].add_(1.0)
    saver.wait()
    back = ckpt.load_checkpoint(str(tmp_path / "c"))
    assert back["params"]["w"].device.type == "cpu"
    assert torch.equal(back["params"]["w"], want)
    fresh = opt.init({"w": back["params"]["w"].to(card),
                      "layers": [{"b": back["params"]["layers"][0]["b"]
                                  .to(card)}]})
    fresh.load_state_dict(back["opt_state"])
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"].cpu(),
                       back["opt_state"]["state"][0]["exp_avg"])


def _mfcc_opts(mod):
    return mod.MfccOptions(frame_opts=mod.FrameExtractionOptions(
        snip_edges=False, allow_downsample=True, dither=0.0),
        use_energy=False)


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [16001, 40123])
def test_mfcc_torch_ignores_tf32(card, n_samples):
    """MfccTorch on the card with TF32 forced on for matmuls and cuDNN:
    within the f32 tolerance of the numpy MFCC (rtol 1e-3, atol 2e-2,
    tests/test_frontend.py's MfccJax bound), and within 1e-5 of the same
    run with TF32 off (its products are float64, which TF32 never
    reads)."""
    from fac_via_ppg_torch.frontend import mfcc as t_mfcc

    wav = np.random.RandomState(n_samples).randn(n_samples) * 3000
    m = t_mfcc.MfccTorch(_mfcc_opts(t_mfcc), device=card)
    off = m(wav)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        on = m(wav)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert on.device.type == "cuda" and on.dtype == torch.float32
    host = t_mfcc.compute_mfcc(wav, 16000, _mfcc_opts(t_mfcc),
                               backend="numpy")
    np.testing.assert_allclose(on.cpu().numpy(), host, rtol=1e-3, atol=2e-2)
    torch.testing.assert_close(on, off, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_device_featurizer_on_card_matches_host_path(card, tmp_path):
    """DeviceFeaturizer on the card against the host path (the MFCC on
    the host, the AM on the card) at a small substitute AM, dither 0:
    ragged lengths over two chunks, posteriors atol 1e-4, rows summing to
    1 within 1e-4; seeded dither reproducible on the card."""
    from fac_via_ppg_torch.frontend import ppg as t_ppg
    from fac_via_ppg_torch.scripts.make_substitute_am import make_bundle

    make_bundle(str(tmp_path), n_senones=96, n_phones=12, hidden_dim=64,
                num_layers=2)
    deps = t_ppg.DependenciesPPG(
        nnet_path=str(tmp_path / "am" / "final.raw.txt"),
        lda_path=str(tmp_path / "feats" / "final.mat"),
        reduce_dim_path=str(tmp_path / "feats" / "reduce_dim.mat"),
        splice_opts_path=str(tmp_path / "feats" / "splice_opts"))
    rng = np.random.RandomState(3)
    wavs = [rng.randn(int(16000 * s)) * 3000 for s in (1.3, 0.41, 2.07)]
    got = t_ppg.DeviceFeaturizer(deps, dither=0.0, device=card)(
        wavs, 16000, max_batch=2)
    for w, g in zip(wavs, got):
        want = t_ppg.compute_full_ppg_wrapper(w, 16000, deps.nnet, deps.lda,
                                              10, dither=0.0, device=card)
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(g.sum(axis=1), 1.0, atol=1e-4)
    dith = t_ppg.DeviceFeaturizer(deps, dither=1.0, device=card)
    a, b = dith(wavs, 16000, seed=4), dith(wavs, 16000, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("weight_norm", [True, False])
def test_pickled_module_waveglow_round_trip_from_card(card, tmp_path,
                                                      weight_norm):
    """save_reference_waveglow_checkpoint of params on the card: the file
    holds CPU tensors and loads back bit for bit."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models import init_waveglow
    from fac_via_ppg_torch.models.waveglow import weight_norm_params
    from fac_via_ppg_torch.train.export_torch import \
        save_reference_waveglow_checkpoint
    from fac_via_ppg_torch.train.import_torch import \
        load_reference_waveglow_checkpoint
    from fac_via_ppg_torch.utils.tree import tree_leaves
    from fac_via_ppg_torch.weights import move

    cfg = WaveGlowConfig()
    params = init_waveglow(cfg, torch.Generator().manual_seed(8))
    if weight_norm:
        params = weight_norm_params(params)
    on_card = move(params, card)
    path = str(tmp_path / "waveglow.pt")
    save_reference_waveglow_checkpoint(path, on_card, cfg)
    back = load_reference_waveglow_checkpoint(path, cfg)
    got, want = tree_leaves(back), tree_leaves(params)
    assert len(got) == len(want)
    assert any("g" in wn["start"] for wn in back["wn"]) == weight_norm
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert torch.equal(g, w.reshape(g.shape))


@pytest.mark.cuda
def test_mel2samp_dump_runs_on_the_card(card, tmp_path):
    """The mel dump CLI's default device is the card: its mels against
    device="cpu"'s, atol 1e-4 (log-mels, TF32 off)."""
    from scipy.io import wavfile

    from fac_via_ppg_torch.scripts import mel2samp_dump

    rng = np.random.RandomState(6)
    paths = []
    for i, n in enumerate([8000, 13001]):
        paths.append(str(tmp_path / f"a{i}.wav"))
        wavfile.write(paths[-1], 16000,
                      (rng.randn(n) * 3000).astype(np.int16))
    filelist = tmp_path / "files.txt"
    filelist.write_text("\n".join(paths) + "\n")
    on_card = mel2samp_dump.main(["-f", str(filelist), "-o",
                                  str(tmp_path / "card")])
    on_cpu = mel2samp_dump.main(["-f", str(filelist), "-o",
                                 str(tmp_path / "cpu")], device="cpu")
    for a, b in zip(on_card, on_cpu):
        got, want = np.load(a), np.load(b)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_timed_matches_a_cuda_event_loop(card):
    """eval/rtf.timed (each call's scalar read back) against CUDA events
    around the same calls, each also read back: within 15 %."""
    from fac_via_ppg_torch.eval.rtf import timed

    a = torch.randn(2048, 2048, device=card)

    def fn(x):
        return (x @ x).relu()

    s = timed(fn, a, warmup=2, iters=20)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        fn(a).sum().item()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    assert s * 1e3 == pytest.approx(ms, rel=0.15)


@pytest.mark.cuda
def test_roofline_reads_both_kernels_from_a_trace(card, tmp_path):
    """One tiny-batch WaveGlow at full width on the layer kernel, then on
    the flow kernel, under torch.profiler: the reader finds each kernel
    with its launches (the layer kernel's two instances 84 and 12, the
    last layer's apart; the flow kernel's 12) and the floors the count
    table gives."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.eval import roofline as rl
    from fac_via_ppg_torch.models.waveglow import (
        cast_params,
        init_waveglow,
        pack_waveglow_flow,
        pack_waveglow_layer,
        remove_weightnorm,
        waveglow_infer,
    )
    from fac_via_ppg_torch.weights import move

    cfg, B, F = WaveGlowConfig(), 2, 64
    params = cast_params(move(remove_weightnorm(init_waveglow(
        cfg, torch.Generator().manual_seed(0))), card), torch.bfloat16)
    mel = (torch.randn(B, 80, F, device=card) - 5).to(torch.bfloat16)
    packs = {"layer": pack_waveglow_layer(cfg, params),
             "flow": pack_waveglow_flow(cfg, params)}

    def run():
        with torch.no_grad():
            for impl, pack in packs.items():
                waveglow_infer(cfg, params, mel, 0.6, wn_impl=impl,
                               packed_wn=pack).float().sum().item()

    run()
    counts = {**rl.waveglow_counts(cfg, B, F, torch.bfloat16, "layer"),
              **rl.waveglow_counts(cfg, B, F, torch.bfloat16, "flow")}
    rows = rl.kernel_table(rl.capture(run, str(tmp_path / "t.json"),
                                      calls=2), calls=2, counts=counts)
    found = {k: [r for r in rows if k in r["name"]] for k in counts}
    for name, n in (("wn_layer_bf16_kernel<false>", 84),
                    ("wn_layer_bf16_kernel<true>", 12),
                    ("wn_flow_bf16_kernel", 12)):
        assert len(found[name]) == 1, (name, [r["name"] for r in rows])
        row = found[name][0]
        assert row["count"] == n and row["ms"] > 0
        floor = sum(rl.floor_ms(f, b, dt)[0] for f, b, dt in counts[name])
        assert row["floor_ms"] == pytest.approx(floor, rel=1e-12)
        assert 0 < row["pct_of_floor"] <= 100
    fams = rl.group_families(rows)
    assert fams["wn_layer (hand)"]["kernels"] == 96
    assert fams["wn_flow (hand)"]["kernels"] == 12


# ---------------------------------------------- WN int8 rungs, grouped spect

@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(256, 512), (768, 512), (256, 256)])
def test_wn_int8_int_mm_shapes(card, K, N):
    """_int8_matmul (torch._int_mm) at the rungs' shapes of the vocoder
    CLI's batch, M = 8 x 10240 rows: K = C (a tap, res_skip) or 3C (the
    stacked taps), N = 2C, or C (the last layer's res_skip); exact
    against the float64 product of the same codes (|sums| < 2^53)."""
    from fac_via_ppg_torch.models.waveglow import _int8_matmul

    g = torch.Generator("cuda").manual_seed(K + N)
    a = torch.randint(-127, 128, (8 * 10240, K), generator=g, device=card,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=g, device=card,
                      dtype=torch.int8)
    got = _int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (8 * 10240, N)
    assert torch.equal(got.double(), a.double() @ b.double())


@pytest.mark.cuda
def test_int8_matmul_names_a_shape_int_mm_refuses(card):
    from fac_via_ppg_torch.models.waveglow import _int8_matmul

    a = torch.zeros((16, 256), dtype=torch.int8, device=card)
    b = torch.zeros((256, 512), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="M=16, K=256, N=512"):
        _int8_matmul(a, b)
    with pytest.raises(ValueError, match="M=32, K=12, N=512"):
        _int8_matmul(torch.zeros((32, 12), dtype=torch.int8, device=card),
                     torch.zeros((12, 512), dtype=torch.int8, device=card))


# ----------------------------------------------- the int8 cond projection

HOP_GROUPS = 20          # grouped positions a mel frame: hop 160 / n_group 8


def _cond_inputs(B, frames, N, quant, seed, device):
    """The codes of a seeded grouped spect (B, 640, frames x 20), one
    position all zero (scale 1e-8 / 127, codes 0), and a seeded (N, 640)
    int8 pack with per-row scales and a bias, on the card."""
    from fac_via_ppg_torch.models.waveglow import _per_row_int8, quantize_cond

    g = torch.Generator(device).manual_seed(seed)
    G = frames * HOP_GROUPS
    spect = torch.randn((B, 640, G), generator=g, device=device) \
        * torch.linspace(0.1, 3.0, G, device=device)
    spect[0, :, G // 2] = 0.0
    codes, s = quantize_cond(spect, quant)
    wq, w_scale = _per_row_int8(
        torch.randn((N, 640), generator=g, device=device) * 0.05)
    bias = torch.randn((N,), generator=g, device=device) * 0.1
    return codes, s, {"wq": wq, "w_scale": w_scale, "bias": bias}


@pytest.mark.cuda
@pytest.mark.parametrize("B,frames,N,quant,dtype", [
    (24, 256, 4096, "column", torch.bfloat16),   # the cell's shortest bucket
    (24, 1024, 4096, "column", torch.bfloat16),  # and its longest
    (1, 37, 4096, "column", torch.bfloat16),     # ragged: M = 740
    (1, 37, 2048, "tensor", torch.float32),
    (1, 37, 1024, "column", torch.float32),
    (3, 50, 2048, "column", torch.bfloat16),
    (2, 64, 1024, "tensor", torch.bfloat16),
    (24, 256, 4096, "tensor", torch.float32),
])
def test_cond_int8_kernel_equals_plain(card, B, frames, N, quant, dtype):
    """One counted launch against cond_int8_plain (an exact float64
    product on the card, then the f32 chain) a batch row at a time, and
    the first row against the chain the kernel replaced (torch._int_mm,
    then the same f32 passes): torch.equal; the all-zero position gives
    the bias."""
    from fac_via_ppg_torch.ops import cond_int8 as ci8

    codes, s, pk = _cond_inputs(B, frames, N, quant, B * frames + N, card)
    G = frames * HOP_GROUPS
    n0 = ci8.launches
    got = ci8.cond_int8(codes, s, pk, dtype)
    torch.cuda.synchronize()
    assert ci8.launches == n0 + 1
    assert got.shape == (B, G, N) and got.dtype == dtype
    for b in range(B):
        sb = s if s.dim() == 0 else s[b:b + 1]
        want = ci8.cond_int8_plain(codes[b:b + 1], sb, pk, dtype)
        assert torch.equal(got[b:b + 1], want), f"batch row {b}"
    acc = torch._int_mm(codes[0], pk["wq"].T.contiguous())
    s0 = s if s.dim() == 0 else s[:1]
    assert torch.equal(got[:1], ci8.dequantize(acc[None], s0, pk, dtype))
    assert torch.equal(got[0, G // 2], pk["bias"].to(dtype))


@pytest.mark.cuda
def test_cond_int8_kernel_launches_once_a_flow(card, monkeypatch):
    """waveglow_infer(wn_impl="flow", cond_impl="int8") at the full
    WaveGlowConfig (B=2 x 128 frames, bf16): n_flows launches a call, and
    the audio equal to the same call on the plain projection."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.models import waveglow
    from fac_via_ppg_torch.models.waveglow import (
        cast_params,
        pack_waveglow_flow,
        pack_waveglow_int8cond,
        remove_weightnorm,
        waveglow_infer,
    )
    from fac_via_ppg_torch.ops import cond_int8 as ci8
    from fac_via_ppg_torch.weights import move

    cfg, params = smoke.waveglow_params(23)
    params = move(remove_weightnorm(params), card)
    packed_cond = pack_waveglow_int8cond(cfg, params)
    params = cast_params(params, torch.bfloat16)
    pack = pack_waveglow_flow(cfg, params)
    mel = (torch.randn((2, 80, 128), device=card) * 0.5 - 5).to(
        torch.bfloat16)
    outs, counts = [], []
    for project in (ci8.cond_int8, ci8.cond_int8_plain):
        monkeypatch.setattr(waveglow, "cond_int8", project)
        n0 = ci8.launches
        with torch.no_grad():
            outs.append(waveglow_infer(
                cfg, params, mel, 0.6,
                torch.Generator("cuda").manual_seed(3), wn_impl="flow",
                packed_wn=pack, cond_impl="int8", packed_cond=packed_cond))
        torch.cuda.synchronize()
        counts.append(ci8.launches - n0)
    assert counts == [cfg.n_flows, 0]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_serving_form_equals_the_hand_built_packs(card):
    """The vocoder CLI's serving form (models/waveglow.py::serving_form:
    bf16, the flow kernel, dense and int8 cond) against the benchmark's
    vocoder-batch cell, which casts and packs by hand and calls
    `waveglow_infer`, at the full WaveGlowConfig (B=2 x 128 frames): the
    same audio, bit for bit."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models.waveglow import (
        cast_params,
        init_waveglow,
        pack_waveglow_flow,
        pack_waveglow_int8cond,
        remove_weightnorm,
        serving_form,
        waveglow_infer,
        waveglow_serve,
    )
    from fac_via_ppg_torch.weights import move

    cfg = WaveGlowConfig()
    g = torch.Generator().manual_seed(29)
    params = init_waveglow(cfg, g)
    for wn in params["wn"]:
        wn["end"]["weight"] = torch.randn(wn["end"]["weight"].shape,
                                          generator=g) * 1e-2
    params = move(remove_weightnorm(params), card)
    mel = (torch.randn((2, 80, 128), device=card) * 0.5 - 5).to(
        torch.bfloat16)
    serve = cast_params(params, torch.bfloat16)
    pack = pack_waveglow_flow(cfg, serve)
    for cond_impl in ("dense", "int8"):
        form = serving_form(cfg, params, dtype=torch.bfloat16,
                            wn_impl="flow", cond_impl=cond_impl)
        packed_cond = (pack_waveglow_int8cond(cfg, params)
                       if cond_impl == "int8" else None)
        with torch.no_grad():
            want = waveglow_infer(
                cfg, serve, mel, 0.6, torch.Generator("cuda").manual_seed(5),
                wn_impl="flow", packed_wn=pack, cond_impl=cond_impl,
                packed_cond=packed_cond)
            got = waveglow_serve(form, mel, 0.6,
                                 torch.Generator("cuda").manual_seed(5))
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want), cond_impl


@pytest.mark.cuda
def test_cond_int8_kernel_names_a_shape_it_refuses(card):
    from fac_via_ppg_torch.ops import cond_int8 as ci8

    def pack(N, K):
        return {"wq": torch.zeros((N, K), dtype=torch.int8, device=card),
                "w_scale": torch.ones((N,), device=card),
                "bias": torch.zeros((N,), device=card)}

    s = torch.ones((), device=card)
    with pytest.raises(ValueError, match="M=40, K=632, N=4096"):
        ci8.cond_int8(torch.zeros((1, 40, 632), dtype=torch.int8,
                                  device=card), s, pack(4096, 632),
                      torch.bfloat16)
    with pytest.raises(ValueError, match="M=80, K=640, N=4092"):
        ci8.cond_int8(torch.zeros((2, 40, 640), dtype=torch.int8,
                                  device=card), s, pack(4092, 640),
                      torch.bfloat16)


def _wn8_layer(seed):
    """One full-width WN layer's int8 pack (C = 256) from seeded weights."""
    from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
    from fac_via_ppg_torch.models.waveglow import (
        init_waveglow,
        pack_waveglow_wn_int8,
    )

    cfg = WaveGlowConfig(n_flows=1)
    params = init_waveglow(cfg, torch.Generator().manual_seed(seed))
    return pack_waveglow_wn_int8(cfg, params)[0]


def _shifted(t, s):
    """t[..., g + s] at each g, zero outside: one tap of a dilated conv."""
    out, G = torch.zeros_like(t), t.shape[-1]
    if s >= 0:
        out[..., :G - s] = t[..., s:]
    else:
        out[..., -s:] = t[..., :G + s]
    return out


def _in_conv_reference(pk, xq, xs, dilation, quant):
    """The in_layer rung's output from given codes and scales, in float64
    on the CPU (the int sums are exact there): each tap's product through
    its shifted column scale, or one stacked product with the tensor
    scale; then the weight scale and the bias."""
    taps = [_shifted(xq.double(), (j - 1) * dilation) for j in range(3)]
    if quant == "tensor":
        acc = torch.einsum("oc,bcg->bog", pk["wq_stacked"].double(),
                           torch.cat(taps, dim=1))
        return acc * (xs.double() * pk["w_scale"].double())[:, None] \
            + pk["bias"].double()[:, None]
    acc = sum(torch.einsum("oc,bcg->bog", pk["wq"][j].double(), taps[j])
              * _shifted(xs.double(), (j - 1) * dilation)[:, None, :]
              for j in range(3))
    return acc * pk["w_scale"].double()[:, None] \
        + pk["bias"].double()[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["column", "tensor"])
@pytest.mark.parametrize("dilation", [1, 128])
def test_in_conv_int8_card_matches_cpu(card, quant, dilation):
    """The in_layer rung at C = 256 (B=2, G=2048) on the card against a
    float64 CPU product of the card's own codes and scales, within 1e-6
    of the output's scale (dilation 128 reads a sixteenth of G from the
    zero padding, where a column scale shifted one off shows).  Not
    against the CPU's quantizer: CUDA divides by the scalar 127 as a
    product with its reciprocal, so a scale may differ by one ulp and a
    code at a rounding boundary flip.  The res_skip rung (a product by
    127, no division) on the card against the CPU, first and last layer."""
    from fac_via_ppg_torch.models.waveglow import (
        _in_conv_int8,
        _rs_conv_int8,
        quantize_per_column_int8,
        quantize_per_tensor_int8,
    )
    from fac_via_ppg_torch.weights import move

    layers = _wn8_layer(dilation)
    x = torch.randn((2, 256, 2048), generator=torch.Generator().manual_seed(
        dilation)) * torch.linspace(0.1, 2.0, 2048)
    quantize = (quantize_per_column_int8 if quant == "column"
                else quantize_per_tensor_int8)
    xq, xs = quantize(x.to(card))
    got = _in_conv_int8(move(layers[0], card), x.to(card), dilation,
                        quant).cpu()
    want = _in_conv_reference(layers[0], xq.cpu(), xs.cpu(), dilation, quant)
    assert got.shape == want.shape == (2, 512, 2048)
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=1e-6 * want.abs().max().item())
    acts = torch.tanh(x)
    for i in (0, 7):
        got = _rs_conv_int8(move(layers[i], card), acts.to(card)).cpu()
        want = _rs_conv_int8(layers[i], acts)
        assert got.shape == (2, 512 if i < 7 else 256, 2048)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, "flow"),
                                        (torch.float32, "layer")])
def test_grouped_spect_feeds_both_kernels(card, dtype, impl, monkeypatch):
    """waveglow_infer at the full WaveGlowConfig (B=2 x 128 frames,
    seeded) on each kernel, on its grouped spect and on the two-step one
    (group_spect(upsample_phase_matmul(...)) swapped in): the kernel
    launched as often, the audio bit for bit equal."""
    import chip_smoke as smoke
    from fac_via_ppg_torch.models import waveglow
    from fac_via_ppg_torch.models.waveglow import (
        cast_params,
        group_spect,
        pack_waveglow_flow,
        pack_waveglow_layer,
        remove_weightnorm,
        upsample_phase_matmul,
        waveglow_infer,
    )
    from fac_via_ppg_torch.weights import move

    def two_step(p, spect, hop, n_group, t_samples=None):
        return group_spect(upsample_phase_matmul(p, spect, hop), n_group)

    cfg, params = smoke.waveglow_params(21)
    params = cast_params(move(remove_weightnorm(params), card), dtype)
    pack = (pack_waveglow_flow if impl == "flow"
            else pack_waveglow_layer)(cfg, params)
    mel = (torch.randn((2, 80, 128), device=card) * 0.5 - 5).to(dtype)
    mod = wf if impl == "flow" else wl
    outs, counts = [], []
    for upsampler in (waveglow.upsample_grouped, two_step):
        monkeypatch.setattr(waveglow, "upsample_grouped", upsampler)
        n0 = mod.launches
        with torch.no_grad():
            outs.append(waveglow_infer(
                cfg, params, mel, 0.6,
                torch.Generator("cuda").manual_seed(3), wn_impl=impl,
                packed_wn=pack))
        torch.cuda.synchronize()
        counts.append(mod.launches - n0)
    assert counts[0] == counts[1] == cfg.n_flows * (
        1 if impl == "flow" else cfg.wn_n_layers)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_collectives_on_the_card(card, tmp_path, backend, world):
    """The collectives the port relies on, on CUDA tensors: a 1-rank NCCL
    group on cuda:0, and 2 gloo ranks sharing cuda:0 (the backend asked
    for: NCCL refuses two ranks on one card); the global batch norm's
    forward, gradient and running variance against one process's on the
    concatenated batch."""
    from tests.torch_port_helpers import (
        check_collectives,
        rank_collectives,
        run_ranks,
    )

    res = run_ranks(world, tmp_path, rank_collectives, "cuda:0",
                    backend=backend, device="cuda:0")
    assert all(r["backend"] == backend and r["device"] == "cuda:0"
               for r in res)
    check_collectives(res, world)


@pytest.mark.cuda
def test_tp_collectives_on_a_one_rank_nccl_group(card, tmp_path):
    """copy_to_model, reduce_from_model and gather_from_model (parallel/
    tp.py) on CUDA tensors over a 1-rank NCCL model group: the identity,
    forward and backward, bit for bit, each collective issued and
    counted."""
    from tests.torch_port_helpers import rank_tp_identity, run_ranks

    (res,) = run_ranks(1, tmp_path, rank_tp_identity, backend="nccl",
                       device="cuda:0")
    assert res["backend"] == "nccl"
    for op in ("copy", "reduce", "gather"):
        assert res[op]["equal"], op
    assert res["counted"] == {"all_reduce": 2, "all_gather": 1,
                              "broadcast": 0}
