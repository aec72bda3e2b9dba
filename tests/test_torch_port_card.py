"""The WN kernels (the layer kernel, the whole-net flow kernel) against
their plain PyTorch versions, on the card; and one tile's GEMM 1 of the
bf16 wgmma tile (its cp.async ring, weight image, swizzle and wgmma
descriptors) against torch.matmul, and the same for the f32 SIMT tile.
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
