"""The port's WN layer (ops/wn_layer.py) against the JAX package's
wn_layer_reference and wn_layer_pallas (interpret mode), on the CPU.

On a CPU tensor the wrapper takes `wn_layer_plain`; the kernel itself is
held against it on the card by tests/test_torch_port_card.py.  The layer
pack's weight image for the bf16 wgmma tile (C = 256) is checked here
against the JAX package's Pallas pack, exactly.
The f32 plain version is the card's yardstick for the f32 SIMT kernel
(64-row tiles), so it is also held against the JAX package at that tile's
row edges: T in {1, 63, 65, 130}, dilations >= T, the last layer, B = 1
with a strided cond view.
Tolerance: atol 1e-5 in f32 (same arithmetic, different summation order);
bf16 WaveGlow against the JAX package's Pallas path within 2e-2 x max(1,
max|want|), ~2.5 bf16 ulps of the largest sample (both round to bf16 in
the same places, the sums in another order, through 2 flows).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWaveGlowConfig
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.ops import wn_image as wimg
from fac_via_ppg_torch.ops import wn_layer as wl
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.ops.wn_pallas import wn_layer_pallas, wn_layer_reference

B, T, C, TILE = 2, 64, 32, 32


def _layer(seed, last):
    rng = np.random.RandomState(seed)
    R = C if last else 2 * C

    def mk(shape, s):
        return (rng.randn(*shape) * s).astype(np.float32)

    return dict(x=mk((B, T, C), 0.3), cond=mk((B, T, 2 * C), 0.3),
                w_in=mk((3 * C, 2 * C), 0.1), b_in=mk((2 * C,), 0.1),
                w_rs=mk((C, R), 0.1), b_rs=mk((R,), 0.1))


@pytest.mark.parametrize("dilation,last", [(1, False), (4, False),
                                           (8, False), (8, True)])
def test_wn_layer_plain_matches_jax(dilation, last):
    arrs = _layer(dilation + 10 * last, last)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    a_port, s_port = wl.wn_layer(**t, dilation=dilation, last=last)
    for a_ref, s_ref in (
            wn_layer_reference(**j, dilation=dilation, last=last),
            wn_layer_pallas(**j, dilation=dilation, last=last, tile_t=TILE,
                            interpret=True)):
        np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(a_port.numpy(), np.asarray(a_ref),
                                   atol=1e-5, rtol=0)


# (B, T, dilation, last, tile_t of the Pallas kernel, strided cond): T at
# the 64-row tile's edges, dilations reaching past both ends (>= T), the
# last layer, B = 1 with cond a slice of the stacked projection
EDGES = [(2, 1, 1, False, 1, False), (2, 1, 8, True, 1, False),
         (2, 63, 64, False, 63, False), (2, 63, 2, True, 21, False),
         (2, 65, 128, False, 13, False), (2, 65, 16, True, 65, False),
         (2, 130, 8, False, 65, False), (2, 130, 128, True, 26, False),
         (1, 65, 4, False, 65, True), (1, 130, 64, True, 130, True)]


@pytest.mark.parametrize("B,T,dilation,last,tile_t,strided", EDGES)
def test_wn_layer_plain_matches_jax_at_tile_edges(B, T, dilation, last,
                                                  tile_t, strided):
    """The f32 plain layer (the card's yardstick) against
    wn_layer_reference and wn_layer_pallas(interpret=True) where the
    kernel's 64-row tiles end: within atol 1e-5."""
    rng = np.random.RandomState(1000 * T + dilation + 7 * last)
    R = C if last else 2 * C

    def mk(shape, s):
        return (rng.randn(*shape) * s).astype(np.float32)

    arrs = dict(x=mk((B, T, C), 0.3), cond=mk((B, T, 2 * C), 0.3),
                w_in=mk((3 * C, 2 * C), 0.1), b_in=mk((2 * C,), 0.1),
                w_rs=mk((C, R), 0.1), b_rs=mk((R,), 0.1))
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    if strided:
        # layer 1 of a 3-layer stacked (B, T, 3*2C) projection
        stacked = torch.from_numpy(mk((B, T, 3 * 2 * C), 0.3))
        stacked[:, :, 2 * C:4 * C] = t["cond"]
        t["cond"] = stacked[:, :, 2 * C:4 * C]
        assert not t["cond"].is_contiguous()
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    a_port, s_port = wl.wn_layer(**t, dilation=dilation, last=last)
    assert a_port.shape == (B, T, C) and s_port.shape == (B, T, C)
    for a_ref, s_ref in (
            wn_layer_reference(**j, dilation=dilation, last=last),
            wn_layer_pallas(**j, dilation=dilation, last=last, tile_t=tile_t,
                            interpret=True)):
        np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(a_port.numpy(), np.asarray(a_ref),
                                   atol=1e-5, rtol=0)


def test_wn_layer_cpu_takes_plain_and_counts_no_launch():
    t = {k: torch.from_numpy(v) for k, v in _layer(0, False).items()}
    n0 = wl.launches
    out = wl.wn_layer(**t, dilation=2)
    ref = wl.wn_layer_plain(**t, dilation=2)
    assert wl.launches == n0
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_wn_layer_bf16_plain_rounds_like_jax():
    """bf16 inputs: f32 accumulation, gate output rounded to bf16 before
    the second product (wn_pallas.py:78-80); agreement to bf16 rounding."""
    arrs = _layer(3, False)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrs.items()}
    a_port, s_port = wl.wn_layer(**t, dilation=4)
    a_ref, s_ref = wn_layer_reference(**j, dilation=4)
    np.testing.assert_allclose(s_port.float().numpy(),
                               np.asarray(s_ref, np.float32), atol=2e-2)
    np.testing.assert_allclose(a_port.float().numpy(),
                               np.asarray(a_ref, np.float32), atol=2e-2)


def test_wn_layer_rejects_other_devices():
    t = {k: torch.from_numpy(v).to("meta")
         for k, v in _layer(0, False).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        wl.wn_layer(**t, dilation=1)


# the wgmma tile's width; 8 layers for the pack, 2 for the WaveGlow run
WIDE = dict(n_mel_channels=16, hop_length=32, n_flows=2, n_group=8,
            n_early_every=4, n_early_size=2, wn_n_channels=wimg.KERNEL_C,
            wn_kernel_size=3, upsample_kernel_size=64)


def _wide_params(n_layers, seed=0):
    """JAX remove_weightnorm params at C = 256 with small nonzero end
    convs (zero ones would make the WaveGlow comparison vacuous), and the
    port's copy."""
    kw = dict(WIDE, wn_n_layers=n_layers)
    cfg = WaveGlowConfig(**kw)
    p = jwg.remove_weightnorm(jwg.init_waveglow(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for wn in p["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.02, jnp.float32)
    return cfg, TWaveGlowConfig(**kw), p, weights.waveglow_from_jax(p)


@pytest.fixture(scope="module")
def wide8():
    cfg, tcfg, jparams, tparams = _wide_params(8)
    ours = twg.pack_waveglow_layer(
        tcfg, twg.cast_params(tparams, torch.bfloat16))[0]
    return ours, jwg.pack_waveglow_pallas(cfg, jparams)[0]


@pytest.mark.parametrize("layer", range(8))
def test_layer_pack_image_inverts_to_the_jax_pallas_pack(wide8, layer):
    """The bf16 layer pack's in_img / rs_img (per-warpgroup column order,
    K-major, swizzled) go back through public_from_image to the JAX
    package's Pallas weights in bf16, bit for bit; the last layer's (C, C)
    projection sits in the skip columns [C, 2C) over zero residual
    columns."""
    ours, theirs = wide8
    C, L = wimg.KERNEL_C, 8
    assert ours["in_img"].shape == (L, 3 * C // wimg.KC, 2 * C, wimg.KC)
    assert ours["rs_img"].shape == (L, C // wimg.KC, 2 * C, wimg.KC)
    back = wimg.public_from_image(
        {"w_in_img": ours["in_img"][layer:layer + 1],
         "w_rs_img": ours["rs_img"][layer:layer + 1]})

    def bf16(a):
        return torch.from_numpy(np.array(a)).to(torch.bfloat16)

    assert torch.equal(back["w_in"][0], bf16(theirs["in_w"][layer]))
    assert torch.equal(back["w_in"][0], ours["in_w"][layer])
    rs = back["w_rs"][0]
    if layer == L - 1:
        assert not rs[:, :C].any()
        rs = rs[:, C:]
    assert torch.equal(rs, bf16(theirs["rs_w"][layer]))


def test_waveglow_layer_path_with_the_image_matches_jax_pallas():
    """waveglow_infer(wn_impl="layer") in bf16 on a pack that holds the
    kernel's image (C = 256, L = 2, 2 flows, 6 frames) against the JAX
    package's wn_impl="pallas_interpret" in bf16."""
    cfg, tcfg, jparams, tparams = _wide_params(2, seed=1)
    rng = np.random.RandomState(3)
    F = 6
    mel = (rng.randn(2, cfg.n_mel_channels, F) * 0.5 - 1.0).astype(np.float32)
    G = F * cfg.hop_length // cfg.n_group
    chans = jwg.flow_channels(cfg)
    noise = [rng.randn(2, chans[-1], G).astype(np.float32)]
    want = np.asarray(jwg.waveglow_infer(
        cfg, jparams, jnp.asarray(mel), 0.6, None, dtype=jnp.bfloat16,
        noise=noise, wn_impl="pallas_interpret"), np.float32)
    pack = twg.pack_waveglow_layer(
        tcfg, twg.cast_params(tparams, torch.bfloat16))
    assert all("in_img" in pk for pk in pack)
    got = twg.waveglow_infer(tcfg, tparams, torch.from_numpy(mel), 0.6,
                             dtype=torch.bfloat16, noise=noise,
                             wn_impl="layer", packed_wn=pack)
    assert got.shape == want.shape
    tol = 2e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,C,has_image", [
    (torch.bfloat16, wimg.KERNEL_C, True), (torch.float32, wimg.KERNEL_C, False),
    (torch.bfloat16, 128, False)])
def test_pack_waveglow_layer_holds_the_image_only_for_bf16_at_256(
        dtype, C, has_image):
    """Only a bf16 pack at the wgmma tile's width carries in_img / rs_img
    (f32 and other widths run wn_tile.cuh's tile, which takes none)."""
    g = torch.Generator().manual_seed(C)
    tcfg = TWaveGlowConfig(**dict(WIDE, wn_n_channels=C, wn_n_layers=2,
                                  n_flows=1))
    params = twg.cast_params(twg.init_waveglow(tcfg, g), dtype)
    pk = twg.pack_waveglow_layer(tcfg, params)[0]
    assert ("in_img" in pk) == has_image and ("rs_img" in pk) == has_image
    if has_image:
        want = wl.layer_images(pk["in_w"], pk["rs_w"])
        assert torch.equal(pk["in_img"], want["in_img"])
        assert torch.equal(pk["rs_img"], want["rs_img"])


def test_wn_layer_cpu_with_the_image_takes_plain():
    """On the CPU the image is not read: bf16 at C = 256 takes
    wn_layer_plain and counts no launch."""
    rng = np.random.RandomState(5)
    C, T = wimg.KERNEL_C, 40

    def mk(shape, s):
        return torch.tensor(rng.randn(*shape) * s, dtype=torch.bfloat16)

    args = (mk((1, T, C), 0.3), mk((1, T, 2 * C), 0.3),
            mk((3 * C, 2 * C), 0.05), mk((2 * C,), 0.1),
            mk((C, 2 * C), 0.05), mk((2 * C,), 0.1))
    img = wl.layer_images([args[2]], [args[4]])
    n0 = wl.launches
    out = wl.wn_layer(*args, dilation=4, in_img=img["in_img"][0],
                      rs_img=img["rs_img"][0])
    assert wl.launches == n0
    for o, r in zip(out, wl.wn_layer_plain(*args, dilation=4)):
        assert torch.equal(o, r)
