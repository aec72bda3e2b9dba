"""The port's whole-net WN flow (ops/wn_flow.py), its WaveGlow path
(`wn_impl="flow"`), the int8 cond projection and the int8 serving gate,
against the JAX package on the CPU.

At tests/test_wn_flow_pallas.py's config (C=64, L=4, 12 flows, so n_half
4/3/2).  On a CPU tensor `wn_flow` takes `wn_flow_plain`; the kernel itself
is held against it on the card by tests/test_torch_port_card.py.  The
bf16 kernel's weight image is checked here against the pack and the JAX
pack it comes from, exactly.
The f32 plain net is the card's yardstick for the f32 SIMT kernel
(64-row tiles), so it is also held against the Pallas kernel at that
tile's row edges: T in {1, 63, 65, 130} (at T = 1 every dilation after the
first is >= T), every net's last layer, B = 1 with a strided cond view:
there within atol 1e-5.
Tolerances: f32 atol 2e-5, rtol 2e-4 on one net and atol 2e-4, rtol 1e-3 on
the 12-flow audio (the JAX tests' own: the same arithmetic summed in
another order); bf16 against the JAX f32 result within
0.05 * max(1, max|want|) (test_wn_flow_pallas.py:130-137); int8 codes and
scales bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TWaveGlowConfig
from fac_via_ppg_torch.eval import int8_snr as t_snr
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.ops import wn_flow as twf
from fac_via_ppg_torch.ops import wn_image as wimg
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig
from fac_via_ppg_tpu.eval import int8_snr as j_snr
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.ops.initializers import conv1d_apply
from fac_via_ppg_tpu.ops.wn_flow_pallas import (
    flow_buf_geometry,
    pack_wn_flow,
    pad_time_for_flow,
    wn_flow_pallas,
)

CFG_KW = dict(n_mel_channels=16, n_flows=12, n_group=8, wn_n_layers=4,
              wn_n_channels=64, upsample_kernel_size=32)
CFG, TCFG = WaveGlowConfig(**CFG_KW), TWaveGlowConfig(**CFG_KW)
FLOW_OF_N_HALF = {4: 0, 3: 4, 2: 8}   # the first flow of each width


@pytest.fixture(scope="module")
def params():
    """JAX remove_weightnorm params with nonzero end convs (zero ones
    would make every comparison vacuous), and the port's copy."""
    p = jwg.remove_weightnorm(jwg.init_waveglow(jax.random.PRNGKey(0), CFG))
    rng = np.random.RandomState(1)
    for wn in p["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.1, jnp.float32)
    return p, weights.waveglow_from_jax(p)


def _flow_inputs(flow, B, T, seed):
    rng = np.random.RandomState(seed)
    n_half = twg.flow_channels(TCFG)[flow] // 2
    audio = rng.randn(B, n_half, T).astype(np.float32)
    spect = rng.randn(B, CFG.n_mel_channels * CFG.n_group,
                      T).astype(np.float32)
    return n_half, audio, spect


def _port_flow(tparams, flow, audio, spect, dtype=torch.float32):
    """wn_flow on the port's pack, cond projected channels-last."""
    pk = twg.pack_waveglow_flow(TCFG, tparams, dtype=dtype)[flow]
    spect_t = torch.from_numpy(spect)
    cond = (torch.matmul(spect_t.transpose(1, 2), pk["cond_w"].float())
            + pk["cond_b"]).to(dtype)
    return twf.wn_flow(pk, torch.from_numpy(audio).to(dtype), cond)


@pytest.mark.parametrize("n_half", sorted(FLOW_OF_N_HALF))
def test_wn_flow_plain_matches_jax_kernel(params, n_half):
    """Against the Pallas kernel in interpret mode, sliced to its valid
    rows and columns (its time and channel padding are TPU layout)."""
    jparams, tparams = params
    flow = FLOW_OF_N_HALF[n_half]
    _, audio, spect = _flow_inputs(flow, 1, 100, seed=flow)
    wn = jparams["wn"][flow]
    t_pad, halo, _ = flow_buf_geometry(100, 128, CFG.wn_n_layers)
    cond_w = jnp.concatenate([p["weight"] for p in wn["cond_layers"]], 0)
    cond_b = jnp.concatenate([p["bias"] for p in wn["cond_layers"]], 0)
    cond = conv1d_apply({"weight": cond_w, "bias": cond_b},
                        pad_time_for_flow(jnp.asarray(spect), t_pad, halo))
    want = wn_flow_pallas(pack_wn_flow(wn, CFG.wn_n_layers),
                          jnp.asarray(audio), cond, CFG.wn_n_layers, 100,
                          tile=128, interpret=True)[:, :2 * n_half, :100]
    got = _port_flow(tparams, flow, audio, spect)
    assert got.shape == (1, 2 * n_half, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


@pytest.mark.parametrize("B,T,n_half,strided", [
    (2, 1, 4, False), (2, 63, 3, False), (2, 65, 2, False), (2, 130, 4, False),
    (1, 65, 4, True), (1, 130, 3, True)])
def test_wn_flow_plain_matches_jax_kernel_at_tile_edges(params, B, T, n_half,
                                                        strided):
    """The f32 plain net (the card's yardstick) against the Pallas kernel
    in interpret mode where the kernel's 64-row tiles end; with `strided`,
    cond is a view of a wider projection (time stride L*2C + 8), as a
    caller may slice it.  Within atol 1e-5."""
    jparams, tparams = params
    flow = FLOW_OF_N_HALF[n_half]
    _, audio, spect = _flow_inputs(flow, B, T, seed=T + flow)
    wn = jparams["wn"][flow]
    t_pad, halo, _ = flow_buf_geometry(T, 128, CFG.wn_n_layers)
    cond_w = jnp.concatenate([p["weight"] for p in wn["cond_layers"]], 0)
    cond_b = jnp.concatenate([p["bias"] for p in wn["cond_layers"]], 0)
    cond = conv1d_apply({"weight": cond_w, "bias": cond_b},
                        pad_time_for_flow(jnp.asarray(spect), t_pad, halo))
    want = wn_flow_pallas(pack_wn_flow(wn, CFG.wn_n_layers),
                          jnp.asarray(audio), cond, CFG.wn_n_layers, T,
                          tile=128, interpret=True)[:, :2 * n_half, :T]
    pk = twg.pack_waveglow_flow(TCFG, tparams)[flow]
    t_cond = (torch.matmul(torch.from_numpy(spect).transpose(1, 2),
                           pk["cond_w"].float()) + pk["cond_b"])
    if strided:
        W = t_cond.shape[2]
        wide = torch.zeros((B, T, W + 8))
        wide[:, :, 8:] = t_cond
        t_cond = wide[:, :, 8:]
        assert not t_cond.is_contiguous()
    got = twf.wn_flow(pk, torch.from_numpy(audio), t_cond)
    assert got.shape == (B, 2 * n_half, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("n_half", sorted(FLOW_OF_N_HALF))
def test_wn_flow_plain_matches_jax_wn_apply(params, n_half):
    """Against the conv formulation at a ragged T=300: every layer's zero
    padding at both sequence edges, the last layer's skip-only projection
    and the heterogeneous flow widths."""
    jparams, tparams = params
    flow = FLOW_OF_N_HALF[n_half]
    _, audio, spect = _flow_inputs(flow, 2, 300, seed=10 + flow)
    want = jwg.wn_apply(CFG, jparams["wn"][flow], jnp.asarray(audio),
                        jnp.asarray(spect))
    got = _port_flow(tparams, flow, audio, spect)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


def test_wn_flow_plain_bf16_close_to_jax_f32(params):
    """bf16 weights, x, cond and skip sum with f32 accumulation and f32
    biases stay within bf16-scale error of the JAX f32 result."""
    jparams, tparams = params
    _, audio, spect = _flow_inputs(0, 1, 200, seed=3)
    want = np.asarray(jwg.wn_apply(CFG, jparams["wn"][0], jnp.asarray(audio),
                                   jnp.asarray(spect)))
    got = _port_flow(tparams, 0, audio, spect, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.max(np.abs(got.float().numpy() - want))
    assert err < 0.05 * max(np.max(np.abs(want)), 1.0), err


def test_wn_flow_cpu_takes_plain_and_counts_no_launch(params):
    _, tparams = params
    pk = twg.pack_waveglow_flow(TCFG, tparams)[0]
    audio = torch.randn(1, 4, 50, generator=torch.Generator().manual_seed(0))
    cond = torch.zeros(1, 50, CFG.wn_n_layers * 2 * CFG.wn_n_channels)
    n0, c0 = twf.launches, twf.cluster_launches
    out = twf.wn_flow(pk, audio, cond)
    assert (twf.launches, twf.cluster_launches) == (n0, c0)
    assert torch.equal(out, twf.wn_flow_plain(pk, audio, cond))
    with pytest.raises(ValueError, match="unsupported device"):
        twf.wn_flow(pk, audio.to("meta"), cond.to("meta"))


@pytest.mark.parametrize("dtype,C,device,want", [
    (torch.bfloat16, 256, "cuda", 2), (torch.bfloat16, 256, "cpu", 0),
    (torch.float32, 256, "cuda", 0), (torch.bfloat16, 128, "cuda", 0),
    (torch.bfloat16, 512, "cuda", 0)])
def test_cluster_size_names_the_clustered_kernel(dtype, C, device, want):
    """Only the bf16 kernel at C = 256 on the card runs in clusters (of
    CLUSTER blocks); the plain version, f32 and other widths in none."""
    assert twf.cluster_size(dtype, C, torch.device(device)) == want
    assert twf.CLUSTER == 2


def test_kernel_resources_reports_the_cluster(monkeypatch):
    """kernel_resources(bf16) adds the cluster size and the clusters the
    card holds at once to (blocks per SM, shared memory); f32 keeps its
    pair.  The C queries are stood in for (no card here)."""
    answers = {"wn_flow_bf16_occupancy": (1, 215_120),
               "wn_flow_bf16_clusters": (2, 66),
               "wn_flow_f32_occupancy": (1, 200_000)}
    monkeypatch.setattr(twf._LIB, "occupancy", answers.__getitem__)
    assert twf.kernel_resources(torch.bfloat16) == (1, 215_120, 2, 66)
    assert twf.kernel_resources() == (1, 215_120, 2, 66)
    assert twf.kernel_resources(torch.float32) == (1, 200_000)


def test_pack_wn_flow_places_the_last_layer_in_the_skip_columns(params):
    """The kernel's uniform layer loop: the last layer's (C, C) skip-only
    projection in columns [C, 2C), zero residual columns (as the TPU pack
    puts it in rows [C, 2C) of its transposed form)."""
    jparams, tparams = params
    C, L = CFG.wn_n_channels, CFG.wn_n_layers
    ours = twf.pack_wn_flow(tparams["wn"][5])
    theirs = pack_wn_flow(jparams["wn"][5], L)
    np.testing.assert_array_equal(
        ours["w_rs"].numpy(), np.asarray(theirs["w_rs"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(ours["b_rs"].numpy(),
                                  np.asarray(theirs["b_rs"]))
    assert not ours["w_rs"][L - 1, :, :C].any()
    n_half = ours["w_start"].shape[0]
    np.testing.assert_array_equal(
        ours["w_end"].numpy(), np.asarray(theirs["w_end"])[:2 * n_half].T)


@pytest.mark.parametrize("n_half", sorted(FLOW_OF_N_HALF))
def test_weight_image_inverts_to_the_jax_pack(params, n_half):
    """The bf16 kernel's weight image (per-warpgroup column order, K-major,
    swizzled) and its inverse are exact: the inverse gives back the pack's
    w_in and w_rs bit for bit, and those are the JAX pack's, in bf16."""
    jparams, tparams = params
    flow = FLOW_OF_N_HALF[n_half]
    C, L = CFG.wn_n_channels, CFG.wn_n_layers
    ours = twf.pack_wn_flow(tparams["wn"][flow], torch.bfloat16)
    img = twf.weight_image(ours)
    assert img["w_in_img"].shape == (L, 3 * C // twf.KC, 2 * C, twf.KC)
    assert img["w_rs_img"].shape == (L, C // twf.KC, 2 * C, twf.KC)
    back = wimg.public_from_image(img)
    assert torch.equal(back["w_in"], ours["w_in"])
    assert torch.equal(back["w_rs"], ours["w_rs"])
    theirs = pack_wn_flow(jparams["wn"][flow], L)
    w_in_jax = np.asarray(theirs["w_in"]).transpose(0, 1, 3, 2).reshape(
        L, 3 * C, 2 * C)
    assert torch.equal(back["w_in"],
                       torch.from_numpy(w_in_jax).to(torch.bfloat16))


def _as_kernel_reads(img_steps):
    """(steps, 2C, KC) image -> (steps * KC, 2C) B operand, element (n, k)
    of a step read at the byte the kernel's descriptors address: offset
    n * 2KC + 2k with its 16-byte chunk XORed by address bits 7.."""
    steps, n_rows, kc = img_steps.shape
    n = torch.arange(n_rows)[:, None]
    k = torch.arange(kc)[None, :]
    off = n * 2 * kc + 2 * k
    phys = off ^ (((off >> 7) & (2 * kc // 16 - 1)) << 4)
    flat = img_steps.reshape(steps, -1)
    return flat[:, phys // 2].transpose(1, 2).reshape(steps * kc, n_rows)


def test_weight_image_gemm1_deinterleaves_to_public_gemm1(params):
    """GEMM 1 on the image as the kernel reads it, de-interleaved by the
    warpgroups' column order, equals GEMM 1 on the public w_in (float64,
    exact on bf16 values); each warpgroup's sigmoid column sits C/2 image
    rows after its tanh partner (the same accumulator element of the
    other product), C columns apart in w_in."""
    _, tparams = params
    C = CFG.wn_n_channels
    pk = twf.pack_wn_flow(tparams["wn"][0], torch.bfloat16)
    img = twf.weight_image(pk)
    rng = np.random.RandomState(4)
    taps = torch.tensor(rng.randn(64, 3 * C)).to(torch.bfloat16).double()
    cols = wimg.gemm1_columns(C)
    for layer in range(CFG.wn_n_layers):
        z_img = taps @ _as_kernel_reads(img["w_in_img"][layer]).double()
        z = torch.empty_like(z_img)
        z[:, cols] = z_img
        assert torch.equal(z, taps @ pk["w_in"][layer].double())
        w_rs = _as_kernel_reads(img["w_rs_img"][layer])
        assert torch.equal(w_rs, pk["w_rs"][layer])
    for w in range(2):
        tanh_rows = torch.arange(w * C, w * C + C // 2)
        assert torch.equal(cols[tanh_rows + C // 2], cols[tanh_rows] + C)
        assert (cols[tanh_rows] < C).all()


def test_pack_wn_flow_holds_the_kernel_image_at_the_kernel_width():
    """A bf16 pack at C=256 carries weight_image's arrays, built once; an
    f32 pack, or a bf16 one at another width, carries none."""
    g = torch.Generator().manual_seed(0)
    L, n_half = 2, 4

    def wn(C):
        def conv(o, i, k=1):
            return {"weight": torch.randn(o, i, k, generator=g) * 0.05,
                    "bias": torch.randn(o, generator=g) * 0.1}
        return {"start": conv(C, n_half), "end": conv(2 * n_half, C),
                "in_layers": [conv(2 * C, C, 3) for _ in range(L)],
                "res_skip_layers": [conv(2 * C, C) for _ in range(L - 1)]
                + [conv(C, C)]}

    params = wn(twf.KERNEL_C)
    pk = twf.pack_wn_flow(params, torch.bfloat16)
    img = twf.weight_image(pk)
    for k in ("w_in_img", "w_rs_img"):
        assert torch.equal(pk[k], img[k])
    assert "w_in_img" not in twf.pack_wn_flow(params, torch.float32)
    assert "w_in_img" not in twf.pack_wn_flow(wn(64), torch.bfloat16)


def _noise(B, F, seed):
    return j_snr.matched_noise(CFG, B, F, seed)


def test_waveglow_infer_flow_matches_jax_flow_kernel(params):
    """All 12 flows on the flow path against the JAX package's flow path
    (the Pallas kernel in interpret mode), dense cond, f32."""
    jparams, tparams = params
    mel = (np.random.RandomState(42).randn(2, 16, 6) * 0.5 - 1.0).astype(
        np.float32)
    noise = _noise(2, 6, 5)
    want = jwg.waveglow_infer(CFG, jparams, jnp.asarray(mel), 0.7, None,
                              noise=noise, wn_impl="flow_interpret",
                              flow_tile=128)
    got = twg.waveglow_infer(TCFG, tparams, torch.from_numpy(mel), 0.7,
                             noise=noise, wn_impl="flow")
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("cond_impl,cond_quant", [("dense", "column"),
                                                  ("int8", "column"),
                                                  ("int8", "tensor")])
def test_waveglow_infer_flow_matches_jax_xla(params, cond_impl, cond_quant):
    """The flow path, dense and int8 cond (per-column and per-tensor
    activation scales), against the JAX conv formulation (wn_impl="xla"),
    f32, with injected noise."""
    jparams, tparams = params
    mel = (np.random.RandomState(7).randn(2, 16, 20) * 0.5 - 1.0).astype(
        np.float32)
    noise = _noise(2, 20, 6)
    want = jwg.waveglow_infer(CFG, jparams, jnp.asarray(mel), 0.7, None,
                              noise=noise, cond_impl=cond_impl,
                              cond_quant=cond_quant)
    packed = twg.pack_waveglow_flow(TCFG, tparams)
    got = twg.waveglow_infer(TCFG, tparams, torch.from_numpy(mel), 0.7,
                             noise=noise, wn_impl="flow", packed_wn=packed,
                             cond_impl=cond_impl, cond_quant=cond_quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


def test_int8_codes_scales_and_cond_match_jax(params):
    """Quantized codes and scales are bit-equal to the JAX package's, per
    column and per tensor; the dequantized projection agrees to f32
    rounding."""
    jparams, tparams = params
    x = (np.random.RandomState(5).randn(2, 128, 37) * 3).astype(np.float32)
    x[1, :, 4] = 0.0                      # an all-zero column: scale 1e-8
    for tq, jq in ((twg.quantize_per_column_int8,
                    jwg.quantize_per_column_int8),
                   (twg.quantize_per_tensor_int8,
                    jwg.quantize_per_tensor_int8)):
        (q_t, s_t), (q_j, s_j) = tq(torch.from_numpy(x)), jq(jnp.asarray(x))
        assert q_t.dtype == torch.int8
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    pk_t = twg.pack_waveglow_int8cond(TCFG, tparams)[3]
    pk_j = jwg.pack_waveglow_int8cond(CFG, jparams)[3]
    for k in ("wq", "w_scale", "bias"):
        np.testing.assert_array_equal(pk_t[k].numpy(), np.asarray(pk_j[k]))
    q_t, s_t = twg.quantize_per_column_int8(torch.from_numpy(x))
    q_j, s_j = jwg.quantize_per_column_int8(jnp.asarray(x))
    got = twg._cond_int8(q_t.transpose(1, 2).contiguous(), s_t, pk_t,
                         torch.float32)
    want = jwg._cond_all(CFG, None, None, (q_j, s_j, pk_j), jnp.float32)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_select_cond_impl_reaches_jax_decision(params):
    """The int8 gate on the flow path decides as the JAX package's gate
    does, at a budget every mode meets (0 dB) and one none meets
    (200 dB)."""
    jparams, tparams = params
    mel = (np.random.RandomState(9).randn(2, 16, 8) * 0.5 - 5.0).astype(
        np.float32)
    for budget, want in ((0.0, "int8"), (200.0, "dense")):
        impl_j, snr_j = j_snr.select_cond_impl(CFG, jparams, jnp.asarray(mel),
                                               budget)
        impl_t, snr_t = t_snr.select_cond_impl(
            TCFG, tparams, torch.from_numpy(mel), budget, wn_impl="flow")
        assert impl_t == impl_j == want, (snr_t, snr_j)
        assert 0.0 < snr_t < 200.0
