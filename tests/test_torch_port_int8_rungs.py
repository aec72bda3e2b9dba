"""The port's grouped upsampler and WN int8 rungs against the JAX package,
on the CPU at tiny widths (3 flows x 4 layers, C = 16; 2 x 2 x 16 where
a train step or a CLI runs).

Inputs, weights and noise come from numpy with a seed and go through both
packages.  Tolerances, and why:
  * the grouped spect: the two-step spect, group_spect(
    upsample_phase_matmul(...)), bit for bit (the same matmul output in
    another layout, and the same strides), and the programs that read it
    (`two_step_upsampler` swaps it in); the JAX package's within 1e-5
    (f32, another summation order);
  * int8 codes equal, their f32 scales within 1e-6 relative (XLA may
    divide by 127 as a product with its reciprocal);
  * `_in_conv_int8` / `_rs_conv_int8` on the same inputs (so the same
    codes; the int32 sums are exact) within 1e-6 of the output's scale;
  * whole programs in f32 within 1e-5 (f32 sums in another order, no int8
    code flips at these sizes); in bf16 by SNR against JAX's bf16 output,
    > 35 dB (bf16's rounding floor, ~45 dB here);
  * train forwards and steps as tests/test_torch_port_train.py holds
    them: outputs 1e-5, loss 1e-5 relative;
  * the vocoder CLI's wavs within 1 int16 step of the JAX CLI's.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from fac_via_ppg_torch import weights
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig as TConfig
from fac_via_ppg_torch.models import waveglow as twg
from fac_via_ppg_torch.scripts import waveglow_inference as t_cli
from fac_via_ppg_torch.train import losses as t_losses
from fac_via_ppg_torch.train import optim as t_optim
from fac_via_ppg_torch.train import step as t_step
from fac_via_ppg_tpu.configs.hparams import WaveGlowConfig as JConfig
from fac_via_ppg_tpu.eval.int8_snr import matched_noise
from fac_via_ppg_tpu.models import waveglow as jwg
from fac_via_ppg_tpu.scripts import waveglow_inference as j_cli
from fac_via_ppg_tpu.train import losses as j_losses
from fac_via_ppg_tpu.train import optim as j_optim
from fac_via_ppg_tpu.train import step as j_step
from fac_via_ppg_tpu.train.checkpoint import save_checkpoint
from fac_via_ppg_tpu.train.export_torch import (
    save_reference_waveglow_checkpoint,
)
from tests.test_torch_port_vocoder_cli import CFG as CLI_CFG
from tests.test_torch_port_vocoder_cli import TINY as CLI_TINY
from tests.test_torch_port_vocoder_cli import _corpus, _train_params

WG = dict(n_mel_channels=16, hop_length=32, n_flows=3, n_group=8,
          n_early_every=2, n_early_size=2, wn_n_layers=4, wn_n_channels=16,
          wn_kernel_size=3, upsample_kernel_size=256)
J_WG, T_WG = JConfig(**WG), TConfig(**WG)
RUNGS = {
    "wn3": dict(wn_int8_flows=3),
    "wn3t": dict(wn_int8_flows=3, wn_int8_quant="tensor"),
    "rs3": dict(wn_int8_rs_flows=3),
    "wn2_rs1": dict(wn_int8_flows=2, wn_int8_rs_flows=1),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small ops: the suite runs several
    workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wg():
    """(JAX train form, JAX serving form, the port's serving form, mel):
    nonzero end convs, so that every coupling reaches the audio."""
    train = jwg.init_waveglow(jax.random.PRNGKey(0), J_WG)
    rng = np.random.RandomState(0)
    for wn in train["wn"]:
        for leaf in ("weight", "bias"):
            wn["end"][leaf] = jnp.asarray(
                rng.randn(*np.shape(wn["end"][leaf])) * 0.1, jnp.float32)
    mel = (rng.randn(2, 16, 12) * 0.6 - 4.0).astype(np.float32)
    return (train, jwg.remove_weightnorm(train),
            twg.remove_weightnorm(weights.waveglow_from_jax(train)), mel)


# ------------------------------------------------------- grouped upsampler

def two_step(p, spect, hop, n_group, t_samples=None):
    """The grouped spect the long way: the (B, C, F*hop) upsampled spect,
    then group_spect; the reference the port's upsample_grouped is held
    to."""
    up = twg.upsample_phase_matmul(p, spect, hop)
    if t_samples is not None:
        up = up[:, :, :t_samples]
    return twg.group_spect(up, n_group)


@contextlib.contextmanager
def two_step_upsampler():
    """Runs waveglow_forward / waveglow_infer on the two-step spect."""
    mp = pytest.MonkeyPatch()
    mp.setattr(twg, "upsample_grouped", two_step)
    try:
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("t_samples", [None, 12 * 32 - 37])
def test_upsample_grouped_matches_jax(wg, t_samples):
    _, jp, tp, mel = wg
    want = jwg.upsample_grouped(jp["upsample"], jnp.asarray(mel), 32, 8,
                                t_samples=t_samples)
    got = twg.upsample_grouped(tp["upsample"], torch.from_numpy(mel), 32, 8,
                               t_samples=t_samples)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_samples", [None, 12 * 32 - 37])
def test_upsample_grouped_is_the_two_step_spect(wg, dtype, t_samples):
    """Bit for bit, in the same strides: the grouped layout and the
    sample map t = f*hop + q*n_group + n -> [m*n_group + n, f*hop/n_group
    + q] of group_spect(upsample_phase_matmul(...))."""
    _, _, tp, mel = wg
    up = {k: v.to(dtype) for k, v in tp["upsample"].items()}
    spect = torch.from_numpy(mel).to(dtype)
    two = two_step(up, spect, 32, 8, t_samples)
    got = twg.upsample_grouped(up, spect, 32, 8, t_samples=t_samples)
    assert got.dtype == dtype and torch.equal(got, two)
    assert got.stride() == two.stride()


@pytest.mark.parametrize("t_samples", [None, 12 * 36 - 37])
def test_upsample_grouped_any_hop_is_the_two_step_spect(wg, t_samples):
    """hop 36, not a multiple of n_group 8: JAX's upsample_grouped raises,
    the port's (the only path its forward and inference have) splits the
    flat sample axis and still gives the two-step spect bit for bit."""
    _, jp, tp, mel = wg
    with pytest.raises(ValueError, match="hop 36 not a multiple of "
                                         "n_group 8"):
        jwg.upsample_grouped(jp["upsample"], jnp.asarray(mel), 36, 8)
    spect = torch.from_numpy(mel)
    got = twg.upsample_grouped(tp["upsample"], spect, 36, 8,
                               t_samples=t_samples)
    two = two_step(tp["upsample"], spect, 36, 8, t_samples)
    assert got.shape == (2, 16 * 8, (t_samples or 12 * 36) // 8)
    assert torch.equal(got, two) and got.stride() == two.stride()


@pytest.mark.parametrize("grouped", [False, True])
def test_waveglow_forward_grouped_matches_jax(wg, grouped):
    """The training forward and its loss against the JAX package's, with
    and without its grouped_upsample; the port's outputs equal bit for bit
    the same forward on the two-step spect."""
    train, _, _, mel = wg
    audio = (np.random.RandomState(5).randn(2, 12 * 32 - 37) * 0.2).astype(
        np.float32)
    j_out = jwg.waveglow_forward(J_WG, train, jnp.asarray(mel),
                                 jnp.asarray(audio),
                                 grouped_upsample=grouped)
    tp = weights.waveglow_train_from_jax(train)
    with torch.no_grad():
        t_out = twg.waveglow_forward(T_WG, tp, torch.from_numpy(mel),
                                     torch.from_numpy(audio))
        with two_step_upsampler():
            plain = twg.waveglow_forward(T_WG, tp, torch.from_numpy(mel),
                                         torch.from_numpy(audio))
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]),
                               atol=1e-5, rtol=0)
    for a, b in zip(t_out[1], j_out[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(
        float(t_losses.waveglow_loss(t_out, sigma=0.7)),
        float(j_losses.waveglow_loss(j_out, sigma=0.7)), rtol=1e-5)
    assert torch.equal(t_out[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(t_out[1], plain[1]))


def test_waveglow_train_step_grouped_matches_jax():
    """make_waveglow_train_step, one Adam step, against the JAX step with
    grouped_upsample=True (loss within 1e-5 relative, params within 1e-5),
    and against itself on the two-step spect (loss and params equal)."""
    cfg = dict(WG, n_flows=2, wn_n_layers=2)
    j_cfg, t_cfg = JConfig(**cfg), TConfig(**cfg)
    train = jwg.init_waveglow(jax.random.PRNGKey(2), j_cfg)
    rng = np.random.RandomState(9)
    for wn in train["wn"]:
        wn["end"]["weight"] = jnp.asarray(
            rng.randn(*wn["end"]["weight"].shape).astype(np.float32) * 0.05)
    mel = (rng.randn(4, 16, 12) * 0.5).astype(np.float32)
    audio = (rng.randn(4, 12 * 32) * 0.2).astype(np.float32)
    j_opt = j_optim.make_optimizer(1e-3)
    j_out = j_step.make_waveglow_train_step(
        j_cfg, j_opt, 0.7, donate=False, grouped_upsample=True)(
        train, j_opt.init(train), (jnp.asarray(mel), jnp.asarray(audio)))
    outs = []
    for upsampler in (contextlib.nullcontext, two_step_upsampler):
        tp = weights.waveglow_train_from_jax(train)
        opt = t_optim.make_optimizer(1e-3)
        with upsampler():
            outs.append(t_step.make_waveglow_train_step(t_cfg, opt, 0.7)(
                tp, opt.init(tp),
                (torch.from_numpy(mel), torch.from_numpy(audio))))
    np.testing.assert_allclose(float(outs[0].loss), float(j_out.loss),
                               rtol=1e-5)
    want = jax.tree_util.tree_leaves(j_out.params)
    got = _leaves(outs[0].params)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-5, rtol=0)
    assert float(outs[0].loss) == float(outs[1].loss)
    # The upsampler's own gradients are sums over the spect's gradient,
    # which the two layouts hand back in other strides, so in another
    # order: its update may differ in the last bits (2.3e-10 seen).
    ups = [o.params.pop("upsample") for o in outs]
    for a, b in zip(_leaves(ups[0]), _leaves(ups[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-8)
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(outs[0].params), _leaves(outs[1].params)))


def _leaves(tree):
    """The tensors of a params tree in jax.tree_util's order (sorted dict
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------- WN int8 rungs

def test_pack_waveglow_wn_int8_matches_jax(wg):
    _, jp, tp, _ = wg
    want = jwg.pack_waveglow_wn_int8(J_WG, jp)
    got = twg.pack_waveglow_wn_int8(T_WG, tp)
    assert len(got) == len(want) == 3
    for j_flow, t_flow in zip(want, got):
        assert len(t_flow) == len(j_flow) == 4
        for j_layer, t_layer in zip(j_flow, t_flow):
            assert set(t_layer) == set(j_layer)
            for k, w in j_layer.items():
                w, t = np.asarray(w), t_layer[k].numpy()
                assert t.shape == w.shape and t.dtype == w.dtype, k
                if w.dtype == np.int8:
                    np.testing.assert_array_equal(t, w, err_msg=k)
                else:
                    np.testing.assert_allclose(t, w, rtol=1e-6, atol=0,
                                               err_msg=k)


def _same_codes(x, quant):
    """The port's and JAX's activation codes of x, equal."""
    fn = "quantize_per_column_int8" if quant == "column" else \
        "quantize_per_tensor_int8"
    jq, js = getattr(jwg, fn)(jnp.asarray(x))
    tq, ts = getattr(twg, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("quant", ["column", "tensor"])
@pytest.mark.parametrize("dilation", [1, 8])
def test_in_conv_int8_matches_jax(wg, quant, dilation):
    """On the same codes; dilation 8 takes half of G = 48 from the zero
    padding, where a shifted column scale that is one off shows."""
    _, jp, tp, _ = wg
    x = (np.random.RandomState(dilation).randn(2, 16, 48)
         * np.linspace(0.1, 2.0, 48)).astype(np.float32)
    _same_codes(x, quant)
    jpk = jwg.pack_waveglow_wn_int8(J_WG, jp)[1][2]
    tpk = twg.pack_waveglow_wn_int8(T_WG, tp)[1][2]
    want = np.asarray(jwg._in_conv_int8(jpk, jnp.asarray(x), dilation,
                                        quant))
    got = twg._in_conv_int8(tpk, torch.from_numpy(x), dilation, quant)
    assert got.shape == want.shape == (2, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("last", [False, True])
def test_rs_conv_int8_matches_jax(wg, last):
    _, jp, tp, _ = wg
    layer = 3 if last else 0
    acts = np.tanh(np.random.RandomState(7).randn(2, 16, 40) * 2.0).astype(
        np.float32)
    jpk = jwg.pack_waveglow_wn_int8(J_WG, jp)[0][layer]
    tpk = twg.pack_waveglow_wn_int8(T_WG, tp)[0][layer]
    want = np.asarray(jwg._rs_conv_int8(jpk, jnp.asarray(acts)))
    got = twg._rs_conv_int8(tpk, torch.from_numpy(acts))
    assert got.shape == want.shape == (2, 16 if last else 32, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _snr_db(ref, got):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((got - ref) ** 2),
                                                1e-30))


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_waveglow_infer_rungs_match_jax(wg, rung, dtype):
    """waveglow_infer with each rung and int8 cond, on the JAX package's
    matched noise, against its waveglow_infer on its xla path: f32 within
    1e-5, bf16 above 35 dB of SNR against JAX's bf16 audio.  The rung
    differs from the dense program (it quantizes)."""
    _, jp, tp, mel = wg
    kw = RUNGS[rung]
    noise = matched_noise(J_WG, 2, 12, 3)
    j_dt = None if dtype == "float32" else jnp.bfloat16
    t_dt = None if dtype == "float32" else torch.bfloat16
    want = np.asarray(jwg.waveglow_infer(
        J_WG, jp, jnp.asarray(mel), 0.6, None, dtype=j_dt, noise=noise,
        cond_impl="int8", **kw), np.float64)
    got = twg.waveglow_infer(
        T_WG, tp, torch.from_numpy(mel), 0.6, dtype=t_dt, noise=noise,
        wn_impl="conv", cond_impl="int8", **kw).double().numpy()
    dense = twg.waveglow_infer(
        T_WG, tp, torch.from_numpy(mel), 0.6, dtype=t_dt, noise=noise,
        wn_impl="conv", cond_impl="int8").double().numpy()
    assert got.shape == want.shape == (2, 12 * 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert _snr_db(want, got) > 35.0
    assert not np.array_equal(got, dense)


@pytest.mark.parametrize("wn_impl", ["layer", "flow"])
def test_waveglow_infer_rungs_need_the_conv_formulation(wg, wn_impl):
    """The JAX package's error off its xla path, and its kernel-size
    check; an unknown quant raises too."""
    _, _, tp, mel = wg
    with pytest.raises(ValueError, match="wn_int8_flows/rs requires "
                                         "wn_impl='xla'"):
        twg.waveglow_infer(T_WG, tp, torch.from_numpy(mel), 0.0,
                           wn_impl=wn_impl, wn_int8_rs_flows=1)
    with pytest.raises(ValueError, match="wn_kernel_size=3 only, got 5"):
        twg.waveglow_infer(TConfig(**dict(WG, wn_kernel_size=5)), tp,
                           torch.from_numpy(mel), 0.0, wn_impl="conv",
                           wn_int8_flows=1)
    with pytest.raises(ValueError, match="unknown wn_int8_quant"):
        twg.waveglow_infer(T_WG, tp, torch.from_numpy(mel), 0.0,
                           wn_impl="conv", wn_int8_flows=1,
                           wn_int8_quant="row")


@pytest.mark.parametrize("wn_impl", ["conv", "layer", "flow"])
def test_waveglow_infer_grouped_upsample_is_bit_equal(wg, wn_impl):
    """waveglow_infer equals the same program on the two-step spect bit
    for bit on each coupling-net path (the kernels' plain versions on the
    CPU)."""
    _, _, tp, mel = wg
    noise = matched_noise(J_WG, 2, 12, 1)
    outs = []
    for upsampler in (contextlib.nullcontext, two_step_upsampler):
        with upsampler():
            outs.append(twg.waveglow_infer(T_WG, tp, torch.from_numpy(mel),
                                           0.6, noise=noise,
                                           wn_impl=wn_impl))
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------------------ vocoder CLI

def test_vocoder_cli_wn_int8_flows_matches_jax_cli(tmp_path):
    """--wn_impl xla --wn_int8_flows 2 (the port's conv), f32, int8
    cond, sigma 0, denoiser 0.01: every wav as long as the JAX CLI's and
    within 1 int16 step of it, and not the dense program's."""
    params = _train_params(3)
    save_checkpoint(str(tmp_path / "ckpt"), params, {}, 1e-4, 0)
    save_reference_waveglow_checkpoint(str(tmp_path / "wg.pt"), params,
                                       CLI_CFG)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"waveglow_config": CLI_TINY}))
    lens = [24, 24, 17]
    filelist, files = _corpus(tmp_path, lens)
    kw = dict(batch_size=2, config_path=str(config), cond_impl="int8")
    j_cli.main(str(filelist), str(tmp_path / "ckpt"), str(tmp_path / "j"),
               0.0, 0.01, wn_impl="xla", wn_int8_flows=2, **kw)
    t_cli.main(str(filelist), str(tmp_path / "wg.pt"), str(tmp_path / "t"),
               0.0, 0.01, wn_impl="xla", wn_int8_flows=2, device="cpu",
               **kw)
    t_cli.main(str(filelist), str(tmp_path / "wg.pt"), str(tmp_path / "d"),
               0.0, 0.01, wn_impl="conv", device="cpu", **kw)
    moved = 0
    for f, frames in zip(files, lens):
        name = f.name + "_synthesis.wav"
        got = wavfile.read(tmp_path / "t" / name)[1].astype(np.int32)
        want = wavfile.read(tmp_path / "j" / name)[1].astype(np.int32)
        dense = wavfile.read(tmp_path / "d" / name)[1].astype(np.int32)
        assert len(got) == len(want) == frames * CLI_CFG.hop_length
        assert np.abs(got - want).max() <= 1, name
        moved += int(np.abs(got - dense).max())
    assert moved > 0


def test_vocoder_cli_wn_int8_flows_needs_the_conv_formulation(tmp_path):
    """On the port's default flow kernel --wn_int8_flows fails with the
    JAX package's message before any work; the implementation is not
    switched behind the user's back."""
    with pytest.raises(SystemExit, match="wn_int8_flows/rs requires "
                                         "wn_impl='xla'"):
        t_cli.main(str(tmp_path / "none.txt"), str(tmp_path / "none.pt"),
                   str(tmp_path / "out"), 0.6, 0.0, wn_int8_flows=4,
                   device="cpu")
    args = t_cli.parse_args(["-f", "m.txt", "-w", "w.pt", "-o", "o",
                             "--wn_impl", "xla", "--wn_int8_flows", "4"])
    assert args.wn_int8_flows == 4 and args.wn_impl == "xla"
