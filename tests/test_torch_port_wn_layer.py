"""The port's WN layer (ops/wn_layer.py) against the JAX package's
wn_layer_reference and wn_layer_pallas (interpret mode), on the CPU.

On a CPU tensor the wrapper takes `wn_layer_plain`; the kernel itself is
held against it on the card by tests/test_torch_port_card.py.
Tolerance: atol 1e-5 in f32 (same arithmetic, different summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fac_via_ppg_torch.ops import wn_layer as wl
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
