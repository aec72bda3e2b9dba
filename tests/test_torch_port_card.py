"""The WN kernels (the layer kernel, the whole-net flow kernel) against
their plain PyTorch versions, on the card.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dilation,last", [(1, False), (2, False),
                                           (8, False), (128, False),
                                           (64, True)])
def test_kernel_matches_plain(card, dtype, atol, dilation, last):
    args = _layer(dilation, 2, 1000, 256, last, dtype, card)
    n0 = wl.launches
    a_k, s_k = wl.wn_layer(*args, dilation=dilation, last=last)
    torch.cuda.synchronize()
    assert wl.launches == n0 + 1
    a_p, s_p = wl.wn_layer_plain(*args, dilation=dilation, last=last)
    torch.testing.assert_close(s_k.float(), s_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(a_k.float(), a_p.float(), atol=atol, rtol=0)


def _flow(seed, B, T, n_half, dtype, device, C=256, L=8):
    """A random flow pack (pack_wn_flow's layout, the last layer's
    residual columns zero), audio and cond."""
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
    return packed, mk((B, n_half, T), 1.0), mk((B, T, L * 2 * C), 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n_half", [4, 3, 2])
def test_flow_kernel_matches_plain(card, dtype, atol, n_half):
    """One launch per net; f32 within 1e-4, bf16 within 3e-2 x max(1,
    max|plain|) (8 layers of bf16 rounding in another order)."""
    packed, audio, cond = _flow(n_half, 2, 1000, n_half, dtype, card)
    n0 = wf.launches
    got = wf.wn_flow(packed, audio, cond)
    torch.cuda.synchronize()
    assert wf.launches == n0 + 1
    want = wf.wn_flow_plain(packed, audio, cond).float()
    assert got.shape == (2, 2 * n_half, 1000)
    scale = max(1.0, want.abs().max().item()) if dtype == torch.bfloat16 \
        else 1.0
    torch.testing.assert_close(got.float(), want, atol=atol * scale, rtol=0)
