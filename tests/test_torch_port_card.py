"""The WN layer kernel against its plain PyTorch version, on the card.

Needs CUDA and nvcc; skips without a card.  This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_card.py
"""

import numpy as np
import pytest
import torch

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
