"""The FLOP counts against hand counts at one shape, and the frozen WN
kernel counts against the program's own."""

from __future__ import annotations

import json

import pytest

from benchmark.counts import models, peaks, wn
from benchmark.tests.conftest import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def test_waveglow_flops_by_hand():
    wg = _config("waveglow-16k")["waveglow_config"]
    # per group of 8 samples: flows of 8 (x4), 6 (x4), 4 (x4) channels
    C, L = 256, 8
    per_net = (L * 2 * 512 * 256 * 3 + L * 2 * 512 * 640
               + 7 * 2 * 512 * 256 + 2 * 256 * 256)
    per_group = 0
    for c in (8, 6, 4):
        h = c // 2
        per_group += 4 * (2 * c * c + 2 * h * C + per_net + 2 * C * 2 * h)
    upsample = 2 * 80 * 80 * 1024 / 160
    samples = 160 * 1000
    want = samples / 8 * per_group + samples * upsample
    assert models.waveglow_infer_flops(wg, 160, samples) == pytest.approx(
        want, rel=1e-12)
    # about 20 MFLOP a sample
    assert 19e6 < want / samples < 22e6


def test_tacotron2_flops_by_hand():
    t2 = _config("fac-vc-16k")["tacotron2"]
    T = 10
    enc = (2 * T * (5816 * 600 + 600 * 600) + 3 * 2 * T * 600 * 600 * 5
           + 2 * T * 2 * 4 * 300 * (600 + 300) + 2 * T * 600 * 150)
    step = (2 * (80 * 300 + 300 * 300) + 2 * 4 * 300 * (900 + 300)
            + 2 * 300 * 150 + T * (2 * 2 * 32 * 31 + 2 * 32 * 150
                                   + 2 * 150 + 2 * 600)
            + 2 * 4 * 300 * (900 + 300) + 2 * 900 * 81)
    post = 2 * T * 5 * (80 * 512 + 3 * 512 * 512 + 512 * 80)
    want = enc + T * step + post
    assert models.tacotron2_forward_flops(t2, T, T) == want
    assert models.tacotron2_train_flops(t2, [(T, T), (T, T)]) == 6 * want


def test_frozen_wn_counts_match_the_program():
    from fac_via_ppg_torch.eval import roofline

    import torch

    for B, T, h in ((24, 20480, 4), (1, 640, 2)):
        assert wn.flow_counts(B, T, h, "bfloat16") == roofline.flow_counts(
            B, T, h, torch.bfloat16)
        for last in (False, True):
            assert wn.layer_counts(B, T, "bfloat16", last=last) == \
                roofline.layer_counts(B, T, torch.bfloat16, last=last)
    assert peaks.floor_seconds(989e12, 0, "bfloat16") == 1.0
    assert peaks.floor_seconds(0, 3.35e12, "int8") == 1.0
