"""`correct` on the CPU: each cell's control and each fault its timed path
can have, planted underneath the harness, make it false.  The card's
readings that set the limits are in PERF.md; these hold the mechanism."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.conftest import (
    shrink_train,
    shrink_vocoder,
    shrink_wgtrain,
)


def _vocoder_fault(kind):
    def hook(drv):
        program = drv.infer

        def broken(mel, gen):
            audio = program(mel, gen)
            if kind == "unchanged":      # the flows leave the noise as is
                return torch.randn(audio.shape, generator=gen) * drv.sigma
            if kind == "half_batch":     # half the rows served twice
                h = mel.shape[0] // 2
                first = program(mel[:h], gen)
                return torch.cat([first, first[: mel.shape[0] - h]])
            out = audio.clone()          # one utterance's samples shifted
            out[-1] = torch.roll(out[-1], 1)
            return out

        drv.infer = broken
    return hook


def test_vocoder_control_is_not_correct(bench):
    shrink_vocoder(bench)
    out = bench.run("vocoder-batch", hook=lambda d: d.use_control())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_vocoder_faults_are_not_correct(bench, kind):
    shrink_vocoder(bench, channels=64)
    out = bench.run("vocoder-batch", hook=_vocoder_fault(kind))
    assert out["correct"] is False, out["checks"]


def _train_fault(kind, monkeypatch):
    import fac_via_ppg_torch.train.step as step_mod

    def hook(drv):
        if kind == "unchanged":          # the optimizer never steps
            drv.optimizer.apply = lambda opt_state, grads: torch.zeros(())
        elif kind == "half_batch":       # the loss over half the rows
            step = drv.step

            def half(*args):
                args = list(args)
                i = next(j for j, a in enumerate(args)
                         if isinstance(a, tuple))
                args[i] = tuple(x[: -(-x.shape[0] // 2)] for x in args[i])
                return step(*args)

            drv.step = half
        else:                            # one leaf's gradient doubled
            vg = step_mod.value_and_grad

            def altered(*a, **k):
                (loss, aux), grads = vg(*a, **k)
                return (loss, aux), [grads[0] * 2] + list(grads[1:])

            monkeypatch.setattr(step_mod, "value_and_grad", altered)
    return hook


SHRINK = {"ppg2mel-train": shrink_train, "waveglow-train": shrink_wgtrain}


@pytest.mark.parametrize("cell", sorted(SHRINK))
def test_train_control_is_not_correct(bench, cell):
    SHRINK[cell](bench)
    out = bench.run(cell, hook=lambda d: d.use_control())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(SHRINK))
@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_train_faults_are_not_correct(bench, cell, kind, monkeypatch):
    SHRINK[cell](bench)
    out = bench.run(cell, hook=_train_fault(kind, monkeypatch))
    assert out["correct"] is False, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["vocoder-batch", "ppg2mel-train",
                                  "waveglow-train"])
def test_cells_run_correct_on_the_card(cell):
    """On a card: a short run of each cell through the command itself."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card")
    from benchmark import run

    out = run.main(["--workload", cell, "--seed", "2300000001",
                    "--seconds", "3", "--trace", "0"])
    assert out["correct"] is True, out["checks"]
