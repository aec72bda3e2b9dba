"""Bring-your-own-artifacts runbook: the BASELINE acceptance chain, the
port of fac_via_ppg_tpu/eval/runbook.py.

The repository holds neither the reference's Kaldi acoustic model
(data/am/final.raw), the L2-ARCTIC corpus nor reference-trained
checkpoints.  The day they exist, one command runs the acceptance chain
against them:

  stage "am"      load the acoustic-model bundle and check, per
                  utterance, the contract the reference's own tests encode
                  (test_ppg.py:48-73): one PPG row per frame and n_senones
                  columns, every row a probability (sums to 1), the
                  monophone reduction preserving the mass.
  stage "parity"  teacher-forced mel-MSE against the reference's torch
                  model as a CPU oracle on the same checkpoint
                  (eval/parity.py); a `.pt` / `.pth` checkpoint only.
  stage "serve"   both implementations' serve paths on the same
                  utterances (eval/trained_parity.py): mel-MSE (target
                  <= 1e-3), stop steps, audio LSD.
  stage "bench"   the five BASELINE configurations through the port's
                  bench (python -m fac_via_ppg_torch.bench), one process
                  each, on the card.

The parity and serve stages need the reference's sources
(FACPPG_REFERENCE_SRC, eval/reference_oracle.py) and raise
ReferenceUnavailable without them.

CLI (the stages on the card):
  python -m fac_via_ppg_torch.eval.runbook \\
      --am_dir DIR            # final.raw[.txt] + final.mat +
                              # reduce_dim.mat + splice_opts (flat or
                              # the reference's am/ + feats/ layout)
      --filelist wavs.txt     # one wav path per line
      --ppg2mel_model t2.pt   # reference .pt or the PPG trainer's
      --waveglow_model wg.pt  # reference .pt or the vocoder trainer's
      [--stages am,parity,serve,bench] [--output report.json] [--cpu]

It exits nonzero when a bench configuration failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from fac_via_ppg_torch.frontend import ppg as ppg_mod

# The BASELINE configurations, by the port bench's names: the JAX runbook's
# "waveglow" (the batched vocoder) is the bench's "rtf".
BENCH_CONFIGS = ("e2e", "rtf", "train_ppg2mel", "train_waveglow",
                 "streaming_fused")


def find_am_paths(am_dir: str) -> Dict[str, str]:
    """The four files of an AM bundle under `am_dir`: the reference's
    layout (am/final.raw + feats/{final.mat, reduce_dim.mat, splice_opts},
    compute_ppg.py:205-255), a flat directory, or a substitute bundle
    (final.raw.txt)."""
    def find(*names):
        for name in names:
            for sub in ("", "am", "feats"):
                p = os.path.join(am_dir, sub, name)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(
            f"none of {names} under {am_dir} (searched ., am/, feats/)")

    return {
        "nnet_path": find("final.raw", "final.raw.txt"),
        "lda_path": find("final.mat", "lda.mat"),
        "reduce_dim_path": find("reduce_dim.mat"),
        "splice_opts_path": find("splice_opts"),
    }


def run_am_stage(deps: ppg_mod.DependenciesPPG, wav_paths: List[str],
                 device=None) -> Dict:
    """The AM bundle and the reference's PPG invariants on every
    utterance; an AssertionError names the first that breaks one.  The
    TDNN runs on `device` (None: the card)."""
    # the reduce_dim matrix's columns are the senones (the reference's
    # data/feats/reduce_dim.mat is 40 x 5816)
    n_mono, n_senones = (int(d) for d in deps.monophone_trans.shape)
    per_utt = []
    for wav_path in wav_paths:
        full = ppg_mod.get_ppg(wav_path, deps, dither=0.0, device=device)
        mono = ppg_mod.reduce_ppg_dim(full, deps.monophone_trans)
        # test_ppg.py:48-54: a row per frame, n_senones columns, each row
        # a probability distribution
        assert full.ndim == 2 and full.shape[1] == n_senones, full.shape
        row_sums = np.asarray(full, np.float64).sum(axis=1)
        assert np.allclose(row_sums, 1.0, atol=1e-3), (
            wav_path, float(np.abs(row_sums - 1).max()))
        # test_ppg.py:56-73: the monophone reduction keeps the mass
        assert mono.shape == (full.shape[0], n_mono), mono.shape
        mono_sums = np.asarray(mono, np.float64).sum(axis=1)
        assert np.allclose(mono_sums, 1.0, atol=1e-3), (
            wav_path, float(np.abs(mono_sums - 1).max()))
        per_utt.append({
            "wav": wav_path,
            "frames": int(full.shape[0]),
            "max_row_sum_err": float(np.abs(row_sums - 1).max()),
            "max_mono_sum_err": float(np.abs(mono_sums - 1).max()),
        })
    return {
        "n_senones": n_senones,
        "n_monophones": n_mono,
        "per_utterance": per_utt,
        "invariants_ok": True,  # the asserts above raise otherwise
    }


def run_bench_stage(configs=BENCH_CONFIGS, extra_args=()) -> Dict:
    """`python -m fac_via_ppg_torch.bench --config C` once per
    configuration, each a fresh process, run one after another; each
    run's JSON line, or {"error": its output's tail} where it failed.
    The runs share the kernels' build directory; a library is built into
    a file of its own and renamed into place (ops/cuda_lib.py), so a
    fresh process never reads a half-written one."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    out = {}
    for config in configs:
        proc = subprocess.run(
            [sys.executable, "-m", "fac_via_ppg_torch.bench", "--config",
             config, *extra_args],
            capture_output=True, text=True, env=env)
        line = next((ln for ln in reversed(proc.stdout.strip().splitlines())
                     if ln.startswith("{")), None)
        if proc.returncode != 0 or line is None:
            out[config] = {"error": (proc.stderr or proc.stdout)[-2000:]}
        else:
            out[config] = json.loads(line)
    return out


def failed_configs(report: Dict) -> List[str]:
    """The bench configurations of a report that failed."""
    return [c for c, v in report.get("bench", {}).items() if "error" in v]


def run_runbook(
    am_dir: str,
    wav_paths: List[str],
    ppg2mel_model: Optional[str] = None,
    waveglow_model: Optional[str] = None,
    stages: tuple = ("am", "parity", "serve"),
    t2_kw: Optional[dict] = None,
    wg_cfg=None,
    max_decoder_steps: Optional[int] = None,
    bench_args: tuple = (),
    device=None,
) -> Dict:
    """The requested stages' combined report.  `t2_kw` / `wg_cfg`
    override the model sizes on both sides of every comparison (the tests
    run the chain tiny); `device` None means the card."""
    report: Dict = {"stages": list(stages)}
    paths = find_am_paths(am_dir)
    report["am_paths"] = paths
    deps = ppg_mod.DependenciesPPG(**paths)

    if "am" in stages:
        report["am"] = run_am_stage(deps, wav_paths, device)

    if ("parity" in stages or "serve" in stages) and not (
            ppg2mel_model and waveglow_model):
        raise ValueError(
            "parity/serve stages need --ppg2mel_model/--waveglow_model")

    if "parity" in stages:
        # the teacher-forced oracle loads the reference's .pt itself; the
        # serve stage exports the trainers' checkpoints on its own
        if ppg2mel_model.endswith((".pt", ".pth")):
            from fac_via_ppg_torch.eval.parity import run_parity

            with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                             delete=False) as f:
                f.write("\n".join(wav_paths))
                filelist = f.name
            try:
                report["parity"] = run_parity(
                    ppg2mel_model, filelist, against_torch_oracle=True,
                    t2_kw=t2_kw, deps=deps, device=device)
            finally:
                os.unlink(filelist)
        else:
            report["parity"] = {
                "skipped": "teacher-forced oracle parity needs a "
                           "reference .pt checkpoint; serve-stage "
                           "fidelity covers the trainers' checkpoints"}

    if "serve" in stages:
        from fac_via_ppg_torch.eval.trained_parity import run_trained_parity

        report["serve"] = run_trained_parity(
            ppg2mel_model, waveglow_model, wav_paths, t2_kw=t2_kw,
            wg_cfg=wg_cfg, deps=deps, max_decoder_steps=max_decoder_steps,
            device=device)
        report["passes_baseline"] = report["serve"]["passes_baseline"]

    if "bench" in stages:
        report["bench"] = run_bench_stage(extra_args=bench_args)

    return report


def main(argv=None, device=None) -> Dict:
    """The runbook CLI: prints the report; exits 1 when a bench
    configuration failed, so that nothing downstream reads an error as a
    pass."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--am_dir", required=True,
                        help="acoustic-model bundle dir (the reference's "
                             "data/ layout, flat, or substitute)")
    parser.add_argument("--filelist", help="text file of wav paths")
    parser.add_argument("--wavs", nargs="*", default=[])
    parser.add_argument("--ppg2mel_model",
                        help="the reference's .pt or the PPG trainer's "
                             "checkpoint")
    parser.add_argument("--waveglow_model",
                        help="the reference's .pt or the vocoder "
                             "trainer's checkpoint")
    parser.add_argument("--stages", default="am,parity,serve",
                        help="comma list of am,parity,serve,bench")
    parser.add_argument("--max_decoder_steps", type=int, default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run the stages on the CPU (the bench "
                             "stays on the card)")
    args = parser.parse_args(argv)

    wavs = list(args.wavs)
    if args.filelist:
        with open(args.filelist) as f:
            wavs += [line.strip() for line in f if line.strip()]
    if not wavs:
        raise SystemExit("no wavs: pass --filelist and/or --wavs")

    report = run_runbook(
        args.am_dir, wavs,
        ppg2mel_model=args.ppg2mel_model,
        waveglow_model=args.waveglow_model,
        stages=tuple(s.strip() for s in args.stages.split(",") if s.strip()),
        max_decoder_steps=args.max_decoder_steps,
        device="cpu" if args.cpu else device)
    text = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    failed = failed_configs(report)
    if failed:
        raise SystemExit(f"runbook: bench configurations failed: "
                         f"{', '.join(failed)}")
    return report


if __name__ == "__main__":
    main()
