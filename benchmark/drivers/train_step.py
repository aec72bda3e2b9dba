"""Traffic kind `train_step`: a trainer's loop on one card, closed loop,
fed by the trainer's own batcher (`EpochBatcher` with the configuration's
seed) and `prefetch`, the loss read back every step as the trainer
prints it.  `traffic.model` picks the trainer:

- "tacotron2" (fac_via_ppg_torch/scripts/train_ppg2mel.py): `utterances`
  (PPG, mel) pairs, lengths spread evenly over [min_frames, max_frames],
  collated by `ppg_acoustics_collate` padding to `length_bucket_size`,
  into `make_tacotron2_train_step`'s step (dropout from the seed, the
  gradient norm read back too).  The seed draws the weights, the PPGs (a
  senone held for `ppg_segment_frames` frames, its logit `ppg_peak_logit`
  above unit noise, softmax over the senones), the mels, the dropout.
- "waveglow" (fac_via_ppg_torch/scripts/train_waveglow.py): `wavs` 16 kHz
  wavs of `wav_seconds` (a tone whose pitch the seed draws, amplitude
  modulated, with noise), written under TMPDIR, cropped by `Mel2Samp` to
  `segment_length`, into `make_waveglow_train_step`'s step.

Every seed gets the same lengths, batches and order; the seed draws the
contents.  Set-up runs the first `check.steps` steps through the same
call and feed and keeps what the reference needs: the initial weights,
the first gradient as Adam took it (its first moment over 1 - beta1), the
weights after the last of them, and their batches and losses.
`train_step_s` is the window's seconds over the steps completed in it."""

from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.core import weights
from benchmark.core.seeds import generator
from benchmark.counts.models import tacotron2_train_flops
from benchmark.counts.models import waveglow_infer_flops
from benchmark.counts.peaks import F32_FLOPS, TF32_FLOPS
from benchmark.reference import tacotron2 as t2_reference
from benchmark.reference import waveglow as wg_reference
from fac_via_ppg_torch.configs.hparams import Tacotron2Config
from fac_via_ppg_torch.configs.hparams import WaveGlowConfig
from fac_via_ppg_torch.data.mel2samp import Mel2Samp, mel2samp_collate
from fac_via_ppg_torch.data.ppg_mel_dataset import (
    EpochBatcher,
    ppg_acoustics_collate,
    ppg_mel_lengths,
)
from fac_via_ppg_torch.data.prefetch import prefetch, to_device
from fac_via_ppg_torch.models.waveglow import weight_norm_params
from fac_via_ppg_torch.train.optim import make_optimizer
from fac_via_ppg_torch.train.step import (
    make_tacotron2_train_step,
    make_waveglow_train_step,
)

BETA1 = 0.9


def spread(n: int, lo: int, hi: int) -> list:
    """n lengths spread evenly over [lo, hi]."""
    return [lo + ((hi - lo) * (2 * i + 1)) // (2 * n) for i in range(n)]


class Tacotron2Job:
    """The PPG-to-mel trainer's model, data and reference step."""

    def __init__(self, config, traffic, seed, dev):
        self.t2, self.train = config["tacotron2"], config["train"]
        self.seed, self.dev = seed, dev
        fields = {f.name for f in dataclasses.fields(Tacotron2Config)}
        self.cfg = Tacotron2Config(**{k: v for k, v in self.t2.items()
                                      if k in fields})
        self.params, self.state = weights.tacotron2(self.t2, seed, dev)
        lengths = spread(traffic["utterances"], traffic["min_frames"],
                         traffic["max_frames"])
        S, D = self.t2["n_symbols"], self.t2["n_acoustic_feat_dims"]
        total = sum(lengths)
        g = generator(dev, seed, "corpus")
        seg = int(traffic["ppg_segment_frames"])
        ppg = torch.randn((total, S), generator=g, device=dev)
        senone = torch.randint(0, S, (-(-total // seg),), generator=g,
                               device=dev).repeat_interleave(seg)
        ppg[torch.arange(total, device=dev), senone[:total]] += \
            float(traffic["ppg_peak_logit"])
        ppg = torch.softmax(ppg, dim=1).cpu().numpy()
        mel = (torch.randn((total, D), generator=g, device=dev)
               * traffic["mel_std"] + traffic["mel_mean"]).cpu().numpy()
        offs = np.cumsum([0] + lengths)
        self.dataset = [(ppg[a:b], mel[a:b])
                        for a, b in zip(offs[:-1], offs[1:])]

    def optimizer(self):
        return make_optimizer(self.train["learning_rate"],
                              self.train["weight_decay"],
                              self.train["grad_clip_thresh"])

    def reference_optimizer(self):
        return t2_reference.Adam(self.train["learning_rate"],
                                 self.train["weight_decay"],
                                 self.train["grad_clip_thresh"])

    def make_step(self, optimizer, compute_dtype):
        return make_tacotron2_train_step(
            self.cfg, optimizer, self.train["mel_weight"],
            self.train["gate_weight"], compute_dtype=compute_dtype)

    def batcher(self, note):
        def collate(batch, **kw):
            out = ppg_acoustics_collate(batch, **kw)
            note(list(zip(out[1].tolist(), out[4].tolist())))
            return out

        return EpochBatcher(self.dataset, self.train["batch_size"],
                            self.train["seed"], collate, drop_last=True,
                            pad_to=self.train["length_bucket_size"],
                            length_fn=ppg_mel_lengths)

    def call(self, step, params, opt_state, batch, k):
        out = step(params, self.state, opt_state, batch,
                   generator(self.dev, self.seed, "dropout", k))
        self.state = out.model_state
        return float(out.loss), float(out.grad_norm)

    def flops(self, rows) -> float:
        return tacotron2_train_flops(self.t2, rows)

    def reference_loss(self, tree, batch, k):
        ppg, in_len, mel, gate, out_len = batch
        masks = t2_reference.draw_masks(
            self.t2, tree, ppg.shape[0], ppg.shape[2], mel.shape[2],
            generator(self.dev, self.seed, "dropout", k), self.dev)
        out = t2_reference.forward(self.t2, tree, ppg.float(), in_len, mel,
                                   out_len, masks)
        loss = t2_reference.loss(out, mel, gate, out_len,
                                 self.train["mel_weight"],
                                 self.train["gate_weight"])
        return loss, abs(float(loss.detach()))

    def close(self):
        self.params = self.state = None


class WaveGlowJob:
    """The vocoder trainer's model, data and reference step."""

    def __init__(self, config, traffic, seed, dev):
        from scipy.io import wavfile

        self.wg, self.data = config["waveglow_config"], config["data_config"]
        self.train = config["train_config"]
        self.seed, self.dev = seed, dev
        self.cfg = WaveGlowConfig.from_dict(self.wg)
        folded = weights.waveglow(self.wg, seed, dev,
                                  config["weights"]["wn_end_bound"])
        self.params = weight_norm_params(folded)
        sr = self.data["sampling_rate"]
        n, secs = int(traffic["wavs"]), float(traffic["wav_seconds"])
        g = generator(dev, seed, "wavs")
        t = torch.arange(int(secs * sr), device=dev) / sr
        f0 = 100 + 150 * torch.rand((n, 1), generator=g, device=dev)
        wav = (torch.sin(2 * torch.pi * f0 * t)
               * (0.4 + 0.2 * torch.sin(2 * torch.pi * 3 * t))
               + 0.05 * torch.randn((n, t.numel()), generator=g,
                                    device=dev))
        pcm = (wav.clamp(-1, 1) * 12000).to(torch.int16).cpu().numpy()
        self.tmp = tempfile.mkdtemp(prefix="bench_wavs_")
        paths = []
        for i, x in enumerate(pcm):
            paths.append(os.path.join(self.tmp, f"utt{i}.wav"))
            wavfile.write(paths[-1], sr, x)
        self.filelist = os.path.join(self.tmp, "train.txt")
        with open(self.filelist, "w") as f:
            f.write("\n".join(paths) + "\n")

    def optimizer(self):
        return make_optimizer(self.train["learning_rate"])

    def reference_optimizer(self):
        return t2_reference.Adam(self.train["learning_rate"], 0.0,
                                 float("inf"))

    def make_step(self, optimizer, compute_dtype):
        return make_waveglow_train_step(self.cfg, optimizer,
                                        sigma=self.train["sigma"],
                                        compute_dtype=compute_dtype)

    def batcher(self, note):
        d = self.data
        trainset = Mel2Samp(self.filelist, d["segment_length"],
                            d["filter_length"], d["hop_length"],
                            d["win_length"], d["sampling_rate"],
                            d["mel_fmin"], d["mel_fmax"],
                            n_mel_channels=self.wg["n_mel_channels"])

        def collate(batch, **kw):
            note([d["segment_length"]] * len(batch))
            return mel2samp_collate(batch, **kw)

        return EpochBatcher(trainset, self.train["batch_size"],
                            self.train["seed"], collate, drop_last=True)

    def call(self, step, params, opt_state, batch, k):
        out = step(params, opt_state, batch)
        return float(out.loss), float(out.grad_norm)

    def flops(self, rows) -> float:
        return 3 * waveglow_infer_flops(self.wg, self.data["hop_length"],
                                        sum(rows))

    def reference_loss(self, tree, batch, k):
        audio = batch[1].float()
        mel = wg_reference.log_mel(audio, self.data,
                                   self.wg["n_mel_channels"])
        out = wg_reference.forward(self.wg, self.data["hop_length"], tree,
                                   mel, audio)
        return wg_reference.loss(out, self.train["sigma"])

    def close(self):
        self.params = None
        shutil.rmtree(self.tmp, ignore_errors=True)


JOBS = {"tacotron2": Tacotron2Job, "waveglow": WaveGlowJob}


def _clone(tree) -> dict:
    return {k: v.detach().clone() for k, v in weights.flatten(tree).items()}


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cell, self.check_spec = cell, cell["check"]
        self.seed, self.dev = seed, torch.device(device)
        self.attempted = self.failed = 0
        self.window = {}
        self.job = JOBS[cell["traffic"]["model"]](config, cell["traffic"],
                                                  seed, self.dev)
        self.params = self.job.params
        self.p0 = _clone(self.params)
        self.compute_dtype = None
        self._build()

    # ---------------------------------------------------------------- program
    def _build(self) -> None:
        self.optimizer = self.job.optimizer()
        self.opt_state = self.optimizer.init(self.params)
        self.step = self.job.make_step(self.optimizer, self.compute_dtype)
        self.lengths = []   # each collated batch's rows, in batch order
        batcher = self.job.batcher(self.lengths.append)
        place = to_device(self.dev, {0: self.compute_dtype}
                          if self.compute_dtype is not None else None)

        def epochs():
            for _ in itertools.count():
                yield from prefetch(batcher, place, depth=2)

        self.feed = epochs()
        self.iteration = 0

    def use_control(self) -> None:
        """The control: the program's own bf16 training path (the
        trainers' train_dtype=bfloat16)."""
        self.compute_dtype = torch.bfloat16
        self.feed.close()
        self._build()

    def _step(self):
        batch = next(self.feed)
        loss, gnorm = self.job.call(self.step, self.params, self.opt_state,
                                    batch, self.iteration)
        self.iteration += 1
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            self.failed += 1
        return batch, loss

    def warm(self) -> None:
        """The first `check.steps` steps, kept for the reference."""
        self.first = []
        for k in range(int(self.check_spec["steps"])):
            batch, loss = self._step()
            self.first.append((batch, loss))
            if k == 0:
                moments = {name: self.opt_state.state.get(p, {})
                           .get("exp_avg", torch.zeros_like(p))
                           for name, p in weights.flatten(
                               self.params).items()}
                self.g1 = {name: m.detach().clone() / (1 - BETA1)
                           for name, m in moments.items()}
        self.p_last = _clone(self.params)

    def measure(self, seconds: float) -> dict:
        n0 = self.iteration
        t0 = time.perf_counter()
        while True:
            self._step()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        steps = self.iteration - n0
        self.attempted = steps
        tf32 = (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
        flops = sum(self.job.flops(rows)
                    for rows in self.lengths[n0:self.iteration])
        self.window = {"seconds": wall, "steps": steps, "model_flops": flops,
                       "peak": TF32_FLOPS if tf32 else F32_FLOPS}
        return {"train_step_s": wall / steps}

    def traced(self, tracer) -> tuple:
        with tracer(self.dev) as t:
            for _ in range(int(self.cell["trace"]["steps"])):
                self._step()
        return t.data, {}

    def release(self) -> None:
        self.feed.close()
        self.job.close()
        self.params = self.opt_state = self.step = None
        self.optimizer = self.feed = None

    # ---------------------------------------------------------------- check
    def check(self) -> dict:
        """The reference follows the first steps from the same weights,
        batches and dropout draws.  The gaps: each step's loss (against
        the reference's loss, or for a loss that is a difference of larger
        terms against the sum of their sizes); per leaf,
        the norm of the first gradient as Adam took it; per leaf, the norm
        of the weights' change over the steps, leaving out leaves whose
        reference gradient is under a thousandth of the median leaf's
        (Adam moves them by rounding alone).  A leaf's gap is against the
        larger of its reference norm and the median leaf's."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._check()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def _check(self) -> dict:
        flat = {k: v.clone().requires_grad_() for k, v in self.p0.items()}
        tree = _unflatten(flat)
        adam = self.job.reference_optimizer()
        loss_gap, g1_ref = 0.0, None
        for k, (batch, loss_prog) in enumerate(self.first):
            batch = tuple(x.to(self.dev) for x in batch)
            with torch.enable_grad():
                loss, scale = self.job.reference_loss(tree, batch, k)
                grads = torch.autograd.grad(loss, list(flat.values()),
                                            allow_unused=True)
            grads = {name: torch.zeros_like(p) if g is None else g
                     for (name, p), g in zip(flat.items(), grads)}
            taken = adam.step(flat, grads)
            if k == 0:
                g1_ref = taken
            loss_gap = max(loss_gap,
                           abs(loss_prog - float(loss.detach())) / scale)
        norm = torch.linalg.vector_norm
        g_ref = {k: float(norm(v)) for k, v in g1_ref.items()}
        g_med = float(np.median(list(g_ref.values())))
        grad_gap = max(abs(float(norm(self.g1[k])) - g_ref[k])
                       / max(g_ref[k], g_med) for k in g_ref)
        moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
        d_ref = {k: float(norm(flat[k].detach() - self.p0[k]))
                 for k in moved}
        d_prog = {k: float(norm(self.p_last[k] - self.p0[k]))
                  for k in moved}
        d_med = float(np.median(list(d_ref.values())))
        update_gap = max(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], d_med)
                         for k in moved)
        c = self.check_spec
        self.first = None
        return {"loss_gap": (loss_gap, float(c["loss_gap"])),
                "grad_gap": (grad_gap, float(c["grad_gap"])),
                "update_gap": (update_gap, float(c["update_gap"]))}


def _unflatten(flat: dict) -> dict:
    """{"a.0.b": leaf} -> the nested dict / list tree."""
    root: dict = {}
    for path, leaf in flat.items():
        keys = path.split(".")
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
