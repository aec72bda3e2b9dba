"""Single-program accent-conversion serving on one CUDA card (torch).

The port of fac_via_ppg_tpu/eval/fused.py.  `FusedSynthesizer` runs the
whole device side of one micro-batch back to back on the card, with no host
round trip between stages:

    nnet3 AM forward -> batched autoregressive Tacotron2 decode (per-sequence
    gate stop) -> log(1e-5) silence after each stop -> WaveGlow inverse (WN
    layers on a hand-written kernel) -> STFT bias denoiser -> int16 PCM

Host featurization (MFCC on the native C++ library where it builds, else
numpy -> CMN -> splice +-3 -> LDA) is `featurize`.  The decode runs on the
card in chunks of k steps, each chunk one CUDA graph replay
(models/tacotron2.py::decode); the decoder's stop is the only value the
host reads mid-program (once per chunk, to end the loop); everything
else stays on the card until `collect_feature_pairs` reads back the PCM.

Only WaveGlow runs in `serving_dtype`, with its 1x1 inverses kept f32; the
AM and Tacotron2 stay f32.  The denoiser's bias spectrum comes from the
un-cast (f32) vocoder, as in the JAX package.

WaveGlow's coupling nets run on the WN layer kernel (`wn_layer`, one
launch per layer) with the dense cond projection.  With
`cond_impl="int8"` they run on the whole-net flow kernel (`wn_flow`, one
launch per flow), the kernel that takes the int8 cond projection.

Randomness comes from a torch.Generator (the JAX package's `key`).  Two
hooks replace it with given draws, for tests against the JAX package:
`dropout_masks` (the prenet keep-masks in call order) and `noise` (the
WaveGlow draws in `waveglow_infer`'s order).

Several GPUs (`data_parallel`, `model_parallel`; one process each,
parallel/mesh.py): every rank is handed the same requests and generator
seed.  Under data parallelism the batch is padded to the data axis with
repeats and each rank runs its own rows through the whole program, on the
hand kernels; the prenet keep-masks and the WaveGlow noise are drawn for
the padded global batch on every rank and each rank takes its rows, so
the output equals the one-process run's for the same seed (as JAX's
sharding-invariant draws do).  Each rank's decode stops on its own rows
(JAX all-reduces the all-done check; lengths and outputs are per row
either way).  `collect_feature_pairs` all-gathers the PCM, so every rank
returns every row.  With `model_parallel` > 1 Tacotron2 is whole on every
rank and WaveGlow's WN channels are split over the model group, on the
conv formulation (models/waveglow.py::serving_form(mesh=)), as the JAX
package runs its XLA formulation there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from fac_via_ppg_torch.configs.hparams import Tacotron2Config, WaveGlowConfig
from fac_via_ppg_torch.frontend import feat as feat_mod
from fac_via_ppg_torch.frontend import ppg as ppg_mod
from fac_via_ppg_torch.models.denoiser import Denoiser
from fac_via_ppg_torch.models.tacotron2 import (
    inference_masks,
    tacotron2_inference_batched,
)
from fac_via_ppg_torch.models.waveglow import (
    serving_form,
    waveglow_noise,
    waveglow_serve,
)
from fac_via_ppg_torch.parallel.mesh import (
    gather_rows,
    make_mesh,
    padded_rows,
    rank_rows,
    replicate,
)
from fac_via_ppg_torch.utils.device import resolve_device
from fac_via_ppg_torch.utils.numeric import round_batch_to_grid, round_up
from fac_via_ppg_torch.weights import move

SILENCE = math.log(1e-5)


class FusedSynthesizer:
    def __init__(
        self,
        t2_cfg: Tacotron2Config,
        tacotron_params,
        tacotron_state,
        wg_cfg: WaveGlowConfig,
        waveglow_params,
        deps: Optional[ppg_mod.DependenciesPPG] = None,
        sigma: float = 0.6,
        denoiser_strength: float = 0.005,
        serving_dtype: Optional[torch.dtype] = torch.bfloat16,
        max_frames: int = 1000,
        feat_bucket: int = 64,
        pad_to_grid: bool = True,
        cond_impl: str = "dense",
        calibration_mel=None,
        snr_budget_db: Optional[float] = None,
        device=None,
        data_parallel: bool = False,
        model_parallel: int = 1,
        mesh=None,
    ):
        """Parameters are the port's (`weights.py` converts the JAX
        package's); they are moved to `device` (None means "cuda").

        `deps` needs `.nnet` (an Nnet3) and `.lda`; the default
        DependenciesPPG() generates the substitute bundle on first use.

        `cond_impl="int8"` runs the vocoder's stacked cond projections as
        int8 matmuls (models/waveglow.py pack_waveglow_int8cond, built by
        its serving_form), on the flow kernel.  Lossy.

        `cond_impl="auto"` gates the lossy mode: at start-up the bf16+int8
        path's worst-utterance SNR against f32-dense is measured on
        `calibration_mel`, a small (B, n_mel, F) batch from the
        deployment's own corpus (eval/int8_snr.calibration_mel_from_wavs),
        and serving proceeds as "int8" only if it meets `snr_budget_db`
        (default eval/int8_snr.DEFAULT_SNR_BUDGET_DB), else as "dense".
        The decision and the SNR are `.cond_impl` / `.calibration_snr_db`
        (`.requested_cond_impl` keeps what was asked).

        `data_parallel=True` spreads each batch over the job's processes
        (one per GPU), `model_parallel` > 1 splits WaveGlow's WN channels
        over that many of them (see the module doc); `mesh` is a formed
        parallel/mesh.py mesh, else one is made over the whole job (a
        mesh of one process does nothing).  `device` defaults to the
        mesh's, cuda:LOCAL_RANK."""
        self.mesh = None
        if data_parallel or model_parallel > 1 or mesh is not None:
            self.mesh = mesh or make_mesh(model=int(model_parallel),
                                          device=device)
            device = self.mesh.device if device is None else device
        tp = self.mesh is not None and self.mesh.shape["model"] > 1
        # a formed data group, even of one process, runs the rows path
        self._dp = self.mesh is not None and self.mesh.data_group is not None
        self.device = dev = resolve_device(device)
        wg_params = move(waveglow_params, dev)
        if self.mesh is not None:
            # every rank serves rank 0's weights (JAX `replicate`)
            replicate(self.mesh, wg_params)
        self.requested_cond_impl = cond_impl
        self.calibration_snr_db = None
        self.snr_budget_db = None
        if cond_impl == "auto":
            from fac_via_ppg_torch.eval.int8_snr import (
                DEFAULT_SNR_BUDGET_DB,
                select_cond_impl,
            )

            if calibration_mel is None:
                raise ValueError(
                    "cond_impl='auto' needs calibration_mel: a small "
                    "(B, n_mel, F) mel batch from the deployment's own "
                    "corpus (eval/int8_snr.calibration_mel_from_wavs)")
            budget = (DEFAULT_SNR_BUDGET_DB if snr_budget_db is None
                      else float(snr_budget_db))
            # gate on the un-cast params, before the serving cast below,
            # on the flow kernel that serves int8
            cond_impl, worst = select_cond_impl(
                wg_cfg, wg_params, torch.as_tensor(calibration_mel), budget,
                sigma=float(sigma), wn_impl="flow")
            self.calibration_snr_db = worst
            self.snr_budget_db = budget
            print(f"cond_impl=auto: bf16+int8 worst-utterance SNR "
                  f"{worst:.1f} dB vs budget {budget:.1f} dB -> serving "
                  f"cond_impl='{cond_impl}'")
        self.cond_impl = cond_impl
        # the serving form; int8 weights from the un-cast params, as in
        # the JAX package; the conv formulation on this rank's WN
        # channels under TP
        self._wn_impl = ("conv" if tp else
                         "flow" if cond_impl == "int8" else "layer")
        self.waveglow = serving_form(
            wg_cfg, wg_params, dtype=serving_dtype, wn_impl=self._wn_impl,
            cond_impl=cond_impl, mesh=self.mesh)
        self.wg_params = self.waveglow.params
        self.deps = deps or ppg_mod.DependenciesPPG()
        self.nnet = self.deps.nnet.to(dev)
        self.t2_cfg = dataclasses.replace(t2_cfg, max_decoder_steps=max_frames)
        self.wg_cfg = wg_cfg
        self.t2_params = move(tacotron_params, dev)
        self.t2_state = move(tacotron_state, dev)
        if self.mesh is not None:
            replicate(self.mesh, (self.t2_params, self.t2_state))
        self.sigma = float(sigma)
        self.strength = float(denoiser_strength)
        self.serving_dtype = serving_dtype
        self.max_frames = max_frames
        self.feat_bucket = feat_bucket
        # pads off-grid micro-batches (> 8, not a multiple of 8); the
        # JAX package's TPU tile policy, kept as the default until it is
        # measured on the card
        self.pad_to_grid = bool(pad_to_grid)

        # bias spectrum once, from the f32 vocoder
        den = Denoiser(wg_cfg, wg_params)
        self._stft = den.stft
        self._bias = den.bias_spec

    def global_draws(self, b_global: int, t_in: int, generator,
                     dropout_masks=None, noise=None):
        """The prenet keep-masks and the WaveGlow noise of a batch of
        `b_global` rows of `t_in` feature frames, as the one-process
        program draws them from `generator` (or as given): every row's.
        A data-parallel rank takes its rows of these."""
        if dropout_masks is None:
            dropout_masks = inference_masks(
                self.t2_cfg, self.t2_params, b_global, t_in, self.device,
                generator)
        if noise is None:
            G = self.max_frames * self.wg_cfg.hop_length // \
                self.wg_cfg.n_group
            noise = waveglow_noise(self.wg_cfg, b_global, G, generator,
                                   self.device)
        return dropout_masks, noise

    def _device_program_batch(self, feats, n_frames, generator,
                              dropout_masks=None, noise=None,
                              b_global=None):
        """(B, T_pad, lda_dim) -> (int16 PCM (B, M*hop), mel_lengths (B,)).
        `b_global`: this is a data-parallel rank's share of a batch of
        that many rows, and the masks and noise given are the global
        batch's."""
        ppg = self.nnet.forward(feats)                   # (B, T_pad, D)
        x = ppg.transpose(1, 2).float()                  # (B, D, T_pad)
        if b_global is not None:
            rows = rank_rows(self.mesh, b_global)
            dropout_masks, noise = self.global_draws(
                b_global, ppg.shape[1], generator, dropout_masks, noise)
            dropout_masks = [m[rows] for m in dropout_masks]
            noise = [torch.as_tensor(z)[rows] for z in noise]
        masks = None if dropout_masks is None else iter(dropout_masks)
        _, mel_post, _, _, mel_lens = tacotron2_inference_batched(
            self.t2_cfg, self.t2_params, self.t2_state, x, n_frames,
            generator, masks)
        produced = (torch.arange(self.max_frames, device=self.device)
                    [None, None, :] < mel_lens[:, None, None])
        mel_in = torch.where(produced, mel_post,
                             mel_post.new_full((), SILENCE))
        audio = waveglow_serve(
            self.waveglow, mel_in.to(self.serving_dtype or torch.float32),
            self.sigma, generator, noise=noise).float()  # (B, M*hop)
        spec, angles = self._stft.transform(audio)
        spec = torch.clamp(spec - self._bias * self.strength, min=0.0)
        denoised = self._stft.inverse(spec, angles)[:, 0, :]
        pcm = torch.clamp(denoised, -1.0, 1.0) * 32767.0
        return pcm.to(torch.int16), mel_lens

    def _generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(self.device).manual_seed(0)

    def synthesize_batch(self, wav_paths, generator=None, dither: float = 1.0,
                         seed: int = 0):
        """wav files -> list of int16 PCM arrays, one device program."""
        pairs = [self.featurize(p, dither=dither, seed=seed)
                 for p in wav_paths]
        return self.synthesize_feature_pairs(pairs, generator)

    def synthesize_feature_pairs(self, pairs, generator=None,
                                 pad_batch_to: Optional[int] = None,
                                 dropout_masks=None, noise=None):
        """(featurized, n_frames) pairs -> list of int16 PCM arrays."""
        return self.collect_feature_pairs(self.launch_feature_pairs(
            pairs, generator, pad_batch_to=pad_batch_to,
            dropout_masks=dropout_masks, noise=noise))

    def launch_feature_pairs(self, pairs, generator=None,
                             pad_batch_to: Optional[int] = None,
                             dropout_masks=None, noise=None):
        """Assemble and enqueue one micro-batch without waiting for its
        PCM.  The host waits only for the decode's stop, read once per
        chunk of decode steps (and so for whatever the card had queued
        before them); the postnet, WaveGlow, the denoiser and the PCM
        conversion are enqueued behind it, and the returned handle holds
        device tensors whose kernels may still run.
        `collect_feature_pairs` reads them back, so a serving loop can
        featurize batch N+1 while batch N finishes on the card.

        Feature rows are padded to the batch's longest by repeating the
        last frame; the batch is padded with repeats of the last request
        (`pad_batch_to`, the grid policy, and under data parallelism a
        multiple of the data axis) and trimmed on collect.  A
        data-parallel rank enqueues its own rows; `dropout_masks` /
        `noise` are then the padded global batch's."""
        n_real = len(pairs)
        t_max = max(f.shape[0] for f, _ in pairs)
        feats = np.stack([
            np.concatenate(
                [f, np.repeat(f[-1:], t_max - f.shape[0], axis=0)], axis=0
            ) if f.shape[0] != t_max else f
            for f, _ in pairs
        ])
        n_frames = np.array([t for _, t in pairs], np.int64)
        b_pad = n_real
        if pad_batch_to is not None:
            b_pad = max(b_pad, pad_batch_to)
        if self.pad_to_grid:
            b_pad = round_batch_to_grid(b_pad)
        dp = self._dp
        if dp:
            b_pad = padded_rows(self.mesh, b_pad)
        if b_pad != n_real:
            reps = b_pad - n_real
            feats = np.concatenate(
                [feats, np.repeat(feats[-1:], reps, axis=0)], axis=0)
            n_frames = np.concatenate(
                [n_frames, np.repeat(n_frames[-1:], reps)], axis=0)
        if dp:
            rows = rank_rows(self.mesh, b_pad)
            feats, n_frames = feats[rows], n_frames[rows]
        feats_t = torch.as_tensor(feats, dtype=torch.float32,
                                  device=self.device)
        n_frames_t = torch.as_tensor(n_frames, device=self.device)
        with torch.no_grad():
            pcm, mel_lens = self._device_program_batch(
                feats_t, n_frames_t, self._generator(generator),
                dropout_masks, noise, b_global=b_pad if dp else None)
        return pcm, mel_lens, n_real

    def collect_feature_pairs(self, handle):
        """Wait for a `launch_feature_pairs` handle and return the list of
        int16 PCM arrays, each trimmed to its mel length * hop.  Under
        data parallelism every rank's rows are all-gathered first, so
        every rank returns every row."""
        pcm, mel_lens, n_real = handle
        if self._dp:
            pcm = gather_rows(self.mesh, pcm, n_real)
            mel_lens = gather_rows(self.mesh, mel_lens, n_real)
        pcm = pcm.cpu().numpy()
        mel_lens = mel_lens.cpu().numpy()
        hop = self.wg_cfg.hop_length
        return [pcm[i, : min(int(mel_lens[i]) * hop, pcm.shape[1])]
                for i in range(n_real)]

    def featurize(self, wav_path: str, dither: float = 1.0, seed: int = 0):
        """Host front end: wav file -> (bucket-padded AM features, true
        frame count).  Safe to run on a worker thread."""
        fs, wav = feat_mod.read_wav(wav_path)
        feats = ppg_mod.compute_feat_for_nnet_internal(
            wav, fs, self.deps.lda, dither=dither, seed=seed)
        t = feats.shape[0]
        t_pad = round_up(t, self.feat_bucket)
        if t_pad != t:
            feats = np.concatenate(
                [feats, np.repeat(feats[-1:], t_pad - t, axis=0)], axis=0)
        return feats.astype(np.float32), t

    def synthesize_features(self, feats, n_frames: int,
                            generator=None) -> np.ndarray:
        """Padded features of one utterance -> trimmed int16 PCM.  The
        batched program at B=1 stops on that utterance's gate, as the JAX
        package's single program (`tacotron2_inference`) does."""
        return self.synthesize_feature_pairs([(feats, n_frames)],
                                             generator)[0]

    def __call__(self, wav_path: str, generator=None, dither: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """wav file -> int16 PCM of the converted utterance."""
        feats, t = self.featurize(wav_path, dither=dither, seed=seed)
        return self.synthesize_features(feats, t, generator)
