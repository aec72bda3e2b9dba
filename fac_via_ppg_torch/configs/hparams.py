"""Hyper-parameter registry and model configurations (a copy of
fac_via_ppg_tpu/configs/hparams.py; the port keeps its own).

`create_hparams` / `create_hparams_stage` mirror the reference public
surface (`src/common/hparams.py:40-241` in guanlongzhao/fac-via-ppg): the
same keys, the same defaults, the same unknown-key rejection, the same
frozen Interspeech'19 "stage" variant.  The JAX package's extension keys
are accepted too, so that every config written for it stays valid here.
The port's inference entry points read the model widths, the audio
parameters, `seed` and `compute_dtype` (the WaveGlow serving dtype,
float32 | bfloat16); the PPG->mel trainer also reads the data,
optimization and training keys; the CUDA-era keys (`fp16_run`,
`distributed_run`, `dist_*`, `cudnn_*`) are accepted and stored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


class HParamsView:
    """Attribute view over a plain dict (reference hparams.py:35-37)."""

    def __init__(self, d: Dict[str, Any]):
        self.__dict__ = d


_DEFAULTS: Dict[str, Any] = {
    ################################
    # Experiment Parameters        #
    ################################
    "epochs": 1000,
    "iters_per_checkpoint": 200,
    "seed": 16807,
    "dynamic_loss_scaling": True,
    "fp16_run": False,
    "distributed_run": False,
    "dist_backend": "nccl",
    "dist_url": "tcp://localhost:54321",
    "cudnn_enabled": True,
    "cudnn_benchmark": False,
    "output_directory": None,
    "log_directory": "log",
    "checkpoint_path": "",
    "warm_start": False,
    "n_gpus": 1,
    "rank": 0,
    "group_name": "group_name",

    ################################
    # Data Parameters              #
    ################################
    "training_files": "",
    "validation_files": "",
    "is_full_ppg": True,
    "is_append_f0": False,
    "ppg_subsampling_factor": 1,
    "load_feats_from_disk": False,
    "is_cache_feats": False,
    "feats_cache_path": "",

    ################################
    # Audio Parameters             #
    ################################
    "max_wav_value": 32768.0,
    "sampling_rate": 16000,
    "n_acoustic_feat_dims": 80,
    "filter_length": 1024,
    "hop_length": 160,
    "win_length": 1024,
    "mel_fmin": 0.0,
    "mel_fmax": 8000.0,

    ################################
    # Model Parameters             #
    ################################
    "n_symbols": 5816,
    "symbols_embedding_dim": 600,

    # Encoder parameters
    "encoder_kernel_size": 5,
    "encoder_n_convolutions": 3,
    "encoder_embedding_dim": 600,

    # Decoder parameters
    "decoder_rnn_dim": 300,
    "prenet_dim": 300,
    "max_decoder_steps": 1000,
    "gate_threshold": 0.5,
    "p_attention_dropout": 0.1,
    "p_decoder_dropout": 0.1,

    # Attention parameters
    "attention_rnn_dim": 300,
    "attention_dim": 150,
    "attention_window_size": 20,

    # Location Layer parameters
    "attention_location_n_filters": 32,
    "attention_location_kernel_size": 31,

    # Mel-post processing network parameters
    "postnet_embedding_dim": 512,
    "postnet_kernel_size": 5,
    "postnet_n_convolutions": 5,

    ################################
    # Optimization Hyperparameters #
    ################################
    "use_saved_learning_rate": False,
    "learning_rate": 1e-5,
    "weight_decay": 1e-6,
    "grad_clip_thresh": 1.0,
    "batch_size": 6,
    "mask_padding": True,
    "mel_weight": 1,
    "gate_weight": 0.005,
}

# The JAX package's extension keys (absent from the reference), with its
# defaults.  The serving paths read `compute_dtype`, the trainers the
# training and profiling keys; the sharding and compilation-cache keys
# belong to modules the port has not ported yet, and the trainers raise
# on them.
_EXTENSIONS: Dict[str, Any] = {
    # WaveGlow serving dtype of the synthesis CLIs: "float32" or "bfloat16"
    # (the flows in that dtype with f32 accumulation, the 1x1 inverses f32).
    "compute_dtype": "float32",
    # Training dtype ("float32" or "bfloat16").
    "train_dtype": "float32",
    # Unroll factor of the JAX package's recurrent time loops.
    "scan_unroll": 4,
    # Gradient accumulation: micro-batches per optimizer step.
    "grad_accum_steps": 1,
    # Learning-rate schedule: "constant" (reference behavior),
    # "exponential" or "cosine", after lr_warmup_steps of linear warmup.
    "lr_schedule": "constant",
    "lr_warmup_steps": 0,
    "lr_decay_steps": 0,
    "lr_decay_rate": 1.0,
    "lr_min_factor": 0.0,
    # Devices along the data axis ("" = all) and the tensor-parallel axis.
    "data_parallel_devices": "",
    "tensor_parallel_devices": 1,
    # Shard the optimizer moments over the data axis.
    "zero_sharded_opt_state": False,
    # Recompute the decoder loop's internals in the backward pass.
    "remat": False,
    # Pad training batches to length buckets of this granularity.
    "length_bucket_size": 128,
    # Featurize the training corpus on the device.
    "featurize_device": False,
    # Profiler trace directory ("" disables).
    "profile_dir": "",
    # Persistent compilation-cache directory ("" disables).
    "compilation_cache_dir": "",
}


def _apply(hparams: Dict[str, Any], kwargs) -> HParamsView:
    for key, val in kwargs.items():
        if key in hparams:
            hparams[key] = val
        else:
            raise ValueError("The hyper-parameter %s is not supported." % key)
    return HParamsView(hparams)


def create_hparams(**kwargs) -> HParamsView:
    """Create model hyperparameters (reference hparams.py:40-158).

    Unknown keys raise ValueError, matching the reference behavior.
    """
    hparams = dict(_DEFAULTS)
    hparams.update(_EXTENSIONS)
    return _apply(hparams, kwargs)


def create_hparams_stage(**kwargs) -> HParamsView:
    """Frozen Interspeech'19 configuration (reference hparams.py:161-241)."""
    hparams = {
        "attention_dim": 150,
        "attention_location_kernel_size": 31,
        "attention_location_n_filters": 32,
        "attention_rnn_dim": 300,
        "attention_window_size": 20,
        "batch_size": 6,
        "checkpoint_path": None,
        "cudnn_benchmark": False,
        "cudnn_enabled": True,
        "decoder_rnn_dim": 300,
        "dist_backend": "nccl",
        "dist_url": "tcp://localhost:54321",
        "distributed_run": False,
        "dynamic_loss_scaling": True,
        "encoder_embedding_dim": 600,
        "encoder_kernel_size": 5,
        "encoder_n_convolutions": 3,
        "epochs": 1000,
        "feats_cache_path": "",
        "filter_length": 1024,
        "fp16_run": False,
        "gate_threshold": 0.5,
        "gate_weight": 0.005,
        "grad_clip_thresh": 1.0,
        "group_name": "group_name",
        "hop_length": 160,
        "is_append_f0": False,
        "is_cache_feats": False,
        "is_full_ppg": True,
        "is_large_set": False,
        "is_skip_sil": False,
        "iters_per_checkpoint": 100,
        "learning_rate": 0.0001,
        "load_feats_from_disk": True,
        "log_directory": "log",
        "mask_padding": True,
        "max_decoder_steps": 1000,
        "max_wav_value": 32768.0,
        "mel_fmax": 8000.0,
        "mel_fmin": 0.0,
        "mel_weight": 1,
        "mvn_stats_file": "",
        "n_acoustic_feat_dims": 80,
        "n_gpus": 1,
        "n_symbols": 5816,
        "output_directory": "",
        "p_attention_dropout": 0.1,
        "p_decoder_dropout": 0.1,
        "postnet_embedding_dim": 512,
        "postnet_kernel_size": 5,
        "postnet_n_convolutions": 5,
        "ppg_subsampling_factor": 1,
        "prenet_dim": 300,
        "rank": 0,
        "sampling_rate": 16000,
        "seed": 16807,
        "sequence_level": "sentence",
        "symbols_embedding_dim": 600,
        "training_files": "",
        "use_saved_learning_rate": False,
        "validation_files": "",
        "warm_start": False,
        "weight_decay": 1e-06,
        "win_length": 1024,
    }
    hparams.update(_EXTENSIONS)
    return _apply(hparams, kwargs)


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    """Static model config distilled from hparams (defaults: the
    reference's `create_hparams`)."""

    n_symbols: int = 5816
    symbols_embedding_dim: int = 600
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 600
    n_acoustic_feat_dims: int = 80
    decoder_rnn_dim: int = 300
    prenet_dim: int = 300
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    p_attention_dropout: float = 0.1
    p_decoder_dropout: float = 0.1
    attention_rnn_dim: int = 300
    attention_dim: int = 150
    attention_window_size: int = 20  # reference allows None to disable
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    mask_padding: bool = True

    @classmethod
    def from_hparams(cls, hp) -> "Tacotron2Config":
        window = hp.attention_window_size
        return cls(
            n_symbols=hp.n_symbols,
            symbols_embedding_dim=hp.symbols_embedding_dim,
            encoder_kernel_size=hp.encoder_kernel_size,
            encoder_n_convolutions=hp.encoder_n_convolutions,
            encoder_embedding_dim=hp.encoder_embedding_dim,
            n_acoustic_feat_dims=hp.n_acoustic_feat_dims,
            decoder_rnn_dim=hp.decoder_rnn_dim,
            prenet_dim=hp.prenet_dim,
            max_decoder_steps=hp.max_decoder_steps,
            gate_threshold=hp.gate_threshold,
            p_attention_dropout=hp.p_attention_dropout,
            p_decoder_dropout=hp.p_decoder_dropout,
            attention_rnn_dim=hp.attention_rnn_dim,
            attention_dim=hp.attention_dim,
            attention_window_size=(-1 if window is None else window),
            attention_location_n_filters=hp.attention_location_n_filters,
            attention_location_kernel_size=hp.attention_location_kernel_size,
            postnet_embedding_dim=hp.postnet_embedding_dim,
            postnet_kernel_size=hp.postnet_kernel_size,
            postnet_n_convolutions=hp.postnet_n_convolutions,
            mask_padding=hp.mask_padding,
        )


@dataclasses.dataclass(frozen=True)
class WaveGlowConfig:
    """WaveGlow architecture config (reference src/waveglow/config.json:29-41)."""

    n_mel_channels: int = 80
    hop_length: int = 160
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_n_layers: int = 8
    wn_n_channels: int = 256
    wn_kernel_size: int = 3
    upsample_kernel_size: int = 1024

    @classmethod
    def from_dict(cls, waveglow_config: Dict[str, Any]) -> "WaveGlowConfig":
        wn = waveglow_config.get("WN_config", {})
        return cls(
            n_mel_channels=waveglow_config.get("n_mel_channels", 80),
            hop_length=waveglow_config.get("hop_length", 160),
            n_flows=waveglow_config.get("n_flows", 12),
            n_group=waveglow_config.get("n_group", 8),
            n_early_every=waveglow_config.get("n_early_every", 4),
            n_early_size=waveglow_config.get("n_early_size", 2),
            wn_n_layers=wn.get("n_layers", 8),
            wn_n_channels=wn.get("n_channels", 256),
            wn_kernel_size=wn.get("kernel_size", 3),
        )
