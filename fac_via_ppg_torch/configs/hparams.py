"""Model configurations (copies of fac_via_ppg_tpu/configs/hparams.py's
Tacotron2Config and WaveGlowConfig; the port keeps its own)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


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
