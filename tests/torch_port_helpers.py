"""Shared pieces of the port's CPU tests (tests/test_torch_port_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

import fac_via_ppg_tpu.models.tacotron2 as jax_tacotron2

# A Tacotron2 narrow enough for the CPU (the shape of tests/test_fused.py's).
TINY_T2 = dict(
    n_symbols=16, symbols_embedding_dim=16, encoder_embedding_dim=16,
    decoder_rnn_dim=12, prenet_dim=8, attention_rnn_dim=12,
    attention_dim=8, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=16,
    max_decoder_steps=20,
)


def record_prenet_masks(monkeypatch):
    """Replace the JAX Tacotron2's dropout with one that draws the same
    bits and records each enabled keep-mask in call order, through an
    ordered host callback, so that jitted loops record every step.  Call
    `jax.effects_barrier()` before reading the list.

    Every dropout call of the JAX Tacotron2 module goes through it: at
    inference the prenet's alone; in training (`tacotron2_forward`,
    `training=True`) also the encoder convs', the attention and decoder
    LSTM states' (4 a step) and the postnet's, in the order the port's
    `masks=` takes them."""
    masks = []

    def dropout(key, x, rate, enabled):
        if not enabled or rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = jax.random.bernoulli(key, keep, x.shape)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask,
                           ordered=True)
        return jnp.where(mask, x / keep, 0.0)

    monkeypatch.setattr(jax_tacotron2, "dropout", dropout)
    return masks
