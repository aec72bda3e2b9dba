"""PyTorch/CUDA port of fac_via_ppg_tpu for NVIDIA Hopper.

Imports torch, numpy and scipy only: never jax and never fac_via_ppg_tpu.
Entry points take `device=None`, meaning "cuda", and raise when CUDA is
absent; tests pass device="cpu".
"""
