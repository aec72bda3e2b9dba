import os

# The WaveGlow trainer's 4-section config (reference src/waveglow/
# config.json), the port's copy of the JAX package's.
DEFAULT_WAVEGLOW_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "waveglow_config.json")
