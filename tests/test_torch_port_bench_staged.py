"""The port's benchmark against the JAX package's root `bench.py`, tiny on
the CPU: the staged end-to-end latency and the PPG2Mel train step, the
two configurations whose JAX compiles take longest (the rest are in
tests/test_torch_port_bench.py, which states the comparison).
"""

import pytest

from tests.torch_port_bench_cases import (  # noqa: F401 (fixtures)
    bundle,
    check_line,
    jax_tiny,
    t_models,
)


@pytest.mark.parametrize("config", ["e2e", "train_ppg2mel"])
def test_bench_staged_line_has_the_jax_keys(config, t_models, jax_tiny):
    check_line(config, t_models)
