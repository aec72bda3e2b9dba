"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh: the TPU-native answer to "test
multi-chip behavior without a pod" is XLA's host-platform device-count
override, which gives real (if slow) executions of the same sharded
programs that run on ICI-connected chips.
"""

import os

# Must be set before jax initializes its backends.  Force CPU even when the
# session environment points at a TPU: tests must be hermetic and exercise
# the 8-device mesh.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# The session's TPU plugin force-selects its platform regardless of the env
# var; the config option wins.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.default_backend() == "cpu", jax.devices()
assert jax.device_count() == 8, jax.devices()


@pytest.fixture
def rng():
    return np.random.RandomState(16807)


# --------------------------------------------------------------------------
# Two test tiers (measured on the 1-core CI box, round 5):
#   fast (default)      `pytest -q`            7:20 (203 tests, incl.
#                       toy smokes of every slow family —
#                       tests/test_smoke_families.py)
#   slow (opt-in)       `RUN_SLOW=1 pytest -q` 34:35-43:21 across two
#                       round-5 runs, everything (255)
# The slow tier holds the tests individually measured >= ~12 s — mostly
# 8-device-CPU-mesh train-step compiles (DP/TP/ZeRO equivalence, remat,
# bf16, CLI e2e, multiprocess workers) and the full-size oracle parity
# suite.  They are still first-class: run the slow tier before committing
# anything that touches training, sharding, or serving internals.
# Names below were taken from `--durations` of a full run; keep them in
# sync when adding expensive tests.
# --------------------------------------------------------------------------

SLOW_BY_NAME = {
    # multi-process workers (real OS processes, gloo rendezvous): BOTH
    # params are slow-tier — the 2-process variant alone measures 364 s
    # on this box (N concurrent XLA compiles + a single-process replay).
    # Default-tier coverage of sharded execution comes from the
    # single-process smoke tests (tests/test_smoke_families.py).
    "test_multi_process_dp_matches_single_process",
    # trainer CLI end-to-end
    "test_train_ppg2mel_cli_end_to_end",
    "test_train_waveglow_cli_end_to_end",
    "test_train_waveglow_cli_tensor_parallel",
    "test_train_waveglow_cli_zero_sharded_opt",
    "test_train_waveglow_lr_schedule_wired",
    "test_train_ppg2mel_preemption_checkpoint",
    "test_generate_synthesis_cli_cond_impl_auto",
    "test_train_waveglow_preemption_checkpoints_and_resumes",
    # 8-device mesh equivalence (compile-dominated on 1 core)
    "test_data_parallel_step_matches_single_device",
    "test_tacotron2_tp_step_matches_single_device",
    "test_waveglow_tp_step_matches_single_device",
    "test_zero_sharded_opt_state_matches_replicated",
    "test_zero_sharded_opt_state_composes_with_tp",
    "test_dp_bf16_grad_accum_compose",
    "test_data_parallel_vocoder_serving",
    # heavy single-device train-step A/Bs
    "test_grad_accum_matches_full_batch",
    "test_tacotron2_bf16_train_step",
    "test_waveglow_bf16_train_step",
    "test_bf16_ppg_host_cast_matches_device_cast",
    "test_tacotron2_remat_matches_unremat",
    "test_waveglow_remat_matches_unremat",
    "test_tacotron2_train_step_decreases_loss",
    "test_gradients_flow_everywhere",
    "test_training_is_seed_deterministic",
    "test_checkpoint_roundtrip",
    "test_checkpoint_topology_change_restore",
    "test_adam_matches_torch",
    "test_loss_and_gradients",
    "test_select_cond_impl_hostile_checkpoint",
    # streaming serving integration
    "test_streaming_pipeline_depth_is_transparent",
    "test_streaming_prewarm_is_transparent",
    "test_streaming_error_isolation",
    "test_streaming_source_is_lazy",
    "test_streaming_micro_batched",
    "test_streaming_pipeline",
    "test_fused_cond_impl_int8_close_to_dense",
    # torch-oracle parity (small; full-size file is marked in-file)
    "test_tacotron2_forward_matches_reference",
    "test_tacotron2_autoregressive_inference_matches_reference",
    "test_tacotron2_export_loads_in_reference",
    # misc heavy integration
    "test_tensorboard_loggers_write_events",
    "test_duration_check_reports_rows_and_summary",
    "test_runbook_chain_on_substitute_artifacts",
    "test_runbook_cli_and_flat_layout",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: expensive tests (the ~12s+ tier; skipped by default, run "
        "with RUN_SLOW=1 or an explicit -m expression)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one",
    )


def pytest_collection_modifyitems(config, items):
    run_slow = os.environ.get("RUN_SLOW", "") not in ("", "0")
    # an explicit -m expression (e.g. -m slow / -m 'not slow') takes over
    # tier selection entirely
    explicit_m = bool(config.getoption("-m", default=""))
    skip = pytest.mark.skip(
        reason="slow tier: set RUN_SLOW=1 (or select with -m slow)"
    )
    for item in items:
        base = item.name.split("[")[0]
        if base in SLOW_BY_NAME and not item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.slow)
        if item.get_closest_marker("slow") and not run_slow \
                and not explicit_m:
            item.add_marker(skip)
