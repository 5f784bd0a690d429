"""Test configuration: run the suite on a virtual 8-device CPU mesh with
float64 enabled, so multi-device sharding and solver-oracle comparisons can
run without accelerator hardware (SURVEY.md section 4 strategy (b)).

The CPU platform is forced via jax.config *after* importing jax, so the
suite stays on the CPU even where an accelerator plugin is installed or
``JAX_PLATFORMS`` says otherwise.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# fast / slow partition.
#
# ``pytest -m fast`` is the <2-minute iteration loop; ``-m slow`` (or no
# marker filter) runs the full oracle/parity suite (~30 min on this 2-core
# box, XLA compiles dominate).  The partition is centralised here as an
# explicit list of the tests measured >10 s (pytest --durations)
# rather than scattered decorators, so the boundary is auditable in one
# place.  New expensive tests (spsolve oracles above 64^2, sharded-mesh
# parity runs, full driver workflows) belong in this list.
# ---------------------------------------------------------------------------

_SLOW_TESTS = {
    # tests/test_accuracy_gate.py — bench-scale spsolve oracles
    "test_epe_under_baseline_target_at_bench_scale",
    "test_epe_of_batched_movie_solve_every_pair",
    # tests/test_accuracy_1024.py — config-2 scale f64 FGMRES oracle
    "test_1024_epe_vs_f64_fgmres_oracle",
    # tests/test_parallel.py — 8-device virtual-mesh parity
    "test_sharded_multigrid_parity_and_iterations",
    "test_sharded_variational_matches_single_device",
    "test_sharded_xla_matvec_parity",
    # tests/test_analysis.py — batched sweeps + movie writers
    "test_batched_sweep_matches_serial",
    "test_batched_sweep_chunk_invariance",
    "test_sweep_saves_and_plots",
    "test_viz_overlay_movies",
    "test_viz_convergence_plots",
    # tests/test_physics.py — cross-implementation physics oracles
    "test_vortex_pair_cross_implementation",
    "test_recovers_nonuniform_remodelling_ramp",
    # tests/test_distributed.py — real two-process jax.distributed run
    "test_two_process_distributed_solve_matches_single",
    # tests/test_variational.py — full-solve oracle comparisons
    "test_warm_start_two_pass_matches_cold_when_converged",
    "test_warm_start_cold_matches_sequential_when_converged",
    "test_fgmres_f32_matches_bicgstab_f32",
    "test_fgmres_truncation_guard_parity",
    "test_krylov_matches_direct_path",
    "test_recovers_uniform_translation",
    "test_bicgstab_solves_reference_system",
    "test_fgmres_solves_reference_system",
    # tests/test_utils.py / test_workflows.py — full driver workflows
    "test_profile_solve_phases_smoke",
    "test_drivers_cli_file_experiment",
    "test_threshold_movies_cli",
    "test_correct_intensity_flag_changes_flow",
    "test_vortex_pair_cli",
    "test_dual_channel_cache_resume",
    "test_dual_channel_cli",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS or item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)
