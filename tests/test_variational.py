"""End-to-end variational flow: Krylov solve vs the assembled direct-solve
oracle, and synthetic ground-truth recovery."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg

from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.core.types import SolverConfig
from opticalflow_tpu.flow.variational import variational_optical_flow, solve_frame_pair
from opticalflow_tpu.ops import elop
from opticalflow_tpu.solve import direct
from tests.oracles import reference_el_system


@pytest.fixture(scope="module")
def small_movie():
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=24, width=10.0, sigma=2.5, v_x=0.2, v_y=0.1
    )
    return movie * 100.0, delta_x  # intensity scale matters for conditioning


def test_bicgstab_solves_reference_system(small_movie):
    movie, _ = small_movie
    a_s, a_r = 100.0, 100.0
    prev, cur = jnp.asarray(movie[0]), jnp.asarray(movie[1])
    n_i, n_j = prev.shape

    u0 = jnp.zeros((3, n_i, n_j))
    u, info = solve_frame_pair(prev, cur, u0, a_s, a_r, rtol=1e-10)
    assert bool(info["converged"])

    A_ref, b_ref = reference_el_system(movie[0], movie[1], a_s, a_r, compat_dy=True)
    x_ref = scipy.sparse.linalg.spsolve(A_ref, b_ref)
    u_ref = direct.flat_to_fields(x_ref, n_i, n_j)
    # compare interiors (the engine applies the corner BC fix-up after solving,
    # like the reference :1163-1166; interiors must match tightly)
    epe = np.sqrt(
        (np.asarray(u[0]) - u_ref[0])[1:-1, 1:-1] ** 2
        + (np.asarray(u[1]) - u_ref[1])[1:-1, 1:-1] ** 2
    )
    assert epe.max() < 1e-6


@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_krylov_matches_direct_path(small_movie, dy_mode):
    movie, delta_x = small_movie
    kwargs = dict(
        delta_x=delta_x,
        delta_t=1.0,
        speed_alpha=100.0,
        remodelling_alpha=100.0,
        dy_mode=dy_mode,
    )
    res_krylov = variational_optical_flow(
        movie, solver=SolverConfig(rtol=1e-12), **kwargs
    )
    res_direct = variational_optical_flow(movie, use_direct_solver=True, **kwargs)
    assert res_krylov["converged"]
    np.testing.assert_allclose(res_krylov["v_x"], res_direct["v_x"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(res_krylov["v_y"], res_direct["v_y"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        res_krylov["remodelling"], res_direct["remodelling"], rtol=1e-5, atol=1e-8
    )
    np.testing.assert_allclose(
        res_krylov["L1_functional"], res_direct["L1_functional"], rtol=1e-4
    )


def test_result_contract_keys(small_movie):
    movie, delta_x = small_movie
    res = variational_optical_flow(movie, delta_x=delta_x, speed_alpha=100.0,
                                   remodelling_alpha=100.0)
    for key in ["v_x", "v_y", "speed", "remodelling", "original_data", "blurred_data",
                "delta_x", "delta_t", "converged", "L1_functional",
                "remodelling_functional", "speed_functional"]:
        assert key in res, key
    # compat mode reproduces the reference's speed_functional defect (:1205)
    assert res["speed_functional"] == res["remodelling_functional"]
    assert res["v_x"].shape == (movie.shape[0] - 1, movie.shape[1], movie.shape[2])


def test_recovers_uniform_translation(small_movie):
    """Variational flow on a translating blob should recover the imposed
    velocity in the blob's support (dy_mode='fixed' for physical accuracy)."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=2, dimension=40, width=10.0, sigma=2.0, v_x=0.12, v_y=0.0
    )
    res = variational_optical_flow(
        movie * 100.0, delta_x=delta_x, delta_t=1.0, speed_alpha=5e3,
        remodelling_alpha=5e3, dy_mode="fixed",
    )
    mask = movie[1] > 20.0 / 100.0
    vx_est = np.median(res["v_x"][0][mask])
    assert abs(vx_est - 0.12) < 0.04


def test_warm_start_cold_matches_sequential_when_converged(small_movie):
    movie, delta_x = small_movie
    kwargs = dict(delta_x=delta_x, speed_alpha=100.0, remodelling_alpha=100.0,
                  solver=SolverConfig(rtol=1e-12))
    res_seq = variational_optical_flow(movie, warm_start="sequential", **kwargs)
    res_cold = variational_optical_flow(movie, warm_start="cold", **kwargs)
    np.testing.assert_allclose(res_seq["v_x"], res_cold["v_x"], rtol=1e-4, atol=1e-7)


def test_low_alpha_regime_uses_direct_solver(small_movie):
    """At very weak regularisation the data term dominates and the system
    needs ILU/AMG-class preconditioning (the reference's own low-alpha
    workload — the shgo tuner, ref analyse_variational_optical_flow.py:633-660
    — runs with use_direct_solver=True).  The engine mirrors that guidance:
    the direct path must handle it."""
    movie, delta_x = small_movie
    res = variational_optical_flow(
        movie, delta_x=delta_x, speed_alpha=1.0, remodelling_alpha=10.0,
        use_direct_solver=True,
    )
    assert np.isfinite(res["v_x"]).all()


def test_fgmres_solves_reference_system(small_movie):
    """FGMRES(32) + multigrid matches the assembled f64 spsolve oracle.

    FGMRES is the robust large-grid method (f32 BiCGStab recurrences
    collapse at >= 512^2 — see solve.krylov.fgmres); here it must agree
    with the oracle on the small system like BiCGStab does.
    """
    movie, _ = small_movie
    a_s, a_r = 100.0, 100.0
    prev, cur = jnp.asarray(movie[0]), jnp.asarray(movie[1])
    n_i, n_j = prev.shape

    u0 = jnp.zeros((3, n_i, n_j))
    u, info = solve_frame_pair(prev, cur, u0, a_s, a_r, rtol=1e-10, method="gmres")
    assert bool(info["converged"])

    A_ref, b_ref = reference_el_system(movie[0], movie[1], a_s, a_r, compat_dy=True)
    x_ref = scipy.sparse.linalg.spsolve(A_ref, b_ref)
    u_ref = direct.flat_to_fields(x_ref, n_i, n_j)
    epe = np.sqrt(
        (np.asarray(u[0]) - u_ref[0])[1:-1, 1:-1] ** 2
        + (np.asarray(u[1]) - u_ref[1])[1:-1, 1:-1] ** 2
    )
    assert epe.max() < 1e-6


def test_fgmres_f32_matches_bicgstab_f32(small_movie):
    """The two production methods agree in f32 to solver tolerance, and
    gmres needs no more total iterations (it is the cheaper per-iteration
    method: 1 matvec + 1 V-cycle vs BiCGStab's 2 + 2)."""
    movie, _ = small_movie
    prev = jnp.asarray(movie[0], jnp.float32)
    cur = jnp.asarray(movie[1], jnp.float32)
    u0 = jnp.zeros((3,) + prev.shape, jnp.float32)
    u_g, info_g = solve_frame_pair(
        prev, cur, u0, 100.0, 100.0, method="gmres",
        high_precision_reductions=False,
    )
    u_b, info_b = solve_frame_pair(
        prev, cur, u0, 100.0, 100.0, method="bicgstab",
        high_precision_reductions=False,
    )
    assert bool(info_g["converged"]) and bool(info_b["converged"])
    np.testing.assert_allclose(np.asarray(u_g), np.asarray(u_b), atol=2e-4)


def test_fgmres_truncation_guard_parity(small_movie):
    """The restart-cycle truncation guard must be a pure
    optimisation: on a healthy solve (Arnoldi estimate and true residual
    agree) the guarded solver takes the identical iterates and iteration
    count as the always-evaluate path — it just skips two true-residual
    evaluations per cycle (j+4 -> j+2 matvecs)."""
    import functools

    from opticalflow_tpu.solve import krylov, multigrid

    movie, _ = small_movie
    prev, cur = jnp.asarray(movie[0]), jnp.asarray(movie[1])
    # production intensity normalisation (flow.variational:195-200)
    s = jnp.max(jnp.abs(prev))
    pair = elop.compute_frame_pair_data(prev / s, cur / s, 100.0 / s**2, 100.0, "compat")
    matvec = functools.partial(elop.el_matvec_reduced, pair.coeffs)
    b_red = pair.rhs[:, 1:-1, 1:-1]
    m, n = b_red.shape[1], b_red.shape[2]
    h = multigrid.setup(matvec, elop.diag_blocks(pair.coeffs), m, n, b_red.dtype)
    precond = functools.partial(multigrid.v_cycle, h, sweeps=2)
    kwargs = dict(precond=precond, rtol=1e-10, restart=16, max_iterations=400)
    res_guarded = krylov.fgmres(matvec, b_red, truncation_guard=True, **kwargs)
    res_full = krylov.fgmres(matvec, b_red, truncation_guard=False, **kwargs)
    assert bool(res_guarded.converged) and bool(res_full.converged)
    assert int(res_guarded.iterations) == int(res_full.iterations)
    np.testing.assert_allclose(
        np.asarray(res_guarded.x), np.asarray(res_full.x), rtol=1e-7, atol=1e-12
    )


def test_warm_start_two_pass_matches_cold_when_converged(small_movie):
    """'two-pass' (SURVEY section 2.4 middle ground: pair 0 solo, rest
    batched from its solution) must land on the same converged solution as
    'cold', and pairs 1+ should not need MORE iterations than pair 0's
    cold start on this smoothly-translating movie."""
    movie, delta_x = small_movie
    kwargs = dict(delta_x=delta_x, speed_alpha=100.0, remodelling_alpha=100.0,
                  solver=SolverConfig(rtol=1e-12))
    res_cold = variational_optical_flow(movie, warm_start="cold", **kwargs)
    res_tp = variational_optical_flow(movie, warm_start="two-pass", **kwargs)
    np.testing.assert_allclose(res_tp["v_x"], res_cold["v_x"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(res_tp["remodelling"], res_cold["remodelling"],
                               rtol=1e-4, atol=1e-7)
    assert res_tp["converged_all"].all()
    assert res_tp["iterations"].shape == res_cold["iterations"].shape
    # the broadcast warm start removes Krylov work from the batched pairs
    assert int(res_tp["iterations"][1:].max()) <= int(res_cold["iterations"].max())


def test_method_auto_resolution():
    """'auto' pins BiCGStab below the measured f32-collapse threshold and
    FGMRES+MG at/above it."""
    from opticalflow_tpu.flow.variational import resolve_method

    assert resolve_method("auto", 254, 254) == "bicgstab"
    assert resolve_method("auto", 510, 510) == "gmres"
    assert resolve_method("auto", 1022, 1022) == "gmres"
    assert resolve_method("auto", 254, 510) == "gmres"  # longest axis rules
    assert resolve_method("bicgstab", 1022, 1022) == "bicgstab"  # explicit wins
    assert resolve_method("gmres", 24, 24) == "gmres"


def test_method_auto_solves_small_system(small_movie):
    movie, delta_x = small_movie
    res = variational_optical_flow(
        movie, delta_x=delta_x, speed_alpha=100.0, remodelling_alpha=100.0,
        solver=SolverConfig(method="auto"),
    )
    assert res["converged_all"].all()


@pytest.mark.parametrize("matvec", ["pallas", "hybrid"])
def test_removed_matvec_options_raise(matvec):
    """The Pallas matvec variants are gone; asking for one is an error,
    not a silent fallback."""
    with pytest.raises(ValueError, match="removed"):
        SolverConfig(matvec=matvec)
