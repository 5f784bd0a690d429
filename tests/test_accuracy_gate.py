"""EPE regression gate at bench scale.

An EPE regression above the <1e-3 px BASELINE target once shipped
silently because every EPE-checking test ran at 24^2-40^2 while
bench.py measures 256^2.  This gate solves one 256^2 frame pair through
the production f32 path — same dtype, same tol floor, and *f32 dot
products* (high_precision_reductions off, mimicking a production run with
x64 off) — and asserts the flow endpoint error against the f64
assembled direct solve stays inside the BASELINE config-2 target.
"""

import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla

from opticalflow_tpu.flow.variational import _solve_movie, solve_frame_pair
from opticalflow_tpu.solve.direct import assemble_el_matrix, fields_to_flat, flat_to_fields

from bench import make_movie, numpy_pair_data, ALPHA_S, ALPHA_R

EPE_TARGET_PX = 1e-3  # BASELINE.md config 2


def test_epe_under_baseline_target_at_bench_scale():
    movie, _ = make_movie(2, 256, np.float64)

    # production path: f32 fields, f32 reductions, default floor/restarts
    prev = jnp.asarray(movie[0], jnp.float32)
    cur = jnp.asarray(movie[1], jnp.float32)
    u0 = jnp.zeros((3, 256, 256), jnp.float32)
    u, info = solve_frame_pair(
        prev, cur, u0, jnp.float32(ALPHA_S), jnp.float32(ALPHA_R),
        high_precision_reductions=False,
    )
    assert bool(info["converged"])

    # f64 oracle
    coeffs, rhs = numpy_pair_data(movie[0], movie[1], ALPHA_S, ALPHA_R)
    mat = assemble_el_matrix(coeffs, 256, 256).tocsr()
    x = spla.spsolve(mat, fields_to_flat(rhs))
    u_ref = flat_to_fields(x, 256, 256)

    d = np.asarray(u) - u_ref
    epe = float(np.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max())
    assert epe < EPE_TARGET_PX, f"EPE {epe:.2e} px exceeds {EPE_TARGET_PX} px"


def test_epe_of_batched_movie_solve_every_pair():
    """An EPE regression once lived ONLY in the batched path — vmapped
    ``_solve_movie`` with the adaptive refinement ``lax.while_loop``,
    whose batching semantics differ from
    the solo solve the old gate covered.  This gate runs the exact bench
    code path (vmapped batch, refinement on, f32 fields + f32 reductions)
    and asserts EVERY pair's EPE against its own f64 direct oracle.

    128^2 x 12 pairs keeps the CPU suite affordable; the while_loop
    batching behaviour being gated is size-independent (the 256^2 x 12
    batch is checked on the GPU by chip_smoke.py's batch_256 phase)."""
    dim, n_pairs = 128, 12
    movie, _ = make_movie(n_pairs + 1, dim, np.float64)

    u0 = jnp.zeros((3, dim, dim), jnp.float32)
    all_u, infos = _solve_movie(
        jnp.asarray(movie, jnp.float32), u0, jnp.float32(ALPHA_S),
        jnp.float32(ALPHA_R), "compat", "bicgstab", "multigrid", 1e-6,
        1000, False, "cold",
    )
    all_u = np.asarray(all_u)
    assert np.asarray(infos["converged"]).all()

    epes = []
    for k in range(n_pairs):
        coeffs, rhs = numpy_pair_data(movie[k], movie[k + 1], ALPHA_S, ALPHA_R)
        mat = assemble_el_matrix(coeffs, dim, dim).tocsr()
        u_ref = flat_to_fields(spla.spsolve(mat, fields_to_flat(rhs)), dim, dim)
        d = all_u[k] - u_ref
        epes.append(float(np.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max()))
    worst = max(epes)
    assert worst < EPE_TARGET_PX, f"worst batched EPE {worst:.2e} px (all: {epes})"
