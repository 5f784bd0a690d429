"""Independent accuracy evidence at BASELINE config-2 scale.

The bench's 1024^2 record judges convergence on the engine's own df32
true residual; the f64 spsolve oracle is impractical at 3.1M unknowns
(memory/hours).  This test supplies the independent oracle a different
way: the ENGINE'S OWN f64 mode — FGMRES+MG at rtol 1e-10, f64 fields,
f64 reductions — solved on CPU, against which the production f32+df32
path must land within the BASELINE EPE target of 1e-3 px.

Why this is a valid oracle: at rtol 1e-10 in f64 the Krylov solution is
determined by the system alone (the residual bound leaves ~1e-10
relative slack, orders below the 1e-3 target), and both solves consume
the *identical* frame data (integer-valued synthetic frames rounded
through f32, exactly representable in both dtypes), so the comparison
isolates the f32+df32 pipeline's error exactly like the reference's
PETSc-f64-vs-anything comparison would (ref optical_flow.py:1117-1142
rtol/max_it semantics).

Scale anchor: the 1024^2 embryo movie of
/root/reference/analysis/analyse_variational_optical_flow.py:203-205.
Runs on the CPU backend (conftest); marked slow — several minutes of
while_loop stepping at 3.1M unknowns.
"""

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.flow.variational import solve_frame_pair

DIM = 1024
ALPHA = 1000.0


def _movie():
    # the bench's width-scaled blob (see bench.py make_movie for why the
    # width scales with the grid), rounded through f32 so both dtypes see
    # identical data
    movie, _ = make_translating_blob_movie(
        n_frames=2, dimension=DIM, width=20.0 * DIM / 256, sigma=3.0,
        v_x=0.15, v_y=0.1, dtype=np.float64,
    )
    return np.asarray(np.asarray(movie, np.float64) * 100.0, np.float32)


def test_1024_epe_vs_f64_fgmres_oracle():
    movie = _movie()
    u0 = jnp.zeros((3, DIM, DIM), jnp.float64)

    # oracle: engine's f64 mode, tolerance 4 orders below the EPE target
    u_ref, info_ref = solve_frame_pair(
        jnp.asarray(movie[0], jnp.float64), jnp.asarray(movie[1], jnp.float64),
        u0, ALPHA, ALPHA, method="gmres", rtol=1e-10,
        refinement_restarts=0,
    )
    assert bool(info_ref["converged"]), (
        f"f64 oracle did not converge: {info_ref}"
    )

    # production path: f32 fields + df32 iterative refinement, all
    # defaults (refinement_exit_factor resolves to 0.03 at this scale —
    # the 0.1 bench-scale exit measured EPE 1.325e-3 px here, above
    # target, which is what motivated the scale-aware default)
    u_prod, info_prod = solve_frame_pair(
        jnp.asarray(movie[0], jnp.float32), jnp.asarray(movie[1], jnp.float32),
        jnp.zeros((3, DIM, DIM), jnp.float32), ALPHA, ALPHA,
        method="auto",
    )
    assert bool(info_prod["converged"]), (
        f"production path did not converge: {info_prod}"
    )

    d = np.asarray(u_prod, np.float64) - np.asarray(u_ref, np.float64)
    epe = np.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max()
    # BASELINE config-2 target: EPE < 1e-3 px vs the f64 solution
    assert epe < 1e-3, f"EPE {epe:.3e} px >= 1e-3 vs f64 FGMRES oracle"
