"""Flagship variational optical flow (velocity + net remodelling).

On-device re-design of the reference's ``variational_optical_flow``
(/root/reference/source/optical_flow.py:715-1210).  Per frame pair the
reference assembles a ``3*Ni*Nj`` sparse system on the host and solves it
with PETSc BiCGStab; here the system never materialises — derivative
planes, coefficient planes, the matrix-free stencil matvec, the
block-Jacobi preconditioner and the whole Krylov iteration are one fused
XLA computation per frame pair, scanned over the movie with the
reference's warm-start chain (ref :799-806) as the scan carry.

Modes:
* ``warm_start='sequential'`` — reproduce the reference semantics (each
  pair starts from the previous pair's solution); ``lax.scan``.
* ``warm_start='cold'`` — every pair starts from the initial guess;
  frame pairs become independent and are batched with ``vmap`` (and can be
  sharded across devices, see ``parallel``).
* ``warm_start='two-pass'`` — pair 0 is solved first and its solution is
  broadcast as the initial guess of the batched remaining pairs: most of
  the warm-start iteration savings at full batch parallelism (SURVEY
  section 2.4 middle ground).
* ``use_direct_solver=True`` — host-side assembled spsolve (small images;
  parity with ref :1147 and the correctness oracle).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core import stencils
from opticalflow_tpu.core.types import FlowResult, SolverConfig
from opticalflow_tpu.ops import elop
from opticalflow_tpu.ops.blur import blur_movie
from opticalflow_tpu.solve import krylov, multigrid
from opticalflow_tpu.utils import observability


def _functionals(u, pair: elop.FramePairData, speed_alpha, remodelling_alpha, dy_mode):
    """Data/regulariser functionals of a solved pair (ref :1167-1183).

    Evaluated on the BC-fixed fields in pixel units, with the same dy rule
    the operator used.
    """
    v_x, v_y, g = u[0], u[1], u[2]
    dvx_dx = stencils.ddx(v_x)
    dvx_dy = stencils.ddy(v_x, mode=dy_mode)
    dvy_dx = stencils.ddx(v_y)
    dvy_dy = stencils.ddy(v_y, mode=dy_mode)
    dg_dx = stencils.ddx(g)
    dg_dy = stencils.ddy(g, mode=dy_mode)
    I = pair.I_interior
    data_residual = (
        pair.dIdt
        + v_x[1:-1, 1:-1] * pair.dIdx
        + v_y[1:-1, 1:-1] * pair.dIdy
        + I * dvx_dx
        + I * dvy_dy
        - g[1:-1, 1:-1]
    )
    l1 = jnp.sum(data_residual**2)
    speed_f = speed_alpha * jnp.sum(dvx_dx**2 + dvx_dy**2 + dvy_dx**2 + dvy_dy**2)
    rem_f = remodelling_alpha * jnp.sum(dg_dx**2 + dg_dy**2)
    return l1, speed_f, rem_f


def resolve_method(method: str, m: int, n: int) -> str:
    """Resolve ``method='auto'`` to a concrete Krylov solver by grid size.

    f32 BiCGStab's coupled two-term recurrences disintegrate as the grid
    grows (on the bench EL systems the recursive residual 'converges'
    while the true residual stalls at 512^2 and collapses at 1024^2 — see
    solve.krylov.fgmres notes), while FGMRES+MG minimises the true
    residual monotonically by construction.  So 'auto' picks BiCGStab
    below 500 interior points on the longest axis (faster per iteration,
    reliable there) and FGMRES at/above it.
    """
    if method != "auto":
        return method
    return "bicgstab" if max(m, n) < 500 else "gmres"


def solve_frame_pair(
    previous_frame: jnp.ndarray,
    current_frame: jnp.ndarray,
    u0: jnp.ndarray,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
    method: str = "bicgstab",
    preconditioner: str = "multigrid",
    rtol: float = 1e-6,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    refinement_restarts: int = 8,
    tol_floor: float = 300.0,
    refinement_rtol: float = 0.2,
    matvec_factory=None,
    gmres_restart: int = 32,
    refinement_exit_factor=None,
):
    """Solve the coupled EL system for one frame pair (pixel units).

    Returns ``(u, info)`` where ``u`` is the BC-fixed (3, Ni, Nj) solution
    and ``info`` is a dict of scalars (iterations, residual_norm,
    converged, functionals).

    The matvec is the XLA-fused stencil ``elop.el_matvec_reduced``.
    Under spatial tiling it runs as a shard_map with a single two-phase
    ppermute halo exchange per application instead — the sharded path
    passes ``matvec_factory`` (parallel.halo).

    Intensity normalisation: the EL system built from ``(I/s,
    speed_alpha/s^2, remodelling_alpha)`` has the exact solution
    ``(u_x, u_y, gamma/s)`` of the original system (every velocity-row
    term is quadratic in I and every gamma-row term linear), and all
    three functionals scale by ``s^2``.  Solving the normalised system
    keeps coefficients O(1): with raw microscopy intensities (~1e2) and
    practice alphas (~1e3) the unnormalised f32 Krylov recurrences mix
    magnitudes of 1e0..1e8 and stall (512^2) or overflow to NaN (1024^2)
    while the f64 solve converges fine.
    """
    # f32 matmuls may run in reduced precision (TF32 on the GPU's tensor
    # cores, about three decimal digits); every matmul traced in the solve
    # (Gram-Schmidt projections, coarse LU/triangular solves) is
    # precision-critical, so pin HIGHEST for the whole trace.  Elementwise
    # stencil math is unaffected.
    with jax.default_matmul_precision("highest"):
        return _solve_frame_pair_impl(
            previous_frame, current_frame, u0, speed_alpha, remodelling_alpha,
            dy_mode, method, preconditioner, rtol, max_iterations,
            high_precision_reductions, refinement_restarts,
            tol_floor, refinement_rtol, matvec_factory, gmres_restart,
            refinement_exit_factor,
        )


def _solve_frame_pair_impl(
    previous_frame,
    current_frame,
    u0,
    speed_alpha,
    remodelling_alpha,
    dy_mode,
    method,
    preconditioner,
    rtol,
    max_iterations,
    high_precision_reductions,
    refinement_restarts,
    tol_floor,
    refinement_rtol,
    matvec_factory,
    gmres_restart=32,
    refinement_exit_factor=None,
):
    dtype = jnp.asarray(previous_frame).dtype
    intensity_scale = jnp.maximum(
        jnp.max(jnp.abs(previous_frame)), jnp.asarray(1e-30, dtype)
    ).astype(dtype)
    raw_prev, raw_cur = previous_frame, current_frame
    raw_speed_alpha = jnp.asarray(speed_alpha, dtype)
    previous_frame = previous_frame / intensity_scale
    current_frame = current_frame / intensity_scale
    speed_alpha = raw_speed_alpha / intensity_scale**2
    u0 = jnp.concatenate([u0[:2], u0[2:] / intensity_scale], axis=0)

    with jax.named_scope("el_pair_data"):
        pair = elop.compute_frame_pair_data(
            previous_frame, current_frame, speed_alpha, remodelling_alpha, dy_mode
        )
    # Solve the *reduced* system: boundary constraint rows folded into the
    # interior stencil (exact — see ops.elop), so the Krylov iteration and
    # the multigrid hierarchy see a pure 9-point stencil operator.
    xla_matvec = functools.partial(elop.el_matvec_reduced, pair.coeffs)
    b_red = pair.rhs[:, 1:-1, 1:-1]
    u0_red = u0[:, 1:-1, 1:-1]
    m, n = b_red.shape[1], b_red.shape[2]
    method = resolve_method(method, m, n)

    if matvec_factory is not None:
        # Spatially tiled solve (parallel.halo): the factory closes over
        # the mesh and returns an interior-layout matvec that shard_maps
        # the stencil with ppermute halo exchange.  Krylov state stays in
        # interior layout under GSPMD; only the matvec drops into manual
        # SPMD.
        matvec = matvec_factory(
            previous_frame, speed_alpha, remodelling_alpha, dy_mode
        )
    else:
        matvec = xla_matvec

    # Smoothing strength scales with the grid: 2 damped block-Jacobi
    # sweeps per half-cycle below 500 interior points, 4 at/above.  At
    # 1024^2 two sweeps leave the f32 FGMRES correction solves stalled
    # above tol — the Arnoldi least-squares estimate reports a reduction
    # the true residual does not show, an f32 Hessenberg-algebra
    # breakdown on the poorly-conditioned preconditioned system — while
    # four keep the corrections contracting and cut main-solve
    # iterations (checked against the f64 oracle by
    # tests/test_accuracy_1024.py and chip_smoke.py's embryo_1024 phase).
    mg_sweeps = 2 if max(m, n) < 500 else 4

    if preconditioner == "block_jacobi":
        precond = functools.partial(
            elop.block_jacobi_inverse_apply_interior, pair.coeffs
        )
    elif preconditioner == "multigrid":
        # hierarchy probing vmaps the fine matvec over 27 comb vectors, so
        # it always probes the plain XLA operator; a tiled solve smooths
        # its fine level with the halo-exchange matvec.
        with jax.named_scope("mg_setup"):
            hierarchy = multigrid.setup(
                xla_matvec, elop.diag_blocks(pair.coeffs), m, n, b_red.dtype,
                fine_smoother_matvec=matvec if matvec_factory is not None else None,
            )
        precond = functools.partial(multigrid.v_cycle, hierarchy,
                                    sweeps=mg_sweeps)
    elif preconditioner == "none":
        precond = None
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    solver_fn = {
        "bicgstab": krylov.bicgstab,
        "cg": krylov.cg,
        "gmres": functools.partial(krylov.fgmres, restart=gmres_restart),
    }[method]
    with jax.named_scope("krylov_main"):
        res = solver_fn(
            matvec,
            b_red,
            x0=u0_red,
            precond=precond,
            rtol=rtol,
            max_iterations=max_iterations,
            high_precision_reductions=high_precision_reductions,
            tol_floor_eps_multiple=tol_floor,
        )

    # Mixed-precision iterative refinement (the f32 pipeline's answer to
    # PETSc's f64 solve).  Two f32 noise floors block accuracy near the
    # 1e-3 px EPE target: the cancellative f32 matvec evaluation (the true
    # residual stalls far above f64 quality) and the f32 *computation* of
    # the coefficient planes (the perturbed system's exact solution is
    # already a few 1e-4 px away).  So each refinement step evaluates
    # b - A x against double-float system
    # data (elop.compute_frame_pair_data_df — coefficients, RHS, and the
    # normalisation division all in pair arithmetic, exact to ~eps^2),
    # with x itself carried as a hi+lo pair, then solves the correction
    # system to `refinement_rtol` with the same fused f32 matvec +
    # preconditioner.  The refinement is ADAPTIVE (lax.while_loop): it
    # exits as soon as the df32 true residual meets the floored tolerance,
    # and runs up to `refinement_restarts` steps.  Each step contracts the
    # true residual ~refinement_rtol x and the fixed point is the
    # f64-quality solution; refinement steps also act as BiCGStab
    # *restarts*, recovering pairs where f32 recurrence breakdown stalls
    # the main solve far above tolerance (tests/test_accuracy_gate.py
    # holds the refined solve to the f64 direct solve).  `converged` is
    # judged on the df32 true residual — a stricter, honest criterion
    # (plain f32 evaluation could not even measure residuals this small).
    iterations = res.iterations
    residual_norm = res.residual_norm
    converged = res.converged
    if refinement_restarts > 0:
        from opticalflow_tpu.ops import df32

        dfd = elop.compute_frame_pair_data_df(
            raw_prev, raw_cur, raw_speed_alpha, remodelling_alpha, dy_mode,
            intensity_scale,
        )
        eff_rtol = jnp.maximum(
            jnp.asarray(rtol, b_red.dtype), tol_floor * float(jnp.finfo(b_red.dtype).eps)
        )
        b_norm = jnp.sqrt(jnp.sum(b_red * b_red))
        tol_main = eff_rtol * b_norm
        x_hi0 = res.x
        x_lo0 = jnp.zeros_like(x_hi0)
        r_hi0 = elop.el_residual_df(dfd, x_hi0, x_lo0)
        r_norm0 = jnp.sqrt(jnp.sum(r_hi0.astype(b_norm.dtype) ** 2))

        if refinement_exit_factor is None:
            # Scale-aware default (same size gate as resolve_method):
            # 0.1 suffices at bench scale (256^2), but at config-2 scale
            # the worse conditioning turns the same residual slack into
            # EPE above the 1e-3 px target against an f64 FGMRES
            # rtol-1e-10 oracle (tests/test_accuracy_1024.py), which 0.03
            # meets at the cost of more correction iterations.
            refinement_exit_factor = 0.1 if max(m, n) < 500 else 0.03
        exit_tol = refinement_exit_factor * tol_main

        def ref_cond(state):
            step, _, _, _, r_norm, _, r_prev = state
            # refine `refinement_exit_factor` contractions beyond the
            # reported tolerance so the EPE keeps margin under the <1e-3 px
            # target instead of landing exactly on the tolerance boundary
            # (each extra factor of ~refinement_rtol costs one cheap
            # correction solve).
            # Stall guard: when a step makes essentially NO progress
            # (<0.1%) the f32 correction solves have hit their attainable
            # floor (the est/true Hessenberg mismatch stalls are exact) —
            # more restarts cannot help, stop burning them.  The threshold
            # is deliberately this tight: refinement steps double as
            # BiCGStab-breakdown restarts, and a recovering pair may
            # contract slowly for several steps before the cliff (a looser
            # 0.9 threshold stops exactly such a pair far from the
            # solution).
            return jnp.logical_and(
                jnp.logical_and(step < refinement_restarts, r_norm > exit_tol),
                r_norm < 0.999 * r_prev,
            )

        # Correction solves run against the df32 operator in interior
        # layout: the f32 matvec cannot resolve smooth-mode residuals once
        # eps_f32 * kappa(A) approaches 1 (~1024^2 grids), which stalls
        # refinement exactly where it is needed most — see el_matvec_df.
        # The preconditioner stays the fast f32 one (its accuracy does not
        # limit the attainable residual).
        matvec_c = functools.partial(elop.el_matvec_df, dfd)
        if preconditioner == "multigrid":
            precond_c = functools.partial(multigrid.v_cycle, hierarchy,
                                          sweeps=mg_sweeps)
        elif preconditioner == "block_jacobi":
            precond_c = functools.partial(
                elop.block_jacobi_inverse_apply_interior, pair.coeffs
            )
        else:
            precond_c = None

        def ref_body(state):
            step, x_hi, x_lo, r_hi, r_norm, iters, _ = state
            res_c = solver_fn(
                matvec_c,
                r_hi,
                x0=jnp.zeros_like(r_hi),
                precond=precond_c,
                rtol=refinement_rtol,
                max_iterations=max_iterations,
                high_precision_reductions=high_precision_reductions,
                tol_floor_eps_multiple=tol_floor,
            )
            d_int = res_c.x
            s, e = df32.two_sum(x_hi, d_int)
            x_hi_n, x_lo_n = df32.fast_two_sum(s, x_lo + e)
            r_hi_n = elop.el_residual_df(dfd, x_hi_n, x_lo_n)
            r_new = jnp.sqrt(jnp.sum(r_hi_n.astype(b_norm.dtype) ** 2))
            # Monotonicity: reject a correction that does not reduce the
            # df32 TRUE residual.  On pathological pairs (f32-unsolvable
            # correction systems) an unconditional update can inject huge
            # near-null-space components — measured: a rejected-correction
            # path returned EPE 1e4 px while the main-solve iterate it
            # replaced was 1e-1-accurate.  Rejection keeps r_new = r_norm,
            # so the stall guard in ref_cond exits on the next check.
            ok = r_new < r_norm
            x_hi_n = jnp.where(ok, x_hi_n, x_hi)
            x_lo_n = jnp.where(ok, x_lo_n, x_lo)
            r_hi_n = jnp.where(ok, r_hi_n, r_hi)
            r_new = jnp.where(ok, r_new, r_norm)
            return (step + 1, x_hi_n, x_lo_n, r_hi_n, r_new,
                    iters + res_c.iterations, r_norm)

        with jax.named_scope("refinement"):
            _, x_hi, x_lo, _, r_norm, iterations, _ = jax.lax.while_loop(
                ref_cond, ref_body,
                (jnp.asarray(0, jnp.int32), x_hi0, x_lo0, r_hi0, r_norm0,
                 iterations, jnp.full_like(r_norm0, jnp.inf)),
            )
        residual_norm = r_norm
        converged = r_norm <= tol_main
        x_int = x_hi + x_lo
    else:
        x_int = res.x
    res = krylov.KrylovResult(
        x=res.x, iterations=iterations, residual_norm=residual_norm, converged=converged
    )

    # Embed + mirror-BC fix-up, mainly for the corner rows (ref :1163-1166).
    u = elop.embed_interior(x_int)

    # Functionals of the normalised system scale uniformly by s^2.
    l1, speed_f, rem_f = _functionals(u, pair, pair.coeffs.speed_alpha,
                                      pair.coeffs.remodelling_alpha, dy_mode)
    s2 = intensity_scale**2
    # Undo the similarity scaling: gamma was solved in units of I/s.
    u = jnp.concatenate([u[:2], u[2:] * intensity_scale], axis=0)
    info = {
        "iterations": res.iterations,
        "residual_norm": res.residual_norm,
        "converged": res.converged,
        "L1_functional": l1 * s2,
        "speed_functional": speed_f * s2,
        "remodelling_functional": rem_f * s2,
    }
    return u, info


@functools.partial(
    jax.jit,
    static_argnames=("dy_mode", "method", "preconditioner", "max_iterations",
                     "high_precision_reductions", "warm_start",
                     "refinement_restarts", "gmres_restart"),
)
def _solve_movie(
    movie,
    u_init,
    speed_alpha,
    remodelling_alpha,
    dy_mode,
    method,
    preconditioner,
    rtol,
    max_iterations,
    high_precision_reductions,
    warm_start,
    refinement_restarts=8,
    tol_floor=300.0,
    refinement_rtol=0.2,
    gmres_restart=32,
    refinement_exit_factor=None,
):
    prev_frames = movie[:-1]
    cur_frames = movie[1:]

    pair_solver = functools.partial(
        solve_frame_pair,
        speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha,
        dy_mode=dy_mode,
        method=method,
        preconditioner=preconditioner,
        rtol=rtol,
        max_iterations=max_iterations,
        high_precision_reductions=high_precision_reductions,
        refinement_restarts=refinement_restarts,
        tol_floor=tol_floor,
        refinement_rtol=refinement_rtol,
        gmres_restart=gmres_restart,
        refinement_exit_factor=refinement_exit_factor,
    )

    if warm_start == "sequential":

        def step(carry_u, frames):
            prev, cur = frames
            u, info = pair_solver(prev, cur, carry_u)
            return u, (u, info)

        _, (all_u, infos) = jax.lax.scan(step, u_init, (prev_frames, cur_frames))
    elif warm_start == "cold":
        all_u, infos = jax.vmap(lambda p, c: pair_solver(p, c, u_init))(prev_frames, cur_frames)
    elif warm_start == "two-pass":
        # SURVEY section 2.4's documented middle ground between the
        # reference's serial warm-start chain (ref :803-806) and the fully
        # parallel cold start: solve pair 0 from the caller's guess, then
        # batch the remaining pairs with pair 0's solution broadcast as
        # their initial guess.  Consecutive microscopy frames are highly
        # correlated, so the broadcast guess removes most of the Krylov
        # work of every pair but the first while keeping the batch
        # embarrassingly parallel.
        u_first, info_first = pair_solver(prev_frames[0], cur_frames[0], u_init)
        if prev_frames.shape[0] > 1:
            u_rest, infos_rest = jax.vmap(lambda p, c: pair_solver(p, c, u_first))(
                prev_frames[1:], cur_frames[1:]
            )
            all_u = jnp.concatenate([u_first[None], u_rest])
            infos = jax.tree.map(
                lambda a, b: jnp.concatenate([jnp.asarray(a)[None], b]),
                info_first, infos_rest,
            )
        else:
            all_u = u_first[None]
            infos = jax.tree.map(lambda a: jnp.asarray(a)[None], info_first)
    else:
        raise ValueError(f"unknown warm_start mode {warm_start!r}")
    return all_u, infos


def variational_optical_flow(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    smoothing_sigma: Optional[float] = None,
    initial_v_x: float = 0.0,
    initial_v_y: float = 0.0,
    initial_remodelling: float = 0.0,
    use_direct_solver: bool = False,
    dy_mode: str = stencils.DY_COMPAT,
    warm_start: str = "sequential",
    solver: Optional[SolverConfig] = None,
    dtype=None,
) -> FlowResult:
    """Drop-in equivalent of the reference ``variational_optical_flow``
    (ref :715-1210): same arguments, same result-dict contract, with the
    PETSc solve replaced by the on-device matrix-free Krylov solve.

    When ``dy_mode='compat'`` (default) the reference's dy-rule defect and
    the ``speed_functional`` key duplication (ref :1205) are reproduced so
    results are comparable bit-for-bit in structure; the correctly
    computed speed functional is then stored under
    ``'speed_functional_corrected'``.
    """
    solver = solver or SolverConfig()
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    movie = jnp.asarray(movie, dtype=dtype)
    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie, smoothing_sigma=smoothing_sigma)
    else:
        movie_to_analyse = movie

    n_i, n_j = movie.shape[1], movie.shape[2]
    # Initial guess in pixel units (ref :799-802): physical -> pixel is
    # * delta_t / delta_x for velocities.
    u_init = jnp.stack(
        [
            jnp.full((n_i, n_j), float(initial_v_x) * delta_t / delta_x, dtype=dtype),
            jnp.full((n_i, n_j), float(initial_v_y) * delta_t / delta_x, dtype=dtype),
            jnp.full((n_i, n_j), float(initial_remodelling), dtype=dtype),
        ]
    )

    if use_direct_solver:
        all_u, infos = _solve_movie_direct(
            np.asarray(movie_to_analyse, dtype=np.float64),
            np.asarray(u_init, dtype=np.float64),
            speed_alpha,
            remodelling_alpha,
            dy_mode,
            warm_start,
        )
    else:
        all_u, infos = _solve_movie(
            movie_to_analyse,
            u_init,
            jnp.asarray(speed_alpha, dtype=dtype),
            jnp.asarray(remodelling_alpha, dtype=dtype),
            dy_mode,
            solver.method,
            solver.preconditioner,
            solver.rtol,
            solver.max_iterations,
            solver.high_precision_reductions,
            warm_start,
            solver.refinement_restarts,
            solver.dtype_tol_floor,
            solver.refinement_rtol,
            solver.gmres_restart,
            solver.refinement_exit_factor,
        )

    all_u = np.asarray(all_u)
    scale = delta_x / delta_t
    all_v_x = all_u[:, 0] * scale
    all_v_y = all_u[:, 1] * scale
    all_remodelling = all_u[:, 2]
    all_speed = np.sqrt(all_v_x**2 + all_v_y**2)

    l1_sum = float(np.sum(np.asarray(infos["L1_functional"])))
    rem_sum = float(np.sum(np.asarray(infos["remodelling_functional"])))
    speed_sum = float(np.sum(np.asarray(infos["speed_functional"])))
    converged_all = np.asarray(infos["converged"])

    result = FlowResult(
        v_x=all_v_x,
        v_y=all_v_y,
        speed=all_speed,
        remodelling=all_remodelling,
        original_data=np.asarray(movie),
        blurred_data=np.asarray(movie_to_analyse),
        delta_x=delta_x,
        delta_t=delta_t,
        # the reference stores only the final pair's flag (ref :1202)
        converged=bool(converged_all[-1]),
        L1_functional=l1_sum,
        remodelling_functional=rem_sum,
    )
    result["converged_all"] = converged_all
    result["iterations"] = np.asarray(infos["iterations"])
    result["residual_norms"] = np.asarray(infos["residual_norm"])
    # Structured solver telemetry (the reference prints these per pair and
    # discards them, ref :1131-1157; here they go through the module logger
    # so callers can capture/ship them).
    observability.logger.info(
        "variational solve: %d pairs %dx%d, iterations min/median/max "
        "%d/%d/%d, residual max %.3e, converged %d/%d",
        all_u.shape[0], n_i, n_j,
        int(result["iterations"].min()),
        int(np.median(result["iterations"])),
        int(result["iterations"].max()),
        float(result["residual_norms"].max()),
        int(converged_all.sum()), converged_all.size,
    )
    if dy_mode == stencils.DY_COMPAT:
        # ref defect: 'speed_functional' holds the remodelling functional (:1205)
        result["speed_functional"] = rem_sum
        result["speed_functional_corrected"] = speed_sum
    else:
        result["speed_functional"] = speed_sum
    return result


def profile_solve_phases(
    previous_frame,
    current_frame,
    speed_alpha=1000.0,
    remodelling_alpha=1000.0,
    dy_mode: str = stencils.DY_COMPAT,
    solver: Optional[SolverConfig] = None,
    reps: int = 3,
) -> dict:
    """Per-phase wall-clock breakdown of one production frame-pair solve.

    Closes SURVEY §5's tracing item (the reference prints ad-hoc spans
    around assembly / translate / solve, ref optical_flow.py:831,
    1073-1076, 1106-1109, 1149-1157): phases here are the device pipeline's —
    derivative/coefficient build, multigrid setup, the main Krylov loop,
    mixed-precision refinement, and the device->host transfer.

    Everything inside ``jit`` is one fused computation, so phases are
    measured as *cumulative prefixes* compiled separately and differenced
    (each prefix re-fuses slightly differently — treat the split as a
    profile, not an exact decomposition; `jax.named_scope` annotations on
    the same phases give the exact device-time story under
    ``utils.observability.profile_trace``).  Durations land in the span
    registry as ``solve/<phase>`` and are returned as a dict of seconds.
    """
    import time as _time

    from opticalflow_tpu.utils.observability import record_span

    solver = solver or SolverConfig()
    prev = jnp.asarray(previous_frame)
    cur = jnp.asarray(current_frame, prev.dtype)
    dtype = prev.dtype
    a_s = jnp.asarray(speed_alpha, dtype)
    a_r = jnp.asarray(remodelling_alpha, dtype)
    u0 = jnp.zeros((3,) + prev.shape, dtype)

    @jax.jit
    def phase_pair_data(p, c):
        s = jnp.maximum(jnp.max(jnp.abs(p)), jnp.asarray(1e-30, dtype))
        pair = elop.compute_frame_pair_data(p / s, c / s, a_s / s**2, a_r, dy_mode)
        return pair.rhs

    @jax.jit
    def phase_mg_setup(p, c):
        s = jnp.maximum(jnp.max(jnp.abs(p)), jnp.asarray(1e-30, dtype))
        pair = elop.compute_frame_pair_data(p / s, c / s, a_s / s**2, a_r, dy_mode)
        mv = functools.partial(elop.el_matvec_reduced, pair.coeffs)
        b_red = pair.rhs[:, 1:-1, 1:-1]
        h = multigrid.setup(
            mv, elop.diag_blocks(pair.coeffs),
            b_red.shape[1], b_red.shape[2], b_red.dtype,
        )
        # one V-cycle application forces the whole hierarchy (probing,
        # Galerkin stencils, coarse LU) to actually be computed
        return multigrid.v_cycle(h, b_red)

    def phase_main(p, c):
        return solve_frame_pair(
            p, c, u0, a_s, a_r, dy_mode=dy_mode, method=solver.method,
            preconditioner=solver.preconditioner, rtol=solver.rtol,
            max_iterations=solver.max_iterations,
            high_precision_reductions=solver.high_precision_reductions,
            refinement_restarts=0, tol_floor=solver.dtype_tol_floor,
        )

    def phase_full(p, c):
        return solve_frame_pair(
            p, c, u0, a_s, a_r, dy_mode=dy_mode, method=solver.method,
            preconditioner=solver.preconditioner, rtol=solver.rtol,
            max_iterations=solver.max_iterations,
            high_precision_reductions=solver.high_precision_reductions,
            refinement_restarts=solver.refinement_restarts,
            tol_floor=solver.dtype_tol_floor,
            refinement_rtol=solver.refinement_rtol,
        )

    phase_main = jax.jit(phase_main)
    phase_full = jax.jit(phase_full)

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile
        best = float("inf")
        for _ in range(reps):
            t0 = _time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, _time.perf_counter() - t0)
        return best

    t_pair = timed(phase_pair_data, prev, cur)
    t_setup = (
        timed(phase_mg_setup, prev, cur)
        if solver.preconditioner == "multigrid"
        else t_pair
    )
    t_main = timed(phase_main, prev, cur)
    t_full = timed(phase_full, prev, cur)
    u, _ = phase_full(prev, cur)
    jax.block_until_ready(u)
    t0 = _time.perf_counter()
    np.asarray(u)
    t_host = _time.perf_counter() - t0

    phases = {
        "pair_data": t_pair,
        "mg_setup": max(t_setup - t_pair, 0.0),
        "krylov_main": max(t_main - t_setup, 0.0),
        "refinement": max(t_full - t_main, 0.0),
        "host_transfer": t_host,
        "total": t_full + t_host,
    }
    for name, seconds in phases.items():
        record_span(f"solve/{name}", seconds)
    return phases


def _solve_movie_direct(movie, u_init, speed_alpha, remodelling_alpha, dy_mode, warm_start):
    """Host-side assembled spsolve path (CPU oracle / small images)."""
    from opticalflow_tpu.solve import direct

    n_pairs = movie.shape[0] - 1
    all_u = np.zeros((n_pairs, 3, movie.shape[1], movie.shape[2]))
    infos = {
        "iterations": np.zeros(n_pairs, dtype=np.int32),
        "residual_norm": np.zeros(n_pairs),
        "converged": np.ones(n_pairs, dtype=bool),
        "L1_functional": np.zeros(n_pairs),
        "speed_functional": np.zeros(n_pairs),
        "remodelling_functional": np.zeros(n_pairs),
    }
    u_prev = u_init
    for k in range(n_pairs):
        pair = elop.compute_frame_pair_data(
            jnp.asarray(movie[k]), jnp.asarray(movie[k + 1]), speed_alpha, remodelling_alpha, dy_mode
        )
        u, _ = direct.direct_solve(pair.coeffs, np.asarray(pair.rhs))
        u = np.stack([np.asarray(stencils.mirror_edges(jnp.asarray(u[q]))) for q in range(3)])
        l1, sf, rf = _functionals(
            jnp.asarray(u), pair, speed_alpha, remodelling_alpha, dy_mode
        )
        infos["L1_functional"][k] = float(l1)
        infos["speed_functional"][k] = float(sf)
        infos["remodelling_functional"][k] = float(rf)
        all_u[k] = u
        if warm_start == "sequential":
            u_prev = u  # noqa: F841  (direct solve ignores the guess; chain kept for parity)
    return all_u, infos
