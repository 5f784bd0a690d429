"""Matrix-free Krylov solvers (BiCGStab, CG) in pure JAX.

On-device replacement for the reference's PETSc KSP solve
(/root/reference/source/optical_flow.py:1080-1157).  The reference uses
``-ksp_type bcgs`` with a composite bjacobi/ilu/hypre preconditioner,
rtol=1e-6, max_it=1000, unpreconditioned residual norm, and a warm start.
Here the EL system is nonsymmetric, so BiCGStab is the primary method,
with a right-applied preconditioner (so the monitored residual is the true
unpreconditioned residual, matching the reference's NORM_UNPRECONDITIONED
setting at :1126).

Everything runs inside ``lax.while_loop`` — one XLA computation per solve,
no host round-trips.  Dot products optionally accumulate in float64 even
for float32 fields ("compensated" reductions) which stabilises BiCGStab at
negligible cost (scalar work vs. memory-bound matvecs).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

MatVec = Callable[[jnp.ndarray], jnp.ndarray]
Precond = Callable[[jnp.ndarray], jnp.ndarray]


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray  # int32
    residual_norm: jnp.ndarray  # final unpreconditioned ||b - Ax||
    converged: jnp.ndarray  # bool


def _hp_dtype(dtype, high_precision: bool):
    """float64 when requested *and actually available* (x64 enabled),
    else the field dtype — avoids silent-truncation warnings."""
    if high_precision and jax.config.jax_enable_x64 and dtype != jnp.float64:
        return jnp.float64
    return dtype


def _make_dot(high_precision: bool, dtype):
    acc = _hp_dtype(dtype, high_precision)

    def dot(a, b):
        if acc != a.dtype:
            return jnp.sum(a.astype(acc) * b.astype(acc))
        return jnp.sum(a * b)

    return dot


def bicgstab(
    matvec: MatVec,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    stagnation_window: int = 100,
) -> KrylovResult:
    """Right-preconditioned BiCGStab.

    Solves A x = b to ``||b - A x|| <= max(rtol * ||b||, atol)``, with the
    tolerance floored at ``tol_floor_eps_multiple * eps(dtype) * ||b||`` —
    the working-precision stall level of BiCGStab (see SolverConfig).

    Stagnation guard: every ``stagnation_window`` iterations the loop
    exits early iff the best residual norm seen so far is within 4x of
    the tolerance AND improved <5% over the window — the classic f32
    floor stall, where the tolerance is just out of reach.  Residuals far
    above tol never trigger it: block-Jacobi BiCGStab runs plateau dead
    flat for >100 iterations mid-solve before a late cliff (measured at
    24^2: <0.2% improvement between iters 100-200, convergence at ~500),
    so any improvement-only criterion would kill converging solves.  The
    returned ``x`` is the *best* iterate (lowest residual norm), not the
    last one — post-stall f32 BiCGStab steps add recurrence noise to the
    solution (driving the floor from 300 down to 30 eps multiples raises
    the EPE vs the f64 direct solve while multiplying iterations).
    """
    dot = _make_dot(high_precision_reductions, b.dtype)
    acc = _hp_dtype(b.dtype, high_precision_reductions)
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    r0 = b - matvec(x0)
    rhat = r0
    b_norm = jnp.sqrt(dot(b, b))
    eff_rtol = jnp.maximum(rtol, tol_floor_eps_multiple * float(jnp.finfo(b.dtype).eps))
    tol = jnp.maximum(eff_rtol * b_norm, atol).astype(b_norm.dtype)
    eps = jnp.finfo(b.dtype).tiny

    class State(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        p: jnp.ndarray
        v: jnp.ndarray
        rho: jnp.ndarray
        alpha: jnp.ndarray
        omega: jnp.ndarray
        k: jnp.ndarray
        res_norm: jnp.ndarray
        breakdown: jnp.ndarray
        best_x: jnp.ndarray
        best_norm: jnp.ndarray
        ckpt_norm: jnp.ndarray  # best_norm at the last window checkpoint
        stagnated: jnp.ndarray

    one = jnp.asarray(1.0, dtype=acc)
    r0_norm = jnp.sqrt(dot(r0, r0))
    init = State(
        x=x0,
        r=r0,
        p=jnp.zeros_like(b),
        v=jnp.zeros_like(b),
        rho=one,
        alpha=one,
        omega=one,
        k=jnp.asarray(0, jnp.int32),
        res_norm=r0_norm,
        breakdown=jnp.asarray(False),
        best_x=x0,
        best_norm=r0_norm,
        ckpt_norm=r0_norm,
        stagnated=jnp.asarray(False),
    )

    def cond(s: State):
        return jnp.logical_and(
            jnp.logical_and(s.k < max_iterations, jnp.logical_not(s.stagnated)),
            jnp.logical_and(s.res_norm > tol, jnp.logical_not(s.breakdown)),
        )

    def body(s: State) -> State:
        rho_new = dot(rhat, s.r)
        safe_denom = jnp.where(jnp.abs(s.rho * s.omega) > 0, s.rho * s.omega, eps)
        beta = (rho_new * s.alpha) / safe_denom
        p = s.r + (beta * (s.p - s.omega * s.v).astype(acc)).astype(s.r.dtype)
        phat = precond(p)
        v = matvec(phat)
        rhat_v = dot(rhat, v)
        alpha = rho_new / jnp.where(jnp.abs(rhat_v) > 0, rhat_v, eps)
        sbreak = jnp.logical_or(jnp.abs(rho_new) == 0, jnp.abs(rhat_v) == 0)
        svec = s.r - (alpha * v.astype(acc)).astype(s.r.dtype)
        shat = precond(svec)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, svec) / jnp.where(tt > 0, tt, eps)
        x = (
            s.x
            + (alpha * phat.astype(acc)).astype(s.x.dtype)
            + (omega * shat.astype(acc)).astype(s.x.dtype)
        )
        r = svec - (omega * t.astype(acc)).astype(s.r.dtype)
        res_norm = jnp.sqrt(dot(r, r))
        is_best = res_norm < s.best_norm
        best_norm = jnp.where(is_best, res_norm, s.best_norm)
        k_new = s.k + 1
        at_ckpt = (k_new % stagnation_window) == 0
        stall_near_tol = jnp.logical_and(
            best_norm <= 4.0 * tol, best_norm > 0.95 * s.ckpt_norm
        )
        stagnated = jnp.logical_and(at_ckpt, stall_near_tol)
        ckpt_norm = jnp.where(at_ckpt, best_norm, s.ckpt_norm)
        return State(
            x=x,
            r=r,
            p=p,
            v=v,
            rho=rho_new,
            alpha=alpha,
            omega=omega,
            k=k_new,
            res_norm=res_norm,
            breakdown=sbreak,
            best_x=jnp.where(is_best, x, s.best_x),
            best_norm=best_norm,
            ckpt_norm=ckpt_norm,
            stagnated=stagnated,
        )

    final = lax.while_loop(cond, body, init)
    # Recompute the true residual once (guards against drift of the
    # recursively updated r, like the reference's independent check :1150-1151).
    true_res = b - matvec(final.best_x)
    true_norm = jnp.sqrt(dot(true_res, true_res))
    return KrylovResult(
        x=final.best_x,
        iterations=final.k,
        residual_norm=true_norm,
        converged=true_norm <= tol,
    )


def cg(
    matvec: MatVec,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
) -> KrylovResult:
    """Preconditioned conjugate gradient (for SPD systems; kept for the
    solver registry and future normal-equation / multigrid-smoothed paths).
    """
    dot = _make_dot(high_precision_reductions, b.dtype)
    acc = _hp_dtype(b.dtype, high_precision_reductions)
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    b_norm = jnp.sqrt(dot(b, b))
    eff_rtol = jnp.maximum(rtol, tol_floor_eps_multiple * float(jnp.finfo(b.dtype).eps))
    tol = jnp.maximum(eff_rtol * b_norm, atol).astype(b_norm.dtype)
    eps = jnp.finfo(b.dtype).tiny

    class State(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        z: jnp.ndarray
        p: jnp.ndarray
        rz: jnp.ndarray
        k: jnp.ndarray
        res_norm: jnp.ndarray

    init = State(
        x=x0, r=r0, z=z0, p=z0, rz=dot(r0, z0), k=jnp.asarray(0, jnp.int32),
        res_norm=jnp.sqrt(dot(r0, r0)),
    )

    def cond(s: State):
        return jnp.logical_and(s.k < max_iterations, s.res_norm > tol)

    def body(s: State) -> State:
        ap = matvec(s.p)
        pap = dot(s.p, ap)
        alpha = s.rz / jnp.where(jnp.abs(pap) > 0, pap, eps)
        x = s.x + (alpha * s.p.astype(acc)).astype(s.x.dtype)
        r = s.r - (alpha * ap.astype(acc)).astype(s.r.dtype)
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(s.rz) > 0, s.rz, eps)
        p = z + (beta * s.p.astype(acc)).astype(s.p.dtype)
        return State(x=x, r=r, z=z, p=p, rz=rz_new, k=s.k + 1, res_norm=jnp.sqrt(dot(r, r)))

    final = lax.while_loop(cond, body, init)
    true_res = b - matvec(final.x)
    true_norm = jnp.sqrt(dot(true_res, true_res))
    return KrylovResult(
        x=final.x, iterations=final.k, residual_norm=true_norm, converged=true_norm <= tol
    )


def fgmres(
    matvec: MatVec,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Precond] = None,
    rtol: float = 1e-6,
    atol: float = 0.0,
    max_iterations: int = 1000,
    restart: int = 32,
    high_precision_reductions: bool = True,
    tol_floor_eps_multiple: float = 300.0,
    truncation_guard: bool = True,
) -> KrylovResult:
    """Flexible GMRES(restart) — the robust large-grid solver.

    Why it exists: BiCGStab's coupled two-term recurrences disintegrate in
    f32 as the grid grows (measured on the bench EL systems: the recursive
    residual 'converges' while the true residual is stuck at ~0.5 at
    512^2; total collapse at 1024^2), and the Galerkin V-cycle is not a
    strict contraction at scale (Richardson with it *diverges* at 512^2,
    ratio ~1.05, even in f64 — it has a few amplified modes).  FGMRES
    handles both failure modes by construction: the Arnoldi residual is
    minimised monotonically over the generated subspace (amplified
    preconditioner modes just stop helping, they cannot destabilise), and
    *flexible* preconditioning tolerates the V-cycle's f32 nonlinearity.
    This is the same role PETSc's fgmres plays for composite/unreliable
    preconditioners (the reference's own KSP options list gmres as the
    commented alternative, ref optical_flow.py:1081-1093).

    Implementation notes:
    * classical Gram-Schmidt with one full reorthogonalisation pass
      (CGS2): two batched (restart+1)-way dot sweeps per iteration instead
      of a sequential MGS chain — numerically equivalent to MGS2, and the
      dots become two small matmuls on device;
    * unfilled basis rows are zero, so the CGS projections need no
      masking — projecting on zeros is a no-op;
    * Givens rotations triangularise H incrementally, giving a running
      residual estimate so the inner while_loop exits the moment the
      estimate crosses the tolerance (no overshoot to the restart
      boundary);
    * the outer loop recomputes the TRUE residual at every restart, so
      convergence is never declared on a drifted estimate.
    """
    dot = _make_dot(high_precision_reductions, b.dtype)
    acc = _hp_dtype(b.dtype, high_precision_reductions)
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    m = int(restart)
    vec_shape = b.shape
    n_flat = int(np.prod(vec_shape))

    b_norm = jnp.sqrt(dot(b, b))
    eff_rtol = jnp.maximum(rtol, tol_floor_eps_multiple * float(jnp.finfo(b.dtype).eps))
    tol = jnp.maximum(eff_rtol * b_norm, atol).astype(b_norm.dtype)
    tiny = jnp.finfo(b.dtype).tiny

    def flat(v):
        return v.reshape(n_flat)

    def unflat(v):
        return v.reshape(vec_shape)

    class Inner(NamedTuple):
        V: jnp.ndarray   # (m+1, n_flat) orthonormal basis (unfilled rows 0)
        Z: jnp.ndarray   # (m, n_flat) preconditioned vectors
        R: jnp.ndarray   # (m+1, m) triangularised H columns
        cs: jnp.ndarray  # (m,) Givens cosines
        sn: jnp.ndarray  # (m,) Givens sines
        g: jnp.ndarray   # (m+1,) rotated beta*e1
        j: jnp.ndarray   # filled columns
        est: jnp.ndarray  # running residual-norm estimate |g[j]|
        brk: jnp.ndarray  # Arnoldi (near-)breakdown — end the cycle
        rmax: jnp.ndarray  # largest |R[i,i]| so far (conditioning guard)

    def inner_cond(s: Inner):
        return jnp.logical_and(
            jnp.logical_and(s.j < m, s.est > tol), jnp.logical_not(s.brk)
        )

    def inner_body(s: Inner) -> Inner:
        vj = unflat(s.V[s.j])
        z = precond(vj)
        w = flat(matvec(z))
        w_entry = jnp.sqrt(dot(unflat(w), unflat(w))).astype(b.dtype)
        # CGS2: project, then reorthogonalise once
        # HIGHEST matmul precision: f32 matmuls may otherwise run in
        # reduced precision (TF32 on the GPU), which destroys Gram-Schmidt
        # orthogonality (and with it the whole Arnoldi basis) at large n —
        # these (m+1, n)-by-(n,) products MUST run at true f32/f64.
        mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)
        h1 = mm(s.V.astype(acc), w.astype(acc))
        w = w - mm(s.V.astype(acc).T, h1).astype(w.dtype)
        h2 = mm(s.V.astype(acc), w.astype(acc))
        w = w - mm(s.V.astype(acc).T, h2).astype(w.dtype)
        h = (h1 + h2).astype(b.dtype)  # (m+1,)
        hj1 = jnp.sqrt(dot(unflat(w), unflat(w))).astype(b.dtype)
        # Arnoldi near-breakdown guard: when the unprojected part of A z_j
        # is at the rounding-noise level of ||A z_j||, the "new" basis
        # direction is garbage and — worse — the tiny subdiagonal makes
        # the Givens rotation spuriously zero the residual estimate (est
        # claims convergence the true residual contradicts; measured on an
        # EL pair whose amplified-V-cycle preconditioner collapses the
        # Krylov directions: est fell 10 orders while the true residual
        # did not move at all).  End the cycle here — the LS over the j
        # columns built so far is still consistent, and the outer loop's
        # TRUE-residual restart takes over.
        brk = hj1 <= 3e-4 * w_entry
        v_next = (w / jnp.maximum(hj1, tiny)).astype(b.dtype)
        V = lax.dynamic_update_index_in_dim(s.V, v_next, s.j + 1, axis=0)
        Z = lax.dynamic_update_index_in_dim(
            s.Z, z.reshape(n_flat).astype(b.dtype), s.j, axis=0
        )

        # the new column [h with position j+1 := hj1]
        col = jnp.where(jnp.arange(m + 1) == s.j + 1, hj1, h)

        def rot(i, c):
            ci, si = s.cs[i], s.sn[i]
            hi, hi1 = c[i], c[i + 1]
            applied = jnp.asarray(i, jnp.int32) < s.j
            new_hi = jnp.where(applied, ci * hi + si * hi1, hi)
            new_hi1 = jnp.where(applied, -si * hi + ci * hi1, hi1)
            return c.at[i].set(new_hi).at[i + 1].set(new_hi1)

        col = lax.fori_loop(0, m, rot, col)

        # new rotation eliminating col[j+1]
        a1 = col[s.j]
        a2 = col[s.j + 1]
        denom = jnp.sqrt(a1 * a1 + a2 * a2)
        safe = jnp.maximum(denom, tiny)
        c_new = jnp.where(denom > 0, a1 / safe, jnp.ones_like(a1))
        s_new = jnp.where(denom > 0, a2 / safe, jnp.zeros_like(a2))
        rdd = c_new * a1 + s_new * a2
        col = col.at[s.j].set(rdd)
        col = col.at[s.j + 1].set(jnp.zeros_like(a2))
        cs = s.cs.at[s.j].set(c_new)
        sn = s.sn.at[s.j].set(s_new)
        gj = s.g[s.j]
        g = s.g.at[s.j].set(c_new * gj).at[s.j + 1].set(-s_new * gj)
        est = jnp.abs(g[s.j + 1])
        R = lax.dynamic_update_index_in_dim(s.R, col, s.j, axis=1)
        # R-conditioning guard (second breakdown route): a tiny new
        # diagonal makes kappa(R) explode, so the LS coefficients y blow
        # up and the f32 evaluation of Z y cancels to garbage — est then
        # reports a reduction dx cannot deliver.  End the cycle while the
        # triangular solve is still trustworthy; the outer true-residual
        # restart takes over.  (Measured on the same EL pair: without the
        # guard est fell 10 orders in one 28-step cycle while the true
        # residual did not move.)
        rmax = jnp.maximum(s.rmax, jnp.abs(rdd))
        brk = jnp.logical_or(brk, jnp.abs(rdd) <= 1e-5 * rmax)
        return Inner(V=V, Z=Z, R=R, cs=cs, sn=sn, g=g, j=s.j + 1, est=est,
                     brk=brk, rmax=rmax)

    class Outer(NamedTuple):
        x: jnp.ndarray
        k: jnp.ndarray          # total inner iterations
        res_norm: jnp.ndarray   # true residual norm at last restart
        stalled: jnp.ndarray    # cycle made no progress — stop

    def outer_cond(s: Outer):
        return jnp.logical_and(
            jnp.logical_and(s.k < max_iterations, s.res_norm > tol),
            jnp.logical_not(s.stalled),
        )

    def outer_body(s: Outer) -> Outer:
        r = b - matvec(s.x)
        beta = jnp.sqrt(dot(r, r)).astype(b.dtype)
        v0 = (flat(r) / jnp.maximum(beta, tiny)).astype(b.dtype)
        V = jnp.zeros((m + 1, n_flat), b.dtype)
        V = V.at[0].set(v0)
        init = Inner(
            V=V,
            Z=jnp.zeros((m, n_flat), b.dtype),
            R=jnp.zeros((m + 1, m), b.dtype),
            cs=jnp.zeros((m,), b.dtype),
            sn=jnp.zeros((m,), b.dtype),
            g=jnp.zeros((m + 1,), b.dtype).at[0].set(beta),
            j=jnp.asarray(0, jnp.int32),
            est=beta,
            brk=jnp.asarray(False),
            rmax=jnp.zeros((), b.dtype),
        )
        # cap TOTAL inner iterations at max_iterations (not just at restart
        # boundaries — bicgstab/cg cap per iteration, this matches them)
        k_outer = s.k

        def inner_cond_capped(st: Inner):
            return jnp.logical_and(inner_cond(st), k_outer + st.j < max_iterations)

        fin = lax.while_loop(inner_cond_capped, inner_body, init)

        def solution_for(jj):
            # LS solution over the FIRST jj columns (R is triangular, so
            # the truncated problem is exactly the length-jj Arnoldi LS)
            used = jnp.arange(m) < jj
            Rm = fin.R[:m, :m] + jnp.diag(
                jnp.where(used, 0.0, 1.0).astype(b.dtype))
            gm = jnp.where(used, fin.g[:m], 0.0).astype(b.dtype)
            y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
            y = jnp.where(used, y, 0.0)
            dx = unflat(
                jnp.matmul(fin.Z.astype(acc).T, y.astype(acc),
                           precision=lax.Precision.HIGHEST).astype(b.dtype)
            )
            x = s.x + dx
            r_new = b - matvec(x)
            return x, jnp.sqrt(dot(r_new, r_new)).astype(s.res_norm.dtype)

        # Evaluate the full cycle against the TRUE residual; when it
        # DISAGREES with the Arnoldi estimate, also evaluate two
        # truncations and keep the best.  Why: on ill-conditioned
        # preconditioned systems the Arnoldi LS estimate keeps
        # "improving" while ||y|| explodes and the f32 evaluation of Z y
        # cancels to garbage — measured on an EL pair: est fell to 1e-2
        # relative while the full cycle's true residual ROSE to 3.9, yet
        # the half-cycle truncation held genuine progress (3e-2).
        # Truncated candidates keep exactly that progress — but on a
        # healthy cycle (true residual within 2x of the estimate, the
        # common case at 256^2) they are pure overhead, so the two extra
        # preconditioned-matvec evaluations are gated behind a lax.cond
        # (per-cycle cost drops from j+4 to j+2 matvecs).
        x_f, r_f = solution_for(fin.j)

        def _with_truncations(_):
            x_h, r_h = solution_for((fin.j + 1) // 2)
            x_q, r_q = solution_for((fin.j + 3) // 4)
            x, res = x_f, r_f
            for xc, rc in ((x_h, r_h), (x_q, r_q)):
                take = rc < res
                x = jnp.where(take, xc, x)
                res = jnp.where(take, rc, res)
            return x, res

        if truncation_guard:
            disagree = jnp.logical_and(r_f > 2.0 * fin.est, r_f > tol)
        else:  # always-evaluate (pre-guard behavior, kept for parity tests)
            disagree = jnp.asarray(True)
        x, res_new = lax.cond(
            disagree, _with_truncations, lambda _: (x_f, r_f), operand=None
        )
        # keep the better iterate; stop if the cycle made <1% progress
        better = res_new < s.res_norm
        x = jnp.where(better, x, s.x)
        res_keep = jnp.where(better, res_new, s.res_norm)
        stalled = res_new > 0.99 * s.res_norm
        return Outer(x=x, k=s.k + fin.j, res_norm=res_keep, stalled=stalled)

    r0 = b - matvec(x0)
    init = Outer(
        x=x0,
        k=jnp.asarray(0, jnp.int32),
        res_norm=jnp.sqrt(dot(r0, r0)),
        stalled=jnp.asarray(False),
    )
    final = lax.while_loop(outer_cond, outer_body, init)
    return KrylovResult(
        x=final.x,
        iterations=final.k,
        residual_norm=final.res_norm,
        converged=final.res_norm <= tol,
    )
