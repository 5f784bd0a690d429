"""Matrix-free Euler-Lagrange operator for variational optical flow.

This is the on-device replacement for the reference's host-side sparse
assembly + PETSc matrix (/root/reference/source/optical_flow.py:829-1104).
The reference builds an explicit ``3*Ni*Nj x 3*Ni*Nj`` sparse matrix whose
entries are all local functions of the previous frame I and its
derivatives; here those become ~12 precomputed *coefficient planes* and the
matvec is a fused 9-point, 3-field stencil — no assembly, no sparse
storage, no host round-trips.

State layout: ``u`` has shape ``(3, Ni, Nj)`` with fields ``(u_x, u_y,
gamma)``; conceptually equivalent to the reference's interleaved flat
vector ``3*Nj*i + 3*j + q`` (ref ``get_index_set``, :1241-1302).

Row semantics replicated exactly (verified against an assembled-matrix
oracle in tests/test_elop.py):

* interior rows (pixels ``1..N-2``): the coupled EL equations for
  (u_x, u_y, gamma) — ref :843-962;
* edge rows: mirror constraints ``q(0,j)=q(2,j)`` etc. — ref :964-1070;
* corner rows: the reference's top/bottom and left/right boundary writers
  overlap at corners, leaving rows of the form
  ``q(0,0) - q(2,0) - q(0,2) = 0`` — reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from opticalflow_tpu.core import stencils


class ELCoefficients(NamedTuple):
    """Coefficient planes of the EL operator, all interior-shaped
    ``(Ni-2, Nj-2)``, plus scalars.  Derived once per frame pair from the
    previous frame; every matvec reuses them."""

    diag_x: jnp.ndarray  # I*(dIdxx - 2I) - 4*alpha_s      (u_x diagonal)
    diag_y: jnp.ndarray  # I*(dIdyy - 2I) - 4*alpha_s      (u_y diagonal)
    cross: jnp.ndarray  # I*dIdxy                          (u_x <-> u_y same pixel)
    adv_xm: jnp.ndarray  # I*(-dIdx + I) + alpha_s          (u_x eq, x-1 neighbour)
    adv_xp: jnp.ndarray  # I*(+dIdx + I) + alpha_s          (u_x eq, x+1 neighbour)
    adv_ym: jnp.ndarray  # I*(-dIdy + I) + alpha_s          (u_y eq, y-1 neighbour)
    adv_yp: jnp.ndarray  # I*(+dIdy + I) + alpha_s          (u_y eq, y+1 neighbour)
    gx: jnp.ndarray  # I*dIdx/2
    gy: jnp.ndarray  # I*dIdy/2
    quart: jnp.ndarray  # I^2/4                             (mixed-derivative corners)
    half_I: jnp.ndarray  # I/2                              (gamma couplings)
    dIdx: jnp.ndarray
    dIdy: jnp.ndarray
    speed_alpha: jnp.ndarray  # scalar
    remodelling_alpha: jnp.ndarray  # scalar


class FramePairData(NamedTuple):
    """Everything derived from one (previous, current) frame pair."""

    coeffs: ELCoefficients
    rhs: jnp.ndarray  # (3, Ni, Nj)
    # planes kept for functional evaluation
    dIdx: jnp.ndarray
    dIdy: jnp.ndarray
    dIdt: jnp.ndarray
    I_interior: jnp.ndarray


def compute_frame_pair_data(
    previous_frame: jnp.ndarray,
    current_frame: jnp.ndarray,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = stencils.DY_COMPAT,
) -> FramePairData:
    """Image-derivative planes + coefficient planes + RHS for one frame
    pair (ref :812-827 for the derivatives, :843-962 for the coefficients).
    """
    prev = previous_frame
    cur = current_frame
    I = prev[1:-1, 1:-1]

    dIdx = stencils.ddx(prev)
    dIdy = stencils.ddy(prev, mode=dy_mode)
    dIdxx = stencils.ddxx(prev)
    dIdyy = stencils.ddyy(prev)
    dIdxy = stencils.ddxy(prev)
    dIdx_t = stencils.ddx(cur) - stencils.ddx(prev)
    dIdy_t = stencils.ddy(cur, mode=stencils.DY_FIXED) - stencils.ddy(prev, mode=stencils.DY_FIXED)
    dIdt = (cur - prev)[1:-1, 1:-1]

    a_s = jnp.asarray(speed_alpha, dtype=I.dtype)
    a_r = jnp.asarray(remodelling_alpha, dtype=I.dtype)

    coeffs = ELCoefficients(
        diag_x=I * (dIdxx - 2.0 * I) - 4.0 * a_s,
        diag_y=I * (dIdyy - 2.0 * I) - 4.0 * a_s,
        cross=I * dIdxy,
        adv_xm=I * (-dIdx + I) + a_s,
        adv_xp=I * (dIdx + I) + a_s,
        adv_ym=I * (-dIdy + I) + a_s,
        adv_yp=I * (dIdy + I) + a_s,
        gx=I * dIdx * 0.5,
        gy=I * dIdy * 0.5,
        quart=I * I * 0.25,
        half_I=I * 0.5,
        dIdx=dIdx,
        dIdy=dIdy,
        speed_alpha=a_s,
        remodelling_alpha=a_r,
    )

    rhs = jnp.zeros((3,) + prev.shape, dtype=I.dtype)
    rhs = rhs.at[0, 1:-1, 1:-1].set(-I * dIdx_t)
    rhs = rhs.at[1, 1:-1, 1:-1].set(-I * dIdy_t)
    rhs = rhs.at[2, 1:-1, 1:-1].set(-dIdt)

    return FramePairData(coeffs=coeffs, rhs=rhs, dIdx=dIdx, dIdy=dIdy, dIdt=dIdt, I_interior=I)


def _shift(f: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """``f(i+di, j+dj)`` evaluated on the interior grid, given the full
    ``(Ni, Nj)`` plane.  |di|, |dj| <= 1."""
    ni, nj = f.shape
    return f[1 + di : ni - 1 + di, 1 + dj : nj - 1 + dj]


def interior_apply(coeffs: ELCoefficients, u: jnp.ndarray) -> jnp.ndarray:
    """Apply the interior EL equations to a full-grid field stack.

    ``u`` has shape ``(3, Ni, Nj)``; the result has interior shape
    ``(3, Ni-2, Nj-2)``.
    """
    ux, uy, g = u[0], u[1], u[2]
    c = coeffs
    a_s = c.speed_alpha
    a_r = c.remodelling_alpha

    # u_x equation (ref :843-889)
    y_ux = (
        c.diag_x * _shift(ux, 0, 0)
        + c.cross * _shift(uy, 0, 0)
        + c.adv_xm * _shift(ux, -1, 0)
        + c.adv_xp * _shift(ux, +1, 0)
        + a_s * (_shift(ux, 0, -1) + _shift(ux, 0, +1))
        + c.gx * (_shift(uy, 0, +1) - _shift(uy, 0, -1))
        + c.gy * (_shift(uy, +1, 0) - _shift(uy, -1, 0))
        + c.quart
        * (_shift(uy, -1, -1) + _shift(uy, +1, +1) - _shift(uy, -1, +1) - _shift(uy, +1, -1))
        + c.half_I * (_shift(g, -1, 0) - _shift(g, +1, 0))
    )

    # u_y equation (ref :892-938)
    y_uy = (
        c.diag_y * _shift(uy, 0, 0)
        + c.cross * _shift(ux, 0, 0)
        + c.adv_ym * _shift(uy, 0, -1)
        + c.adv_yp * _shift(uy, 0, +1)
        + a_s * (_shift(uy, -1, 0) + _shift(uy, +1, 0))
        + c.gy * (_shift(ux, +1, 0) - _shift(ux, -1, 0))
        + c.gx * (_shift(ux, 0, +1) - _shift(ux, 0, -1))
        + c.quart
        * (_shift(ux, -1, -1) + _shift(ux, +1, +1) - _shift(ux, -1, +1) - _shift(ux, +1, -1))
        + c.half_I * (_shift(g, 0, -1) - _shift(g, 0, +1))
    )

    # gamma equation (ref :940-962)
    y_g = (
        (-1.0 - 4.0 * a_r) * _shift(g, 0, 0)
        + c.dIdx * _shift(ux, 0, 0)
        + c.dIdy * _shift(uy, 0, 0)
        + a_r * (_shift(g, -1, 0) + _shift(g, +1, 0) + _shift(g, 0, -1) + _shift(g, 0, +1))
        + c.half_I * (_shift(ux, +1, 0) - _shift(ux, -1, 0))
        + c.half_I * (_shift(uy, 0, +1) - _shift(uy, 0, -1))
    )

    return jnp.stack([y_ux, y_uy, y_g])


def el_matvec(coeffs: ELCoefficients, u: jnp.ndarray) -> jnp.ndarray:
    """y = A u for the full EL operator including boundary rows.

    ``u`` and ``y`` have shape ``(3, Ni, Nj)``.
    """
    y_int = interior_apply(coeffs, u)
    y = jnp.zeros_like(u)
    y = y.at[:, 1:-1, 1:-1].set(y_int)

    # Boundary rows: mirror constraints (ref :964-1070).  Top/bottom edges,
    # then left/right columns on interior i; corners accumulate both mirror
    # terms (the reference's boundary writers overlap there).
    y = y.at[:, 0, :].set(u[:, 0, :] - u[:, 2, :])
    y = y.at[:, -1, :].set(u[:, -1, :] - u[:, -3, :])
    y = y.at[:, 1:-1, 0].set(u[:, 1:-1, 0] - u[:, 1:-1, 2])
    y = y.at[:, 1:-1, -1].set(u[:, 1:-1, -1] - u[:, 1:-1, -3])
    y = y.at[:, 0, 0].add(-u[:, 0, 2])
    y = y.at[:, 0, -1].add(-u[:, 0, -3])
    y = y.at[:, -1, 0].add(-u[:, -1, 2])
    y = y.at[:, -1, -1].add(-u[:, -1, -3])
    return y


def block_jacobi_inverse_apply(coeffs: ELCoefficients, r: jnp.ndarray) -> jnp.ndarray:
    """Apply the inverse of the per-pixel 3x3 diagonal block of A.

    This is the on-device analogue of PETSc's block-Jacobi with block size
    3 (ref :1104, :1090).  The interior block is

        [[a,     c,     0 ],
         [c,     b,     0 ],
         [dIdx,  dIdy,  gD]]

    (a = diag_x, b = diag_y, c = cross, gD = -1 - 4*alpha_r); boundary
    pixels have identity blocks.  The block is lower-block-triangular in
    (velocity | gamma), so the inverse is closed-form elementwise math.
    """
    c = coeffs
    r1, r2, r3 = r[0, 1:-1, 1:-1], r[1, 1:-1, 1:-1], r[2, 1:-1, 1:-1]
    a, b, cc = c.diag_x, c.diag_y, c.cross
    det = a * b - cc * cc
    gD = -1.0 - 4.0 * c.remodelling_alpha
    x1 = (b * r1 - cc * r2) / det
    x2 = (a * r2 - cc * r1) / det
    x3 = (r3 - c.dIdx * x1 - c.dIdy * x2) / gD

    out = r  # boundary entries pass through (identity blocks)
    out = out.at[0, 1:-1, 1:-1].set(x1)
    out = out.at[1, 1:-1, 1:-1].set(x2)
    out = out.at[2, 1:-1, 1:-1].set(x3)
    return out


# ---------------------------------------------------------------------------
# Reduced (interior-only) system
#
# The mirror-constraint boundary rows are *exactly* eliminable: every
# boundary unknown is a fixed linear combination of interior unknowns
# (edges mirror one interior value; corners are the sum of two edge mirrors,
# i.e. twice the diagonal interior value).  Folding them in turns the full
# system into a pure 9-point / 3-field stencil system on the interior grid
# — the natural form for multigrid and for tiling.  The reduction is
# verified exact against the assembled full system in tests/test_elop.py.
# ---------------------------------------------------------------------------


def _extend_with_corners(u_int: jnp.ndarray, corner_factor: float) -> jnp.ndarray:
    """Surround an interior stack with mirror boundary values, corners
    scaled by ``corner_factor``.  Built from concatenations of slices —
    deliberately NOT chained ``.at[].set`` updates, which the XLA SPMD
    partitioner miscompiles on sharded arrays (jax 0.9: chained scatters
    on a ('tx','ty')-sharded array silently produce wrong boundary values;
    concatenation lowers to pad/slice which partitions correctly —
    regression-tested in tests/test_parallel.py)."""
    left = u_int[:, :, 1:2]
    right = u_int[:, :, -2:-1]
    wide = jnp.concatenate([left, u_int, right], axis=2)
    top = jnp.concatenate(
        [corner_factor * u_int[:, 1:2, 1:2], u_int[:, 1:2, :],
         corner_factor * u_int[:, 1:2, -2:-1]],
        axis=2,
    )
    bottom = jnp.concatenate(
        [corner_factor * u_int[:, -2:-1, 1:2], u_int[:, -2:-1, :],
         corner_factor * u_int[:, -2:-1, -2:-1]],
        axis=2,
    )
    return jnp.concatenate([top, wide, bottom], axis=1)


def extend_interior(u_int: jnp.ndarray) -> jnp.ndarray:
    """Extend an interior field stack ``(3, Ni-2, Nj-2)`` to the full grid
    using the boundary constraints (edge mirror; corner = sum of both
    mirrors = 2x the diagonal interior value)."""
    return _extend_with_corners(u_int, 2.0)


def el_matvec_reduced(coeffs: ELCoefficients, u_int: jnp.ndarray) -> jnp.ndarray:
    """y = A_reduced u on the interior grid (boundary rows folded in)."""
    return interior_apply(coeffs, extend_interior(u_int))


# ---------------------------------------------------------------------------
# Double-float (df32) exact system data + residual for iterative refinement
#
# Why: (a) the plain f32 matvec is catastrophically cancellative (stencil
# terms O(alpha*u) cancel to a result ~1e3x smaller), flooring the true
# attainable residual of the f32 Krylov solve far above f64 quality; (b)
# the f32 *computation* of the coefficient planes alone perturbs the
# system enough to move the exact solution by a few 1e-4 px at 256^2
# (vs f64-computed coefficients of the same f32 frames — microscopy data
# is integer-valued, so the frames themselves are exact in f32).  Both are
# fixed by evaluating the refinement residual against system data computed
# in double-float compensated arithmetic (ops.df32): the refinement then
# converges to the f64-quality solution while every Krylov iteration stays
# pure f32.  This is the f32 pipeline's answer to the reference's f64
# PETSc solve (ref optical_flow.py:1096-1147).
# ---------------------------------------------------------------------------


class ELPairDataDF(NamedTuple):
    """Double-float system data for one frame pair (normalised units).
    Every field is a ``(hi, lo)`` pair of interior-shaped planes (scalars
    for the alphas / gamma diagonal); ``rhs`` pairs are interior-shaped
    ``(3, m, n)``."""

    diag_x: tuple
    diag_y: tuple
    cross: tuple
    adv_xm: tuple
    adv_xp: tuple
    adv_ym: tuple
    adv_yp: tuple
    gx: tuple
    gy: tuple
    quart: tuple
    half_I: tuple
    dIdx: tuple
    dIdy: tuple
    a_s: tuple
    a_r: tuple
    gD: tuple
    rhs_hi: jnp.ndarray  # (3, m, n)
    rhs_lo: jnp.ndarray


def compute_frame_pair_data_df(
    previous_frame_raw: jnp.ndarray,
    current_frame_raw: jnp.ndarray,
    speed_alpha_raw,
    remodelling_alpha,
    dy_mode: str,
    intensity_scale,
) -> ELPairDataDF:
    """Build the df32 system data of the *normalised* EL system from the
    raw (un-normalised, exactly representable) frames.

    The normalisation division, every derivative stencil, and every
    coefficient product are carried out in pair arithmetic, so the planes
    represent the exact normalised system to ~eps^2 — the refinement's
    fixed point is then the f64-quality solution.  Scalar roundings that
    perturb the system only *uniformly* (the alphas, the gamma diagonal)
    are also carried as pairs for completeness.
    """
    from opticalflow_tpu.ops import df32

    prev = df32.df_div(df32.df_from(previous_frame_raw), intensity_scale)
    cur = df32.df_div(df32.df_from(current_frame_raw), intensity_scale)

    def sl(p, i0, i1, j0, j1):
        # slice a plane pair; bounds follow numpy's a[i0:i1, j0:j1] with
        # i1/j1 of 0 meaning "to the end"
        hi, lo = p
        i_end = hi.shape[0] + i1 if i1 < 0 else None
        j_end = hi.shape[1] + j1 if j1 < 0 else None
        return hi[i0:i_end, j0:j_end], lo[i0:i_end, j0:j_end]

    def ddx_df(p):
        return df32.df_scale_pow2(df32.df_sub(sl(p, 2, 0, 1, -1), sl(p, 0, -2, 1, -1)), 0.5)

    def ddy_df(p):
        return df32.df_scale_pow2(df32.df_sub(sl(p, 1, -1, 2, 0), sl(p, 1, -1, 0, -2)), 0.5)

    I = sl(prev, 1, -1, 1, -1)
    dIdx = ddx_df(prev)
    dIdy = dIdx if dy_mode == "compat" else ddy_df(prev)
    two_I = df32.df_scale_pow2(I, 2.0)
    dIdxx = df32.df_sub(df32.df_add(sl(prev, 2, 0, 1, -1), sl(prev, 0, -2, 1, -1)), two_I)
    dIdyy = df32.df_sub(df32.df_add(sl(prev, 1, -1, 2, 0), sl(prev, 1, -1, 0, -2)), two_I)
    dIdxy = df32.df_scale_pow2(
        df32.df_add(
            df32.df_sub(sl(prev, 2, 0, 2, 0), sl(prev, 2, 0, 0, -2)),
            df32.df_sub(sl(prev, 0, -2, 0, -2), sl(prev, 0, -2, 2, 0)),
        ),
        0.25,
    )
    dIdx_t = df32.df_sub(ddx_df(cur), ddx_df(prev))
    dIdy_t = df32.df_sub(ddy_df(cur), ddy_df(prev))
    dIdt = df32.df_sub(sl(cur, 1, -1, 1, -1), I)

    dtype = previous_frame_raw.dtype
    a_s = df32.df_div(
        df32.df_div_f(jnp.asarray(speed_alpha_raw, dtype), intensity_scale), intensity_scale
    )
    a_r = df32.df_from(jnp.asarray(remodelling_alpha, dtype))
    four_a_s = df32.df_scale_pow2(a_s, 4.0)
    gD = df32.df_add_pf(df32.df_scale_pow2(a_r, -4.0), jnp.asarray(-1.0, dtype))

    def bc(pair_scalar, shape):
        # broadcast a scalar pair to a plane pair
        hi, lo = pair_scalar
        return jnp.broadcast_to(hi, shape), jnp.broadcast_to(lo, shape)

    shape = I[0].shape
    diag_x = df32.df_sub(df32.df_mul(I, df32.df_sub(dIdxx, two_I)), bc(four_a_s, shape))
    diag_y = df32.df_sub(df32.df_mul(I, df32.df_sub(dIdyy, two_I)), bc(four_a_s, shape))
    cross = df32.df_mul(I, dIdxy)
    adv_xm = df32.df_add(df32.df_mul(I, df32.df_sub(I, dIdx)), bc(a_s, shape))
    adv_xp = df32.df_add(df32.df_mul(I, df32.df_add(dIdx, I)), bc(a_s, shape))
    adv_ym = df32.df_add(df32.df_mul(I, df32.df_sub(I, dIdy)), bc(a_s, shape))
    adv_yp = df32.df_add(df32.df_mul(I, df32.df_add(dIdy, I)), bc(a_s, shape))
    gx = df32.df_scale_pow2(df32.df_mul(I, dIdx), 0.5)
    gy = df32.df_scale_pow2(df32.df_mul(I, dIdy), 0.5)
    quart = df32.df_scale_pow2(df32.df_mul(I, I), 0.25)
    half_I = df32.df_scale_pow2(I, 0.5)

    r0 = df32.df_neg(df32.df_mul(I, dIdx_t))
    r1 = df32.df_neg(df32.df_mul(I, dIdy_t))
    r2 = df32.df_neg(dIdt)
    rhs_hi = jnp.stack([r0[0], r1[0], r2[0]])
    rhs_lo = jnp.stack([r0[1], r1[1], r2[1]])

    return ELPairDataDF(
        diag_x=diag_x, diag_y=diag_y, cross=cross,
        adv_xm=adv_xm, adv_xp=adv_xp, adv_ym=adv_ym, adv_yp=adv_yp,
        gx=gx, gy=gy, quart=quart, half_I=half_I,
        dIdx=dIdx, dIdy=dIdy, a_s=a_s, a_r=a_r, gD=gD,
        rhs_hi=rhs_hi, rhs_lo=rhs_lo,
    )


def el_residual_df(dfd: ELPairDataDF, x_hi: jnp.ndarray, x_lo: jnp.ndarray) -> jnp.ndarray:
    """``b - A_reduced x`` of the df32 system, for ``x`` carried as a
    ``hi + lo`` pair — the residual is exact to ~eps^2, so iterative
    refinement keeps contracting instead of stalling at the f32
    matvec-evaluation / representation noise floor (see module notes).
    Runs once per refinement step, outside the Krylov loop.

    The mirror extension only copies values and scales corners by 2.0
    (exact), so it is applied to hi and lo independently.
    """
    from opticalflow_tpu.ops import df32

    u_hi = extend_interior(x_hi)
    u_lo = extend_interior(x_lo)

    def sh2(q, di, dj):
        return _shift(u_hi[q], di, dj), _shift(u_lo[q], di, dj)

    def acc_sub(acc, coef, plane):
        """acc -= coef (pair) * plane (pair); x_lo products stay plain f32
        (their rounding is ~eps^2 of the term)."""
        c_hi, c_lo = coef
        p_hi, p_lo = plane
        p, e = df32.two_prod(c_hi, p_hi)
        small = e + c_lo * p_hi + c_hi * p_lo
        s, e2 = df32.two_sum(acc[0], -p)
        return s, acc[1] + (e2 - small)

    def neg(coef):
        return -coef[0], -coef[1]

    d = dfd
    UX, UY, G = 0, 1, 2

    def chan(b_hi, b_lo, terms):
        acc = (b_hi, b_lo)
        for coef, (q, di, dj) in terms:
            acc = acc_sub(acc, coef, sh2(q, di, dj))
        return df32.df_result(acc)

    r_ux = chan(d.rhs_hi[0], d.rhs_lo[0], [
        (d.diag_x, (UX, 0, 0)), (d.cross, (UY, 0, 0)),
        (d.adv_xm, (UX, -1, 0)), (d.adv_xp, (UX, +1, 0)),
        (d.a_s, (UX, 0, -1)), (d.a_s, (UX, 0, +1)),
        (d.gx, (UY, 0, +1)), (neg(d.gx), (UY, 0, -1)),
        (d.gy, (UY, +1, 0)), (neg(d.gy), (UY, -1, 0)),
        (d.quart, (UY, -1, -1)), (d.quart, (UY, +1, +1)),
        (neg(d.quart), (UY, -1, +1)), (neg(d.quart), (UY, +1, -1)),
        (d.half_I, (G, -1, 0)), (neg(d.half_I), (G, +1, 0)),
    ])
    r_uy = chan(d.rhs_hi[1], d.rhs_lo[1], [
        (d.diag_y, (UY, 0, 0)), (d.cross, (UX, 0, 0)),
        (d.adv_ym, (UY, 0, -1)), (d.adv_yp, (UY, 0, +1)),
        (d.a_s, (UY, -1, 0)), (d.a_s, (UY, +1, 0)),
        (d.gy, (UX, +1, 0)), (neg(d.gy), (UX, -1, 0)),
        (d.gx, (UX, 0, +1)), (neg(d.gx), (UX, 0, -1)),
        (d.quart, (UX, -1, -1)), (d.quart, (UX, +1, +1)),
        (neg(d.quart), (UX, -1, +1)), (neg(d.quart), (UX, +1, -1)),
        (d.half_I, (G, 0, -1)), (neg(d.half_I), (G, 0, +1)),
    ])
    r_g = chan(d.rhs_hi[2], d.rhs_lo[2], [
        (d.gD, (G, 0, 0)),
        (d.dIdx, (UX, 0, 0)), (d.dIdy, (UY, 0, 0)),
        (d.a_r, (G, -1, 0)), (d.a_r, (G, +1, 0)),
        (d.a_r, (G, 0, -1)), (d.a_r, (G, 0, +1)),
        (d.half_I, (UX, +1, 0)), (neg(d.half_I), (UX, -1, 0)),
        (d.half_I, (UY, 0, +1)), (neg(d.half_I), (UY, 0, -1)),
    ])
    return jnp.stack([r_ux, r_uy, r_g])


def el_matvec_df(dfd: ELPairDataDF, x: jnp.ndarray) -> jnp.ndarray:
    """``A_reduced x`` evaluated against the double-float system data —
    exact to ~eps^2 like :func:`el_residual_df` (it IS that residual with
    a zero RHS, negated).

    Why it exists: at 1024^2 the velocity block's condition number is
    ~1e6, so the *plain f32* matvec cannot resolve residuals of the
    smooth (near-null Laplacian) modes — eps * kappa ~ 0.1 — and the
    refinement's f32 correction solves stall (GMRES+MG converges at
    <= 512^2 but plateaus above tolerance at 1024^2).  Solving the
    correction systems against the df32 operator restores the 'refinement
    contracts by rtol per step' guarantee independent of kappa * eps_f32.
    Pure elementwise pair arithmetic; used only inside refinement, never
    in the main Krylov loop.
    """
    zero = jnp.zeros_like(dfd.rhs_hi)
    dfd0 = dfd._replace(rhs_hi=zero, rhs_lo=zero)
    return -el_residual_df(dfd0, x, jnp.zeros_like(x))


def embed_interior(u_int: jnp.ndarray) -> jnp.ndarray:
    """Place an interior solution into the full grid and fill the boundary
    with the reference's post-solve mirror fix-up (ref :1163-1166) — note
    corners take the *single* mirror value here, matching
    ``apply_constant_boundary_condition``, not the doubled constraint value.
    """
    return _extend_with_corners(u_int, 1.0)


def diag_blocks(coeffs: ELCoefficients):
    """The per-pixel 3x3 diagonal blocks of the (reduced or full) interior
    operator, shape ``(Ni-2, Nj-2, 3, 3)``.  Boundary folding never touches
    same-pixel entries, so these serve both systems."""
    c = coeffs
    z = jnp.zeros_like(c.diag_x)
    gD = -1.0 - 4.0 * c.remodelling_alpha + z
    row0 = jnp.stack([c.diag_x, c.cross, z], axis=-1)
    row1 = jnp.stack([c.cross, c.diag_y, z], axis=-1)
    row2 = jnp.stack([c.dIdx, c.dIdy, gD], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def block_jacobi_inverse_apply_interior(coeffs: ELCoefficients, r: jnp.ndarray) -> jnp.ndarray:
    """Interior-grid block-Jacobi preconditioner apply: ``r`` is
    ``(3, Ni-2, Nj-2)``."""
    c = coeffs
    r1, r2, r3 = r[0], r[1], r[2]
    a, b, cc = c.diag_x, c.diag_y, c.cross
    det = a * b - cc * cc
    gD = -1.0 - 4.0 * c.remodelling_alpha
    x1 = (b * r1 - cc * r2) / det
    x2 = (a * r2 - cc * r1) / det
    x3 = (r3 - c.dIdx * x1 - c.dIdy * x2) / gD
    return jnp.stack([x1, x2, x3])
