"""Geometric-Galerkin multigrid preconditioner for the reduced EL system.

On-device replacement for the strength of PETSc's composite
bjacobi/ilu/hypre(BoomerAMG) preconditioner (ref optical_flow.py:1089-1090)
— ILU and AMG setup are inherently sequential/host-bound, so instead we
exploit the problem's geometry:

* the reduced EL system (see ops.elop) is an exact 9-point, 3-field
  stencil on the interior grid;
* Galerkin coarse operators R A P (bilinear prolongation, R = P^T) of a
  9-point stencil are again 9-point stencils, so every level stays a
  dense-plane stencil operator of elementwise multiply-adds;
* coarse stencils are computed **matrix-free by comb probing**: applying
  the fine operator to 27 period-3 comb vectors (3 fields x 9 shifts)
  recovers every coarse stencil entry exactly, because a period-3 comb
  isolates each 9-point coupling.  All probes are batched with vmap;
* the smoother is damped block-Jacobi (omega=0.7, 2 sweeps) with exact
  3x3 diagonal-block inverses — measured equal convergence to 4-colour
  block Gauss-Seidel at half the matvec cost and with no sequential
  colour dependencies (GS remains available via ``smoother='gs'``);
* the coarsest level is solved exactly with a dense LU (the operator is
  materialised by one-hot probing — the grid there is tiny).

One V(1,1)-cycle with fixed sweep counts is a *fixed linear operator*, so
it is a valid preconditioner for BiCGStab.  Measured on the reference's
EL systems it cuts BiCGStab iterations from ~150-500+ (block-Jacobi) to
~10 at practice-relevant regularisation strengths.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Transfer operators (separable bilinear; coarse point c sits at fine 2c)
# ---------------------------------------------------------------------------


def _prolong_axis(c: jnp.ndarray, m_fine: int, axis: int) -> jnp.ndarray:
    """Bilinear prolongation along one axis: fine[2k] = c[k],
    fine[2k+1] = (c[k] + c[k+1]) / 2 (missing neighbour contributes 0)."""
    c = jnp.moveaxis(c, axis, -1)
    nxt = jnp.concatenate([c[..., 1:], jnp.zeros_like(c[..., :1])], axis=-1)
    odd = 0.5 * (c + nxt)
    inter = jnp.stack([c, odd], axis=-1).reshape(c.shape[:-1] + (2 * c.shape[-1],))
    out = inter[..., :m_fine]
    return jnp.moveaxis(out, -1, axis)


def _restrict_axis(y: jnp.ndarray, m_coarse: int, axis: int) -> jnp.ndarray:
    """Adjoint of :func:`_prolong_axis`:
    R(y)[k] = y[2k] + (y[2k-1] + y[2k+1]) / 2."""
    y = jnp.moveaxis(y, axis, -1)
    m_fine = y.shape[-1]
    pad_to = 2 * m_coarse
    ypad = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(1, pad_to + 1 - m_fine)])
    # ypad index k corresponds to fine index k-1
    even = ypad[..., 1::2][..., :m_coarse]  # y[2k]
    left = ypad[..., 0::2][..., :m_coarse]  # y[2k-1]
    right = ypad[..., 2::2][..., :m_coarse]  # y[2k+1]
    out = even + 0.5 * (left + right)
    return jnp.moveaxis(out, -1, axis)


def prolong(c: jnp.ndarray, fine_shape: Tuple[int, int]) -> jnp.ndarray:
    """(3, Mc, Nc) -> (3, Mf, Nf)."""
    out = _prolong_axis(c, fine_shape[0], axis=1)
    return _prolong_axis(out, fine_shape[1], axis=2)


def restrict(y: jnp.ndarray, coarse_shape: Tuple[int, int]) -> jnp.ndarray:
    """(3, Mf, Nf) -> (3, Mc, Nc) (exact adjoint of :func:`prolong`)."""
    out = _restrict_axis(y, coarse_shape[0], axis=1)
    return _restrict_axis(out, coarse_shape[1], axis=2)


def coarse_dims(m: int, n: int) -> Tuple[int, int]:
    return (m + 1) // 2, (n + 1) // 2


# ---------------------------------------------------------------------------
# Generic 9-point / 3-field stencil operator
# ---------------------------------------------------------------------------


def stencil_matvec(S: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """y[o,i,j] = sum_{q,di,dj} S[o,q,di,dj,i,j] * u[q,i+di-1,j+dj-1]
    with zero padding outside the grid.  S: (3,3,3,3,M,N), u: (3,M,N).

    Implemented as unrolled plane multiply-adds — see the in-body comment
    for the precision rationale (an einsum would hand the tiny (o, q)
    contraction to a matrix unit).
    """
    m, n = u.shape[1], u.shape[2]
    upad = jnp.pad(u, ((0, 0), (1, 1), (1, 1)))
    # Unrolled elementwise multiply-adds: the (o, q) contraction is only
    # 3x3, so an einsum would hand it to a matrix unit whose f32 "default"
    # precision is reduced (TF32 on the GPU's tensor cores), which degrades
    # the V-cycle and with it the Krylov iteration counts.  Plane
    # multiply-adds are exact f32 and the op stays memory-bound either way.
    out = []
    for o in range(3):
        acc = None
        for q in range(3):
            for di in range(3):
                for dj in range(3):
                    term = S[o, q, di, dj] * upad[q, di : di + m, dj : dj + n]
                    acc = term if acc is None else acc + term
        out.append(acc)
    return jnp.stack(out)


def probe_stencil(matvec: Callable, m: int, n: int, dtype) -> jnp.ndarray:
    """Recover the full 9-point/3-field stencil tensor of a black-box
    linear operator on a (3, m, n) grid by period-3 comb probing."""
    ii = jnp.arange(m)[:, None]
    jj = jnp.arange(n)[None, :]

    combs = []
    zero = jnp.zeros((m, n), dtype=dtype)
    for q in range(3):
        for si in range(3):
            for sj in range(3):
                plane = ((ii % 3 == si) & (jj % 3 == sj)).astype(dtype)
                # field q = comb plane, others zero — via stack, NOT
                # ``zeros.at[q].set``: the SPMD partitioner miscompiles
                # scatters on sharded arrays (see ops.elop
                # _extend_with_corners), and this code must stay
                # GSPMD-safe for the sharded multigrid path
                comb = jnp.stack([plane if k == q else zero for k in range(3)])
                combs.append(comb)
    combs = jnp.stack(combs)  # (27, 3, m, n)
    ys = jax.vmap(matvec)(combs)  # (27, 3, m, n)
    ys = ys.reshape(3, 3, 3, 3, m, n)  # [q, si, sj, o, i, j]

    # S[o,q,di,dj,i,j] = ys[q, (i+di-1)%3, (j+dj-1)%3, o, i, j]: offset
    # (di-1, dj-1) hits comb (si, sj) iff the modular condition holds
    # (unique per pixel).  One einsum over the two 3-valued residue masks
    # assembles all 81 planes in a single fused pass — the naive
    # masked-scatter loop rewrites the whole tensor 243 times (~GBs of
    # device-memory traffic per pair).
    offs = jnp.arange(3)
    s_vals = jnp.arange(3)
    mask_i = ((ii.ravel()[None, None, :] + offs[None, :, None] - 1) % 3
              == s_vals[:, None, None]).astype(dtype)  # (si, di, i)
    mask_j = ((jj.ravel()[None, None, :] + offs[None, :, None] - 1) % 3
              == s_vals[:, None, None]).astype(dtype)  # (sj, dj, j)
    # Assemble S[o,q,di,dj] = sum_{s,t} mask_i[s,di]*mask_j[t,dj]*ys[q,s,t,o]
    # as unrolled masked sums (the s,t contraction is 3x3; an einsum would
    # use a matrix unit — see stencil_matvec for the precision rationale).
    # The masks are 0/1 indicators, so each (s,t) term is an exact select.
    cols = []
    for d in range(3):
        rows = []
        for e in range(3):
            acc = None
            for s in range(3):
                for t in range(3):
                    term = (mask_i[s, d][:, None] * mask_j[t, e][None, :]
                            * ys[:, s, t])  # (q, o, i, j) after broadcast
                    acc = term if acc is None else acc + term
            rows.append(acc)  # (q, o, i, j)
        cols.append(jnp.stack(rows))  # (e, q, o, i, j)
    S = jnp.stack(cols)  # (d, e, q, o, i, j)
    return jnp.transpose(S, (3, 2, 0, 1, 4, 5))  # (o, q, d, e, i, j)


# ---------------------------------------------------------------------------
# Smoother: 4-colour (2x2) block Gauss-Seidel
# ---------------------------------------------------------------------------


def color_masks(m: int, n: int) -> np.ndarray:
    ii, jj = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    color = (ii % 2) * 2 + (jj % 2)
    return np.stack([color == c for c in range(4)])


def invert_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """Invert (M, N, 3, 3) per-pixel blocks in closed form (adjugate /
    determinant) with symmetric equilibration.  Pure elementwise math:
    ``jnp.linalg.inv`` would lower one tiny batched LU factorization per
    pixel (hundreds of thousands per frame pair), while this is ~60
    flops/pixel and fuses.  The symmetric scaling D A D with
    D = 1/sqrt(|diag|) keeps the
    f32 determinant O(1): the raw blocks mix O(alpha)~1e3-1e4 velocity
    rows with O(1) gamma rows, and the unscaled determinant loses bits to
    cancellation (an explicit Newton correction step is NOT safe here —
    on near-singular blocks it amplifies the adjugate error and raises
    BiCGStab iteration counts)."""
    diag = jnp.stack([blocks[..., k, k] for k in range(3)], axis=-1)
    s = 1.0 / jnp.sqrt(jnp.abs(diag) + 1e-30)
    scaled = blocks * s[..., :, None] * s[..., None, :]
    a = scaled[..., 0, 0]
    b = scaled[..., 0, 1]
    c = scaled[..., 0, 2]
    d = scaled[..., 1, 0]
    e = scaled[..., 1, 1]
    f = scaled[..., 1, 2]
    g = scaled[..., 2, 0]
    h = scaled[..., 2, 1]
    i = scaled[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    row0 = jnp.stack([A, B, C], axis=-1)
    row1 = jnp.stack([D, E, F], axis=-1)
    row2 = jnp.stack([G, H, I], axis=-1)
    X = jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]
    # inv(A) = D inv(D A D) D
    return X * s[..., :, None] * s[..., None, :]


def apply_blocks(binv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """(M,N,3,3) per-pixel blocks applied to a (3,M,N) field."""
    # 3x3 block application as unrolled plane multiply-adds (exact f32;
    # see stencil_matvec for why this avoids an einsum).
    return jnp.stack([
        sum(binv[:, :, o, q] * r[q] for q in range(3)) for o in range(3)
    ])


def gs_sweep(matvec, binv, masks, x, b, reverse: bool = False):
    order = range(3, -1, -1) if reverse else range(4)
    for c in order:
        r = b - matvec(x)
        upd = apply_blocks(binv, r)
        x = x + jnp.where(masks[c][None], upd, 0.0)
    return x


def jacobi_sweep(matvec, binv, x, b, damp: float = 0.7, sweeps: int = 2):
    """Damped block-Jacobi smoothing: x += damp * Binv (b - A x)."""
    for _ in range(sweeps):
        r = b - matvec(x)
        x = x + damp * apply_blocks(binv, r)
    return x


# ---------------------------------------------------------------------------
# Hierarchy setup + V-cycle
# ---------------------------------------------------------------------------


class MGLevel(NamedTuple):
    matvec: Callable
    binv: jnp.ndarray  # (M, N, 3, 3)
    masks: jnp.ndarray  # (4, M, N) bool
    shape: Tuple[int, int]


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]
    coarse_solve: Callable  # dense exact solve at the bottom


def setup(
    fine_matvec: Callable,
    fine_diag_blocks: jnp.ndarray,
    m: int,
    n: int,
    dtype,
    min_size: int = 8,
    max_levels: int = 16,
    fine_smoother_matvec: Callable | None = None,
) -> MGHierarchy:
    """Build the Galerkin hierarchy below a black-box fine operator.

    ``fine_diag_blocks``: (M, N, 3, 3) diagonal blocks of the fine operator
    (available analytically from the EL coefficients — probing not needed
    at the finest, most expensive level).

    ``fine_smoother_matvec``: optional other implementation of the same
    fine operator used only inside the cycle (the halo-exchange matvec of
    a spatially tiled solve); ``fine_matvec`` is always the one probed for
    the Galerkin coarse stencils (it must tolerate an extra vmap level).
    """
    levels: List[MGLevel] = []
    levels.append(
        MGLevel(
            matvec=fine_smoother_matvec if fine_smoother_matvec is not None else fine_matvec,
            binv=invert_blocks(fine_diag_blocks),
            masks=jnp.asarray(color_masks(m, n)),
            shape=(m, n),
        )
    )

    matvec = fine_matvec
    while min(m, n) > min_size and len(levels) < max_levels:
        mc, nc = coarse_dims(m, n)
        fine_shape = (m, n)

        def coarse_from(matvec_f, fshape, cshape):
            def cv(u_c):
                return restrict(matvec_f(prolong(u_c, fshape)), cshape)

            return cv

        coarse_mv_unprobed = coarse_from(matvec, fine_shape, (mc, nc))
        S_c = probe_stencil(coarse_mv_unprobed, mc, nc, dtype)
        matvec = functools.partial(stencil_matvec, S_c)
        blocks = jnp.moveaxis(S_c[:, :, 1, 1], (0, 1), (2, 3))  # (mc, nc, 3, 3)
        m, n = mc, nc
        levels.append(
            MGLevel(
                matvec=matvec,
                binv=invert_blocks(blocks),
                masks=jnp.asarray(color_masks(m, n)),
                shape=(m, n),
            )
        )

    # Materialise + LU-factor the coarsest operator (tiny).
    n_unk = 3 * m * n
    eye = jnp.eye(n_unk, dtype=dtype).reshape(n_unk, 3, m, n)
    cols = jax.vmap(matvec)(eye).reshape(n_unk, n_unk).T
    lu, piv = jax.scipy.linalg.lu_factor(cols)
    mm, nn = m, n

    def coarse_solve(b):
        x = jax.scipy.linalg.lu_solve((lu, piv), b.reshape(-1))
        return x.reshape(3, mm, nn)

    return MGHierarchy(levels=tuple(levels), coarse_solve=coarse_solve)


def _descend(h: MGHierarchy, lvl: int, b_l: jnp.ndarray, n_smooth: int,
             smoother: str, damp: float, sweeps: int) -> jnp.ndarray:
    """Recursive V-cycle descent from level ``lvl`` (zero initial guess)."""
    if lvl == len(h.levels) - 1:
        return h.coarse_solve(b_l)
    level = h.levels[lvl]

    def smooth(x, reverse):
        if smoother == "jacobi":
            return jacobi_sweep(level.matvec, level.binv, x, b_l,
                                damp=damp, sweeps=sweeps)
        return gs_sweep(level.matvec, level.binv, level.masks, x, b_l,
                        reverse=reverse)

    x = jnp.zeros_like(b_l)
    for _ in range(n_smooth):
        x = smooth(x, reverse=False)
    r = b_l - level.matvec(x)
    nxt = h.levels[lvl + 1]
    e = _descend(h, lvl + 1, restrict(r, nxt.shape), n_smooth, smoother, damp, sweeps)
    x = x + prolong(e, level.shape)
    for _ in range(n_smooth):
        x = smooth(x, reverse=True)
    return x


def v_cycle(h: MGHierarchy, b: jnp.ndarray, n_smooth: int = 1,
            smoother: str = "jacobi", damp: float = 0.7,
            sweeps: int = 2) -> jnp.ndarray:
    """One V(n,n)-cycle from a zero initial guess — a fixed linear operator
    usable as a Krylov preconditioner."""
    return _descend(h, 0, b, n_smooth, smoother, damp, sweeps)
