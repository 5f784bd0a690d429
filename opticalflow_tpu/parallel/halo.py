"""Halo-exchange stencil matvec for spatially tiled solves (BASELINE
config 4; SURVEY.md section 2.4 design).

Under spatial tiling the reduced-system matvec runs as a ``shard_map`` in
which every device

1. exchanges 1-pixel halos of the field and of the previous-frame plane
   with its (tx, ty) mesh neighbours via ``jax.lax.ppermute`` (two-phase:
   columns first, then rows of the column-extended block, so corner
   pixels arrive without a dedicated diagonal exchange),
2. reconstructs the *reduced-system* extension semantics at global edges
   (edge mirrors one interior value, global corners take 2x the diagonal
   value — ops.elop.extend_interior), and the true frame boundary rows
   (carried as replicated 1-D arrays — O(n) bytes), and
3. rebuilds the local EL coefficients and applies the stencil to its
   halo-extended block.

The Krylov iteration outside stays in plain interior layout under GSPMD
(dot products become psums automatically); only the matvec drops into
manual SPMD.  Frame-pair batching composes via
``jax.vmap(..., spmd_axis_name='frames')``.  The permutes are ordinary
XLA collectives, which the GPU backend hands to NCCL.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _edge_halo_1d(block: jnp.ndarray, axis_name: str, axis: int,
                  lo_edge_val: jnp.ndarray, hi_edge_val: jnp.ndarray):
    """Exchange +-1 halos of ``block`` along one mesh axis.

    Returns ``(lo, hi)`` halo slabs (shape of one boundary slice each):
    interior tiles receive their neighbour's edge slice; tiles at the
    global boundary receive ``lo_edge_val`` / ``hi_edge_val`` instead.
    """
    idx = jax.lax.axis_index(axis_name)
    size = jax.lax.axis_size(axis_name)

    lo_slice = jax.lax.index_in_dim(block, 0, axis=axis, keepdims=False)
    hi_slice = jax.lax.index_in_dim(block, block.shape[axis] - 1, axis=axis,
                                    keepdims=False)

    if size == 1:
        return lo_edge_val, hi_edge_val

    # receive the upper neighbour's last slice as my lo halo (shift down)
    down = [(i, i + 1) for i in range(size - 1)]
    up = [(i + 1, i) for i in range(size - 1)]
    from_above = jax.lax.ppermute(hi_slice, axis_name, down)
    from_below = jax.lax.ppermute(lo_slice, axis_name, up)

    lo = jnp.where(idx == 0, lo_edge_val, from_above)
    hi = jnp.where(idx == size - 1, hi_edge_val, from_below)
    return lo, hi


def _exchange_and_extend_u(u_loc: jnp.ndarray) -> jnp.ndarray:
    """(3, m_loc, n_loc) field block -> (3, m_loc+2, n_loc+2) extension
    with neighbour halos at internal tile edges and the reduced-system
    mirror semantics at global edges (ops.elop.extend_interior):
    ext(-1) mirrors interior index 1; global corners get 2x the diagonal
    interior value."""
    # phase 1: columns (ty axis).  Global-edge value: mirror col 1 / -2.
    lo_c, hi_c = _edge_halo_1d(
        u_loc, "ty", axis=2,
        lo_edge_val=u_loc[:, :, 1], hi_edge_val=u_loc[:, :, -2],
    )
    uw = jnp.concatenate([lo_c[:, :, None], u_loc, hi_c[:, :, None]], axis=2)

    # phase 2: rows (tx axis) of the column-extended block (corners ride
    # along).  Global-edge value: mirror row 1 / -2 of the extended block.
    lo_r, hi_r = _edge_halo_1d(
        uw, "tx", axis=1,
        lo_edge_val=uw[:, 1, :], hi_edge_val=uw[:, -2, :],
    )
    ue = jnp.concatenate([lo_r[:, None, :], uw, hi_r[:, None, :]], axis=1)

    # Global corners: extend_interior puts 2x the diagonal interior value
    # there; the two-phase mirror produced 1x.  Double exactly the four
    # global-corner elements (each lives on the tile at both global edges).
    ix = jax.lax.axis_index("tx")
    iy = jax.lax.axis_index("ty")
    nx = jax.lax.axis_size("tx")
    ny = jax.lax.axis_size("ty")
    m2, n2 = ue.shape[1], ue.shape[2]
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, m2, n2), 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, m2, n2), 2)
    at_top = (ix == 0) & (rows == 0)
    at_bot = (ix == nx - 1) & (rows == m2 - 1)
    at_left = (iy == 0) & (cols == 0)
    at_right = (iy == ny - 1) & (cols == n2 - 1)
    corner = (at_top | at_bot) & (at_left | at_right)
    return jnp.where(corner, 2.0 * ue, ue)


def _exchange_frame(i_loc: jnp.ndarray, f_top: jnp.ndarray,
                    f_bottom: jnp.ndarray, f_left: jnp.ndarray,
                    f_right: jnp.ndarray) -> jnp.ndarray:
    """(m_loc, n_loc) interior block of the previous frame ->
    (m_loc+2, n_loc+2) block of the *true* frame: internal halos from
    neighbours, global edges from the replicated boundary rows/cols of
    the full (m+2, n+2) frame."""
    m_loc, n_loc = i_loc.shape
    ix = jax.lax.axis_index("tx")
    iy = jax.lax.axis_index("ty")

    # Global-edge columns: frame col 0 / n+1, rows [1 + ix*m_loc, ...).
    lo_col_edge = jax.lax.dynamic_slice(f_left, (1 + ix * m_loc,), (m_loc,))
    hi_col_edge = jax.lax.dynamic_slice(f_right, (1 + ix * m_loc,), (m_loc,))
    lo_c, hi_c = _edge_halo_1d(i_loc, "ty", axis=1,
                               lo_edge_val=lo_col_edge, hi_edge_val=hi_col_edge)
    fw = jnp.concatenate([lo_c[:, None], i_loc, hi_c[:, None]], axis=1)

    # Global-edge rows: frame row 0 / m+1, cols [iy*n_loc, iy*n_loc+n_loc+2)
    # (the strip includes the two extension columns).
    lo_row_edge = jax.lax.dynamic_slice(f_top, (iy * n_loc,), (n_loc + 2,))
    hi_row_edge = jax.lax.dynamic_slice(f_bottom, (iy * n_loc,), (n_loc + 2,))
    lo_r, hi_r = _edge_halo_1d(fw, "tx", axis=0,
                               lo_edge_val=lo_row_edge, hi_edge_val=hi_row_edge)
    return jnp.concatenate([lo_r[None, :], fw, hi_r[None, :]], axis=0)


def make_sharded_xla_matvec(
    mesh: Mesh,
    previous_frame: jnp.ndarray,
    speed_alpha,
    remodelling_alpha,
    dy_mode: str = "compat",
) -> Callable:
    """One-exchange-per-application sharded stencil matvec.

    Why this exists: letting GSPMD partition ``elop.el_matvec_reduced``
    inserts a collective for EVERY stencil shift — counted in the
    compiled HLO at 64^2 on a (tx=4, ty=2) mesh: **51 collective-permutes
    + 3 all-gathers + 162 dynamic-slices per single matvec application**,
    each with a fixed launch and synchronisation cost, at ~12 applications
    per Krylov iteration.

    The fix is the classic halo-exchange structure (SURVEY section 2.4):
    a ``shard_map`` in which each device exchanges its 1-pixel field halo
    (and the frame block's) with its (tx, ty) neighbours ONCE per
    application — 8 ppermutes total vs GSPMD's 51 — and then rebuilds
    the local EL coefficients and applies the whole 9-point/3-field
    stencil locally.  Krylov state remains in plain GSPMD interior
    layout; dots psum as before.

    ``previous_frame``: the full (m+2, n+2) *normalised* frame (as inside
    flow.variational.solve_frame_pair).  Requires m % tx == 0 and
    n % ty == 0 (no implicit padding).
    """
    from opticalflow_tpu.ops import elop

    ni, nj = previous_frame.shape
    m, n = ni - 2, nj - 2
    tx = mesh.shape["tx"]
    ty = mesh.shape["ty"]
    if m % tx or n % ty:
        raise ValueError(
            f"interior {m}x{n} must tile evenly over (tx, ty)=({tx},{ty})"
        )
    dtype = previous_frame.dtype
    a_s = jnp.asarray(speed_alpha, dtype=dtype)
    a_r = jnp.asarray(remodelling_alpha, dtype=dtype)

    i_int = previous_frame[1:-1, 1:-1]
    f_top = previous_frame[0, :]
    f_bottom = previous_frame[-1, :]
    f_left = previous_frame[:, 0]
    f_right = previous_frame[:, -1]

    plane = P("tx", "ty")
    # the alphas are per-pair values (the solver normalises speed_alpha by
    # the pair's intensity scale), so under the frame-pair vmap they are
    # BATCHED — they must be explicit shard_map operands (batched closure
    # captures do not pick up the vmap's spmd_axis_name spec)
    scalars = jnp.stack([a_s, a_r])

    def local_matvec(sc, i_loc, top, bottom, left, right, u_loc):
        # ONE two-phase halo exchange each for the frame block and the
        # field (8 ppermutes total), then a purely local coefficient
        # build + stencil application — mirror semantics at global edges
        # included.  The coefficient build repeats per application (pure
        # local elementwise work, ~15 ops on the block) because a
        # factory-time shard_map whose outputs are captured inside the
        # solver's vmapped while_loops does not lower; this per-call
        # structure lowers fine.
        f_ext = _exchange_frame(i_loc, top, bottom, left, right)
        pair = elop.compute_frame_pair_data(f_ext, f_ext, sc[0], sc[1], dy_mode)
        u_ext = _exchange_and_extend_u(u_loc)
        return elop.interior_apply(pair.coeffs, u_ext)

    fn = jax.shard_map(
        local_matvec,
        mesh=mesh,
        in_specs=(P(), plane, P(), P(), P(), P(), P(None, "tx", "ty")),
        out_specs=P(None, "tx", "ty"),
        check_vma=False,
    )

    def matvec(u_int: jnp.ndarray) -> jnp.ndarray:
        return fn(scalars, i_int, f_top, f_bottom, f_left, f_right, u_int)

    return matvec
