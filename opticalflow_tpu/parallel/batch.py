"""Sharded batched execution of the flow solvers over a device mesh.

Frame pairs are sharded over the ``frames`` mesh axis and each image is
tiled over ``(tx, ty)``.  Arrays are placed with NamedShardings and the
solver is ``jit``-compiled over the mesh — the XLA SPMD partitioner
inserts the 1-2 pixel halo exchanges for every stencil shift and turns
the Krylov dot products into cross-chip ``psum``s (the scaling-book
recipe: annotate shardings, let XLA place collectives).

The batched path runs frame pairs cold-start (``warm_start='cold'``): the
reference's sequential warm-start chain (ref optical_flow.py:803-806)
serialises pairs, so batching trades a few extra Krylov iterations per
pair for full data parallelism — a deliberate, documented semantic choice
(SURVEY.md section 2.4).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core.types import SolverConfig
from opticalflow_tpu.flow.variational import solve_frame_pair
from opticalflow_tpu.parallel import mesh as mesh_lib


@functools.partial(
    jax.jit,
    static_argnames=(
        "dy_mode", "method", "preconditioner", "max_iterations",
        "high_precision_reductions", "matvec_impl", "mesh", "gmres_restart",
    ),
)
def _batched_pair_solve(
    prev_frames,
    cur_frames,
    u_init,
    speed_alpha,
    remodelling_alpha,
    rtol,
    dy_mode="compat",
    method="bicgstab",
    preconditioner="multigrid",
    max_iterations=1000,
    high_precision_reductions=True,
    matvec_impl="xla",
    mesh=None,
    gmres_restart=32,
):
    # Matvec under spatial tiling: GSPMD partitioning of the stencil
    # inserts a collective per shift (~51 collective-permutes per matvec,
    # counted in HLO), so whenever the mesh actually tiles the image the
    # matvec runs as an explicit shard_map with ONE two-phase ppermute
    # halo exchange per application (parallel.halo).  'gspmd' keeps the
    # fully automatic partitioning (the reference point the HLO counts
    # were measured against).  The frame-pair vmap axis is pinned to the
    # 'frames' mesh axis via spmd_axis_name when a factory is used.
    factory = None
    tiled = mesh is not None and mesh.shape["tx"] * mesh.shape["ty"] > 1
    # the manual-exchange factory shards the interior exactly; an
    # interior that does not divide the (tx, ty) mesh falls back to GSPMD
    divisible = tiled and (
        (prev_frames.shape[1] - 2) % mesh.shape["tx"] == 0
        and (prev_frames.shape[2] - 2) % mesh.shape["ty"] == 0
    )
    if matvec_impl != "gspmd" and divisible:
        from opticalflow_tpu.parallel import halo

        factory = functools.partial(halo.make_sharded_xla_matvec, mesh)
    solver = functools.partial(
        solve_frame_pair,
        speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha,
        dy_mode=dy_mode,
        method=method,
        preconditioner=preconditioner,
        rtol=rtol,
        max_iterations=max_iterations,
        high_precision_reductions=high_precision_reductions,
        matvec_factory=factory,
        gmres_restart=gmres_restart,
    )
    vmap_kwargs = {"spmd_axis_name": "frames"} if factory is not None else {}
    return jax.vmap(lambda p, c: solver(p, c, u_init), **vmap_kwargs)(
        prev_frames, cur_frames
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "dy_mode", "method", "preconditioner", "max_iterations",
        "high_precision_reductions", "mesh", "gmres_restart",
    ),
)
def _frames_sharded_solve(
    prev_frames,
    cur_frames,
    u_init,
    speed_alpha,
    remodelling_alpha,
    rtol,
    dy_mode="compat",
    method="bicgstab",
    preconditioner="multigrid",
    max_iterations=1000,
    high_precision_reductions=True,
    mesh=None,
    gmres_restart=32,
):
    """Frames-only meshes: per-device INDEPENDENT while loops via shard_map.

    The GSPMD alternative (``_batched_pair_solve``) vmaps a while_loop
    over the frames-sharded batch, and vmap's while rule makes the loop
    condition ``any(active)`` over the WHOLE batch — an all-reduce across
    the frames axis every Krylov iteration, plus a straggler coupling
    (every device steps until the globally slowest pair converges).
    Under shard_map each device runs its own while_loop over only its
    local pairs: zero per-iteration collectives on the frames axis, and
    a device that finishes early actually finishes (its pairs' trip count
    is the local max, not the global max).  Across hosts this removes
    the only per-iteration cross-host sync of the data-parallel path.
    """
    P = jax.sharding.PartitionSpec
    solver = functools.partial(
        solve_frame_pair,
        dy_mode=dy_mode,
        method=method,
        preconditioner=preconditioner,
        rtol=rtol,
        max_iterations=max_iterations,
        high_precision_reductions=high_precision_reductions,
        gmres_restart=gmres_restart,
    )

    def local(p, c, u0, a_s, a_r):
        return jax.vmap(lambda pp, cc: solver(pp, cc, u0, a_s, a_r))(p, c)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("frames"), P("frames"), P(), P(), P()),
        out_specs=(P("frames"), P("frames")),
        check_vma=False,
    )
    return fn(prev_frames, cur_frames, u_init, speed_alpha, remodelling_alpha)


def sharded_variational_solve(
    movie,
    mesh: Optional[jax.sharding.Mesh] = None,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    dy_mode: str = "compat",
    solver: Optional[SolverConfig] = None,
    dtype=jnp.float32,
):
    """Solve all frame pairs of a movie, sharded pairs x tiles over the mesh.

    Returns ``(all_u, infos)`` like the single-chip batched path; unit
    scaling and FlowResult packaging are the caller's concern (see
    flow.variational.variational_optical_flow for the single-chip
    equivalent).
    """
    solver = solver or SolverConfig()  # default: multigrid preconditioner
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    movie = jnp.asarray(movie, dtype=dtype)

    prev = movie[:-1]
    cur = movie[1:]
    tiled = mesh.shape["tx"] * mesh.shape["ty"] > 1
    interior_divisible = (
        (movie.shape[1] - 2) % mesh.shape["tx"] == 0
        and (movie.shape[2] - 2) % mesh.shape["ty"] == 0
    )
    if tiled and interior_divisible and solver.matvec != "gspmd":
        # manual-exchange matvec path (see _batched_pair_solve): the
        # shard_map tiles the INTERIOR exactly, so the (N+2)-sized frames
        # cannot also divide the mesh — shard inputs along 'frames' only
        # (the coefficient build is one-time) and let the factory's
        # shard_map in_specs constrain the per-iteration state sharding.
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("frames", None, None)
        )
        u_sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    else:
        sharding = mesh_lib.pair_sharding(mesh)
        u_sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "tx", "ty")
        )
    prev = jax.device_put(prev, sharding)
    cur = jax.device_put(cur, sharding)
    u_init = jax.device_put(
        jnp.zeros((3,) + movie.shape[1:], dtype=dtype), u_sharding
    )

    frames_only = (
        not tiled
        and mesh.shape["frames"] > 1
        and prev.shape[0] % mesh.shape["frames"] == 0
        and solver.matvec != "gspmd"
    )
    if frames_only:
        # independent per-device while loops — no per-iteration frames-axis
        # collective, no cross-device straggler coupling (see
        # _frames_sharded_solve; 'gspmd' opts back into the vmapped path)
        all_u, infos = _frames_sharded_solve(
            prev,
            cur,
            u_init,
            jnp.asarray(speed_alpha, dtype=dtype),
            jnp.asarray(remodelling_alpha, dtype=dtype),
            solver.rtol,
            dy_mode=dy_mode,
            method=solver.method,
            preconditioner=solver.preconditioner,
            max_iterations=solver.max_iterations,
            high_precision_reductions=solver.high_precision_reductions,
            mesh=mesh,
            gmres_restart=solver.gmres_restart,
        )
        return all_u, infos

    all_u, infos = _batched_pair_solve(
        prev,
        cur,
        u_init,
        jnp.asarray(speed_alpha, dtype=dtype),
        jnp.asarray(remodelling_alpha, dtype=dtype),
        solver.rtol,
        dy_mode=dy_mode,
        method=solver.method,
        preconditioner=solver.preconditioner,
        max_iterations=solver.max_iterations,
        high_precision_reductions=solver.high_precision_reductions,
        matvec_impl=solver.matvec,
        mesh=mesh,
        gmres_restart=solver.gmres_restart,
    )
    return all_u, infos


def sharded_box_flow(
    movie,
    box_size: int,
    mesh: Optional[jax.sharding.Mesh] = None,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    include_remodelling: bool = False,
    dtype=jnp.float32,
):
    """Box-method flow with frame pairs and tiles sharded over the mesh."""
    from opticalflow_tpu.flow.boxflow import box_flow

    if mesh is None:
        mesh = mesh_lib.make_mesh()
    movie = jnp.asarray(movie, dtype=dtype)
    movie = jax.device_put(
        movie, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "tx", "ty"))
    )
    return box_flow(movie, box_size, delta_x, delta_t, include_remodelling)
