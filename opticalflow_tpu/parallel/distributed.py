"""Multi-host (multi-process) execution: the frames axis across hosts.

The reference is strictly serial (SURVEY.md section 2.4), so this module
is pure new design, following the workload's structure: consecutive
frame pairs are independent (cold start), so the ``frames`` mesh axis is
the one that crosses hosts — frame-pair traffic rides the inter-host
network while each pair's spatial tiling and Krylov reductions stay
within a host's devices (put the bandwidth-insensitive axis on the slow
network).

Layout: the global mesh is ``(frames, tx, ty)`` where
``frames = num_processes * frames_per_process``.  Each process feeds its
own frame pairs with :func:`jax.make_array_from_process_local_data`, the
jitted solve runs as one SPMD program over all hosts' devices, and each
process reads back only its addressable shards.  No host ever
materialises the whole movie.

Run one process per host with::

    from opticalflow_tpu.parallel import distributed
    distributed.initialize()          # env-driven, see below
    result = distributed.distributed_variational_solve(local_movie, ...)

Environment variables understood by :func:`initialize` (needed wherever
the cluster environment does not tell JAX its topology):

* ``OFTPU_COORDINATOR``   — ``host:port`` of process 0
* ``OFTPU_NUM_PROCESSES`` — world size
* ``OFTPU_PROCESS_ID``    — this process's rank
* ``OFTPU_CPU_DEVICES``   — (testing) per-process virtual CPU device
  count; also switches the backend to CPU with gloo collectives, which
  is how the two-process CI test runs without a pod.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_devices: Optional[int] = None,
) -> None:
    """Initialise jax.distributed for a multi-host run.

    The arguments / env vars give JAX the coordinator, world size and
    rank (cluster managers JAX knows can supply them instead).  Must be
    called before the first JAX backend query.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("OFTPU_COORDINATOR")
    if num_processes is None and "OFTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["OFTPU_NUM_PROCESSES"])
    if process_id is None and "OFTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["OFTPU_PROCESS_ID"])
    if cpu_devices is None and "OFTPU_CPU_DEVICES" in os.environ:
        cpu_devices = int(os.environ["OFTPU_CPU_DEVICES"])

    if cpu_devices is not None:
        # CPU-backend test mode: force the CPU platform *via jax.config*
        # (an accelerator plugin would otherwise be selected), use the
        # gloo cross-process collectives, and give each process
        # `cpu_devices` virtual devices.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.config.update("jax_num_cpu_devices", cpu_devices)

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def multihost_mesh(tx: int = 1, ty: int = 1):
    """Global ``(frames, tx, ty)`` mesh with the frames axis spanning
    processes and the (tx, ty) spatial tiling within a process (tx*ty
    must divide the per-process device count).

    Device order is chosen so that consecutive positions along the
    ``frames`` axis map to the same process's devices first — spatial
    halo exchange and Krylov psums for one frame pair never leave a host.
    """
    import jax
    from jax.sharding import Mesh

    procs = jax.process_count()
    local = jax.local_device_count()
    if local % (tx * ty) != 0:
        raise ValueError(
            f"tx*ty={tx * ty} must divide local device count {local}"
        )
    frames_local = local // (tx * ty)

    # sort global devices by (process, local id): frames-major across
    # processes, then local frames, then tile axes
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    arr = np.array(devs).reshape(procs * frames_local, tx, ty)
    return Mesh(arr, ("frames", "tx", "ty"))


def _frames_sharding(mesh):
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec("frames", "tx", "ty"))


def distributed_variational_solve(
    local_pairs: Tuple[np.ndarray, np.ndarray],
    mesh=None,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    dy_mode: str = "compat",
    solver=None,
    dtype=None,
):
    """Solve this process's frame pairs as part of a global SPMD solve.

    ``local_pairs`` is ``(prev_frames, cur_frames)`` with shape
    ``(local_n_pairs, X, Y)`` each — the pairs this host contributes.
    The global batch is the concatenation over processes in rank order.
    Per-process counts may differ and need not align with the mesh: each
    process's batch is padded with zero frames (which solve trivially in
    O(1) iterations) up to the world-wide maximum rounded to this
    process's frame-axis row count, and the padding is sliced off before
    returning.  The world maximum is agreed via a host-level allgather,
    so no caller-side coordination is needed.

    Returns ``(local_u, infos)`` where ``local_u`` is the
    ``(local_n_pairs, 3, X, Y)`` solution block belonging to this
    process and ``infos`` carries per-local-pair iteration counts and
    convergence flags.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec

    from opticalflow_tpu.core.types import SolverConfig
    from opticalflow_tpu.parallel.batch import _batched_pair_solve

    solver = solver or SolverConfig()  # default: multigrid preconditioner
    if mesh is None:
        mesh = multihost_mesh()
    if dtype is None:
        dtype = jnp.float32

    prev_local = np.asarray(local_pairs[0], dtype)
    cur_local = np.asarray(local_pairs[1], dtype)
    n_pairs_in, dim_x, dim_y = prev_local.shape

    # Agree on a common per-process padded count: every process must
    # contribute the same number of frame-axis rows to the global array,
    # and each row block must be whole (make_array_from_process_local_data
    # fails with an opaque shape error otherwise).
    frames_rows_local = max(
        1, mesh.shape["frames"] // jax.process_count()
    )
    counts = np.asarray(
        multihost_utils.process_allgather(np.asarray([n_pairs_in], np.int64))
    ).reshape(-1)
    target = int(np.max(counts))
    target = -(-target // frames_rows_local) * frames_rows_local  # ceil-round
    if target > n_pairs_in:
        pad = np.zeros((target - n_pairs_in, dim_x, dim_y), dtype)
        prev_local = np.concatenate([prev_local, pad], axis=0)
        cur_local = np.concatenate([cur_local, pad], axis=0)
    n_local = target
    n_global = n_local * jax.process_count()

    sharding = _frames_sharding(mesh)
    global_shape = (n_global, dim_x, dim_y)
    prev = jax.make_array_from_process_local_data(sharding, prev_local, global_shape)
    cur = jax.make_array_from_process_local_data(sharding, cur_local, global_shape)
    u_init = jax.device_put(
        jnp.zeros((3, dim_x, dim_y), dtype=dtype),
        NamedSharding(mesh, PartitionSpec(None, "tx", "ty")),
    )

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
    )

    # Re-shard outputs to frames-only so every addressable shard is a
    # whole-pair block (the solve's outputs are tiled over (tx, ty) as
    # well), then gather this process's blocks in global-index order,
    # deduplicating the replicas that frames-only sharding leaves on the
    # (tx, ty) devices.
    frames_only = NamedSharding(mesh, PartitionSpec("frames"))
    reshard = jax.jit(lambda x: x, out_shardings=frames_only)

    def local_block(garr):
        blocks = {}
        for s in reshard(garr).addressable_shards:
            blocks[s.index[0].start or 0] = np.asarray(s.data)
        return np.concatenate([blocks[k] for k in sorted(blocks)], axis=0)

    local_u = local_block(all_u)[:n_pairs_in]
    local_infos = {k: local_block(v)[:n_pairs_in] for k, v in infos.items()}
    return local_u, local_infos
