"""Subprocess worker for the multi-host (2-process) distributed test.

Launched by tests/test_distributed.py, one process per "host".  Each
process contributes half of a deterministic synthetic movie's frame
pairs, runs the global SPMD solve via
opticalflow_tpu.parallel.distributed, and saves its local result block
for the parent to verify against the single-process solution.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    rank = int(sys.argv[1])
    world = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]

    from opticalflow_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=world,
        process_id=rank,
        cpu_devices=2,
    )
    import jax

    jax.config.update("jax_enable_x64", True)

    from opticalflow_tpu.core.synth import make_translating_blob_movie
    from opticalflow_tpu.core.types import SolverConfig

    movie, _ = make_translating_blob_movie(
        n_frames=5, dimension=24, width=10.0, sigma=2.5, v_x=0.2, v_y=0.1
    )
    movie = np.asarray(movie) * 100.0
    prev, cur = movie[:-1], movie[1:]

    # Deliberately unequal split (rank 0: two pairs, rank 1: one) to
    # exercise the automatic zero-pair padding + allgathered count
    # agreement in distributed_variational_solve; pair 3 is unused.
    n_local = prev.shape[0] // world
    sl = slice(rank * n_local, (rank + 1) * n_local - rank)

    # 2 local devices as (1 frame) x (1 x 2 tiles): the frames axis spans
    # exactly the two processes (the inter-host axis) and each pair's image is
    # tiled across the process's devices
    mesh = distributed.multihost_mesh(tx=1, ty=2)
    local_u, infos = distributed.distributed_variational_solve(
        (prev[sl], cur[sl]),
        mesh=mesh,
        speed_alpha=500.0,
        remodelling_alpha=500.0,
        solver=SolverConfig(preconditioner="block_jacobi"),
        dtype=np.float64,
    )
    np.savez(
        os.path.join(outdir, f"rank{rank}.npz"),
        local_u=local_u,
        iterations=infos["iterations"],
        converged=infos["converged"],
        process_count=jax.process_count(),
        global_devices=jax.device_count(),
    )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
