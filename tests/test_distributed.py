"""Multi-host story: a REAL two-process jax.distributed run on CPU.

The reference is serial (SURVEY.md section 2.4); BASELINE.md config 5
(multi-host sweep) is the promised new-design component.  This
test exercises the full multi-process machinery without a pod: two OS
processes, each with 2 virtual CPU devices, form one 4-device global
mesh (frames axis across processes = the inter-host axis, spatial tiles
within a process), run one SPMD variational solve through
opticalflow_tpu.parallel.distributed, and their gathered local blocks
must match the single-process solution.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve_matches_single(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # the workers configure their own backend (cpu + gloo + 2 devices via
    # jax.config); scrub the parent's virtual-device flag so it can't
    # fight the worker settings
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(rank), "2", str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"

    r0 = np.load(tmp_path / "rank0.npz")
    r1 = np.load(tmp_path / "rank1.npz")
    assert int(r0["process_count"]) == 2
    assert int(r0["global_devices"]) == 4
    assert r0["converged"].all() and r1["converged"].all()

    # unequal contribution (2 pairs vs 1): the padding lane must be
    # sliced off before return, so each process gets back exactly what
    # it put in
    assert r0["local_u"].shape[0] == 2
    assert r1["local_u"].shape[0] == 1
    all_u = np.concatenate([r0["local_u"], r1["local_u"]], axis=0)

    # single-process reference (this pytest process, virtual 8-dev mesh)
    import jax

    from opticalflow_tpu.core.synth import make_translating_blob_movie
    from opticalflow_tpu.core.types import SolverConfig
    from opticalflow_tpu.parallel import mesh as mesh_lib
    from opticalflow_tpu.parallel.batch import sharded_variational_solve

    movie, _ = make_translating_blob_movie(
        n_frames=5, dimension=24, width=10.0, sigma=2.5, v_x=0.2, v_y=0.1
    )
    movie = np.asarray(movie) * 100.0
    single_mesh = mesh_lib.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    u_ref, _ = sharded_variational_solve(
        movie, mesh=single_mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        solver=SolverConfig(preconditioner="block_jacobi"),
        dtype=np.float64,
    )
    # cross-process reduction order differs from single-device -> agreement
    # to solver tolerance, not bitwise (same bound as tests/test_parallel.py)
    np.testing.assert_allclose(all_u, np.asarray(u_ref)[:3], rtol=1e-3, atol=1e-4)
