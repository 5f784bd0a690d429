"""Distributed execution on the virtual 8-device CPU mesh: sharded results
must match the single-device path bit-for-bit-ish (tiled-vs-untiled
comparison, SURVEY.md section 5 'race detection' analogue)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.core.types import SolverConfig
from opticalflow_tpu.parallel import mesh as mesh_lib
from opticalflow_tpu.parallel.batch import sharded_box_flow, sharded_variational_solve

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)


@pytest.fixture(scope="module")
def movie():
    movie, _ = make_translating_blob_movie(
        n_frames=5, dimension=32, width=10.0, sigma=2.0, v_x=0.1, v_y=0.05
    )
    return np.asarray(movie) * 100.0


def test_mesh_factoring():
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    assert mesh.shape["frames"] * mesh.shape["tx"] * mesh.shape["ty"] == 8
    mesh2 = mesh_lib.make_mesh(jax.devices()[:8], frames=2, tx=2, ty=2)
    assert dict(mesh2.shape) == {"frames": 2, "tx": 2, "ty": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(jax.devices()[:8], frames=3, tx=2, ty=2)


def test_mesh_partial_and_workload_spec():
    """Partially-specified axes are honoured (r3/r4 weak item: they used
    to be silently discarded) and the single-pair workload tiles
    near-square with frames pinned to 1."""
    devs = jax.devices()[:8]
    m = mesh_lib.make_mesh(devs, frames=1)
    assert dict(m.shape) == {"frames": 1, "tx": 4, "ty": 2}
    m = mesh_lib.make_mesh(devs, frames=2, tx=2)
    assert dict(m.shape) == {"frames": 2, "tx": 2, "ty": 2}
    m = mesh_lib.make_mesh(devs, ty=2)
    assert dict(m.shape) == {"frames": 4, "tx": 1, "ty": 2}
    m = mesh_lib.make_mesh(devs, workload="single_pair")
    assert dict(m.shape) == {"frames": 1, "tx": 4, "ty": 2}
    m6 = mesh_lib.make_mesh(jax.devices()[:6], workload="single_pair")
    assert dict(m6.shape) == {"frames": 1, "tx": 3, "ty": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(devs, frames=3)
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(devs, workload="nope")


def test_sharded_variational_matches_single_device(movie):
    mesh = mesh_lib.make_mesh(jax.devices()[:8], frames=2, tx=2, ty=2)
    all_u_sharded, infos = sharded_variational_solve(
        movie, mesh=mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        dtype=jnp.float64,
    )

    single_mesh = mesh_lib.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    all_u_single, _ = sharded_variational_solve(
        movie, mesh=single_mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        dtype=jnp.float64,
    )
    # different meshes change reduction order -> Krylov paths diverge at
    # machine level; solutions agree to the solve tolerance, not bitwise
    np.testing.assert_allclose(
        np.asarray(all_u_sharded), np.asarray(all_u_single), rtol=1e-3, atol=1e-4
    )
    assert np.asarray(infos["converged"]).all()


def test_frames_only_shard_map_matches_single_device(movie):
    """Frames-only meshes take the shard_map path (per-device independent
    while loops — no per-iteration frames-axis all-reduce);
    it must reproduce the single-device batched solve bitwise: each pair's
    Krylov iteration is unchanged, only its device placement moves."""
    mesh = mesh_lib.make_mesh(jax.devices()[:4], frames=4, tx=1, ty=1)
    u_s, infos_s = sharded_variational_solve(
        movie, mesh=mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        dtype=jnp.float64,
    )
    single_mesh = mesh_lib.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    u_1, infos_1 = sharded_variational_solve(
        movie, mesh=single_mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        dtype=jnp.float64,
    )
    np.testing.assert_array_equal(np.asarray(u_s), np.asarray(u_1))
    np.testing.assert_array_equal(
        np.asarray(infos_s["iterations"]), np.asarray(infos_1["iterations"])
    )
    assert np.asarray(infos_s["converged"]).all()


def test_sharded_multigrid_parity_and_iterations(movie):
    """The sharded path must keep the multigrid
    preconditioner (now the default) instead of degrading to block-Jacobi
    — comb probing, the Galerkin hierarchy, and the coarse LU must all
    compile and converge under GSPMD, in production f32, at block-Jacobi
    counts' fraction (~25 vs 180-550 iterations)."""
    mesh = mesh_lib.make_mesh(jax.devices()[:8], frames=2, tx=2, ty=2)
    u_s, infos = sharded_variational_solve(
        movie, mesh=mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        solver=SolverConfig(preconditioner="multigrid"), dtype=jnp.float32,
    )
    single_mesh = mesh_lib.make_mesh(jax.devices()[:1], frames=1, tx=1, ty=1)
    u_1, infos_1 = sharded_variational_solve(
        movie, mesh=single_mesh, speed_alpha=500.0, remodelling_alpha=500.0,
        solver=SolverConfig(preconditioner="multigrid"), dtype=jnp.float32,
    )
    assert np.asarray(infos["converged"]).all()
    assert np.asarray(infos_1["converged"]).all()
    # multigrid-class iteration counts (incl. adaptive refinement solves),
    # nowhere near block-Jacobi's 180-550 on the same systems
    assert int(np.asarray(infos["iterations"]).max()) < 120
    # f32 Krylov paths diverge with reduction order; both runs satisfy the
    # df32 true-residual tolerance, so solutions agree to solve tolerance
    np.testing.assert_allclose(
        np.asarray(u_s), np.asarray(u_1), rtol=5e-3, atol=5e-4
    )


def test_sharded_box_flow_matches_single_device(movie):
    from opticalflow_tpu.flow.boxflow import box_flow

    mesh = mesh_lib.make_mesh(jax.devices()[:8], frames=2, tx=2, ty=2)
    vx_s, vy_s, speed_s, _ = sharded_box_flow(
        movie, box_size=7, mesh=mesh, delta_x=0.5, dtype=jnp.float64
    )
    vx, vy, speed, _ = box_flow(jnp.asarray(movie, jnp.float64), 7, 0.5, 1.0, False)
    np.testing.assert_allclose(np.asarray(vx_s), np.asarray(vx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(speed_s), np.asarray(speed), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize(
    "dims,tiles",
    [
        ((130, 130), (2, 2)),  # 128^2 interior, square tiling, 65x65 shards
        ((128, 96), (2, 4)),   # non-square image, non-square 64x24 shards
    ],
)
def test_sharded_reduced_matvec_matches_untiled_at_size(dims, tiles):
    """The boundary-row fold-in (ops.elop._extend_with_corners) under GSPMD
    tiling at sizes where one shard does NOT span the whole boundary region
    — the exact scatter-partitioning hazard the concat-based extension
    works around.  The matvec is deterministic elementwise arithmetic, so
    tiled and untiled must agree to fp-roundoff, not solver tolerance
    (rtol 1e-11: partition boundaries change fusion/FMA choices, measured
    ~1e-13 relative; a genuine boundary miscompile produces O(1) errors)."""
    from opticalflow_tpu.ops import elop

    ni, nj = dims
    tx, ty = tiles
    rng = np.random.default_rng(7)
    prev = jnp.asarray(rng.normal(size=(ni, nj)), jnp.float64)
    cur = jnp.asarray(prev + 0.01 * rng.normal(size=(ni, nj)), jnp.float64)
    # full-grid field; the interior slice happens inside jit so GSPMD owns
    # the (odd-sized) repartitioning, like in the real solve pipeline
    u_full = jnp.asarray(rng.normal(size=(3, ni, nj)), jnp.float64)

    @jax.jit
    def matvec(p, c, uu):
        pd = elop.compute_frame_pair_data(p, c, 1000.0, 1000.0, "compat")
        return elop.el_matvec_reduced(pd.coeffs, uu[:, 1:-1, 1:-1])

    y_ref = np.asarray(matvec(prev, cur, u_full))

    mesh = mesh_lib.make_mesh(jax.devices()[: tx * ty], frames=1, tx=tx, ty=ty)
    tile_spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("tx", "ty")
    )
    field_spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "tx", "ty")
    )
    y_tiled = np.asarray(
        matvec(
            jax.device_put(prev, tile_spec),
            jax.device_put(cur, tile_spec),
            jax.device_put(u_full, field_spec),
        )
    )
    np.testing.assert_allclose(y_tiled, y_ref, rtol=1e-11, atol=1e-11)


def test_sharded_xla_matvec_parity():
    """The one-exchange-per-application shard_map matvec (the fix for
    GSPMD's 51 collectives per matvec, see parallel.halo) must equal
    el_matvec_reduced exactly on a (tx, ty) mesh."""
    import jax.numpy as jnp

    from opticalflow_tpu.ops import elop
    from opticalflow_tpu.parallel import halo

    mesh = mesh_lib.make_mesh(jax.devices()[:4], frames=1, tx=2, ty=2)
    rng = np.random.default_rng(5)
    ni = nj = 26  # interior 24 divides (2, 2)
    prev = jnp.asarray(rng.normal(size=(ni, nj)))
    u = jnp.asarray(rng.normal(size=(3, ni - 2, nj - 2)))
    a_s, a_r = jnp.asarray(700.0), jnp.asarray(800.0)

    for dy_mode in ("compat", "fixed"):
        pair = elop.compute_frame_pair_data(prev, prev * 1.01, a_s, a_r, dy_mode)
        ref = elop.el_matvec_reduced(pair.coeffs, u)
        mv = halo.make_sharded_xla_matvec(mesh, prev, a_s, a_r, dy_mode)
        out = mv(u)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)
