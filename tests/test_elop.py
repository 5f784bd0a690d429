"""The EL operator / assembly / preconditioner against the write-for-write
reference-semantics oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from opticalflow_tpu.ops import elop
from opticalflow_tpu.solve import direct
from tests.oracles import reference_el_system

NI, NJ = 9, 12


@pytest.fixture(scope="module", params=["compat", "fixed"])
def system(request):
    rng = np.random.default_rng(7)
    prev = rng.random((NI, NJ)) * 10.0
    cur = prev + rng.standard_normal((NI, NJ)) * 0.3
    a_s, a_r = 2.5, 40.0
    pair = elop.compute_frame_pair_data(
        jnp.asarray(prev), jnp.asarray(cur), a_s, a_r, dy_mode=request.param
    )
    A_ref, b_ref = reference_el_system(prev, cur, a_s, a_r, compat_dy=(request.param == "compat"))
    return pair, A_ref, b_ref


def test_assembled_matrix_matches_reference_semantics(system):
    pair, A_ref, _ = system
    A_mine = direct.assemble_el_matrix(pair.coeffs, NI, NJ)
    dense_diff = np.abs((A_mine - A_ref).toarray())
    assert dense_diff.max() < 1e-12


def test_rhs_matches_reference_semantics(system):
    pair, _, b_ref = system
    b_mine = direct.fields_to_flat(np.asarray(pair.rhs))
    np.testing.assert_allclose(b_mine, b_ref, rtol=0, atol=1e-12)


def test_matvec_matches_assembled_matrix(system):
    pair, A_ref, _ = system
    rng = np.random.default_rng(11)
    for _ in range(3):
        u = rng.standard_normal((3, NI, NJ))
        y_mine = np.asarray(elop.el_matvec(pair.coeffs, jnp.asarray(u)))
        y_ref = direct.flat_to_fields(A_ref @ direct.fields_to_flat(u), NI, NJ)
        np.testing.assert_allclose(y_mine, y_ref, rtol=1e-12, atol=1e-10)


def test_block_jacobi_is_exact_blockwise_inverse(system):
    """M^{-1} applied to r must agree with solving the 3x3 diagonal blocks
    of the assembled matrix."""
    pair, A_ref, _ = system
    rng = np.random.default_rng(13)
    r = rng.standard_normal((3, NI, NJ))
    out = np.asarray(elop.block_jacobi_inverse_apply(pair.coeffs, jnp.asarray(r)))

    r_flat = direct.fields_to_flat(r)
    want = np.zeros_like(r_flat)
    A_dense = A_ref.toarray()
    for p in range(NI * NJ):
        sl = slice(3 * p, 3 * p + 3)
        block = A_dense[sl, sl]
        i, j = divmod(p, NJ)
        if i in (0, NI - 1) or j in (0, NJ - 1):
            block = np.eye(3)  # boundary rows: identity block by construction
        want[sl] = np.linalg.solve(block, r_flat[sl])
    np.testing.assert_allclose(out, direct.flat_to_fields(want, NI, NJ), rtol=1e-9, atol=1e-9)


def test_reduced_system_is_exact(system):
    """Folding the boundary rows must reproduce the full solve exactly."""
    import scipy.sparse.linalg

    pair, A_ref, b_ref = system
    x_full = scipy.sparse.linalg.spsolve(A_ref, b_ref)
    u_full = direct.flat_to_fields(x_full, NI, NJ)

    # interior residual of the reduced operator at the full solution
    u_int = jnp.asarray(u_full[:, 1:-1, 1:-1])
    y = np.asarray(elop.el_matvec_reduced(pair.coeffs, u_int))
    b_red = np.asarray(pair.rhs)[:, 1:-1, 1:-1]
    np.testing.assert_allclose(y, b_red, rtol=1e-7, atol=1e-9)


def test_extend_interior_matches_constraints(system):
    pair, A_ref, _ = system
    rng = np.random.default_rng(3)
    u_int = rng.standard_normal((3, NI - 2, NJ - 2))
    u_full = np.asarray(elop.extend_interior(jnp.asarray(u_int)))
    # every boundary row of the full operator must vanish on the extension
    y = A_ref @ direct.fields_to_flat(u_full)
    y_fields = direct.flat_to_fields(y, NI, NJ)
    boundary = np.ones((NI, NJ), dtype=bool)
    boundary[1:-1, 1:-1] = False
    assert np.abs(y_fields[:, boundary]).max() < 1e-12


def _extend_oracle(u_int):
    """Full-grid field from an interior one by the boundary rows of the
    assembled system: edges mirror across the boundary, and each corner row
    ``q(0,0) - q(2,0) - q(0,2) = 0`` sums its two edge mirrors."""
    _, m, n = u_int.shape
    u = np.zeros((3, m + 2, n + 2))
    u[:, 1:-1, 1:-1] = u_int
    u[:, 0, 1:-1] = u[:, 2, 1:-1]
    u[:, -1, 1:-1] = u[:, -3, 1:-1]
    u[:, 1:-1, 0] = u[:, 1:-1, 2]
    u[:, 1:-1, -1] = u[:, 1:-1, -3]
    u[:, 0, 0] = u[:, 2, 0] + u[:, 0, 2]
    u[:, 0, -1] = u[:, 2, -1] + u[:, 0, -3]
    u[:, -1, 0] = u[:, -3, 0] + u[:, -1, 2]
    u[:, -1, -1] = u[:, -3, -1] + u[:, -1, -3]
    return u


def _blob_pair(m, n, dy_mode, seed=1):
    from opticalflow_tpu.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(
        n_frames=2, dimension=max(m, n) + 2, width=10.0, sigma=3.0,
        v_x=0.2, v_y=0.1, dtype=jnp.float64,
    )
    movie = np.asarray(movie)[:, : m + 2, : n + 2] * 100.0
    pair = elop.compute_frame_pair_data(
        jnp.asarray(movie[0]), jnp.asarray(movie[1]), 800.0, 900.0, dy_mode
    )
    u = np.random.default_rng(seed).standard_normal((3, m, n))
    return movie, pair, u


@pytest.mark.parametrize("shape", [(30, 40), (128, 254), (254, 254)])
@pytest.mark.parametrize("dy_mode", ["compat", "fixed"])
def test_reduced_matvec_matches_assembled_matrix(shape, dy_mode):
    """The reduced stencil equals the interior rows of the assembled full
    system applied to the boundary-constrained extension of the field, at
    the frame sizes the bench and the chip check run."""
    m, n = shape
    _, pair, u = _blob_pair(m, n, dy_mode)
    y = np.asarray(elop.el_matvec_reduced(pair.coeffs, jnp.asarray(u)))
    A = direct.assemble_el_matrix(pair.coeffs, m + 2, n + 2)
    y_full = direct.flat_to_fields(
        A @ direct.fields_to_flat(_extend_oracle(u)), m + 2, n + 2
    )
    scale = np.abs(y_full).max()
    np.testing.assert_allclose(y, y_full[:, 1:-1, 1:-1], rtol=0, atol=1e-12 * scale)


def test_reduced_matvec_under_vmap_matches_per_pair():
    """A frame-pair batch (vmap over coefficients and fields) gives each
    pair's own matvec."""
    import jax

    m = n = 62
    from opticalflow_tpu.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(
        n_frames=4, dimension=m + 2, width=10.0, sigma=3.0, v_x=0.2, v_y=0.1,
        dtype=jnp.float64,
    )
    movie = jnp.asarray(np.asarray(movie) * 100.0)
    us = jnp.asarray(np.random.default_rng(7).standard_normal((3, 3, m, n)))

    def one(prev, cur, u):
        pair = elop.compute_frame_pair_data(prev, cur, 800.0, 900.0, "compat")
        return elop.el_matvec_reduced(pair.coeffs, u)

    y_batch = np.asarray(jax.vmap(one)(movie[:-1], movie[1:], us))
    for k in range(3):
        y_k = np.asarray(one(movie[k], movie[k + 1], us[k]))
        np.testing.assert_allclose(y_batch[k], y_k, rtol=1e-13, atol=1e-9)
