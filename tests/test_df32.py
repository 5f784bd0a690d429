"""Double-float arithmetic: the error-free transforms are exact as XLA
compiles them, and the df32 refinement residual is far closer to the f64
residual than a plain f32 evaluation."""

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.ops import df32, elop
from opticalflow_tpu.solve import direct


def _f32_operands(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    # magnitudes spread over a few decades, both signs; the exponent gap
    # stays small enough that every exact sum fits an f64
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
    return a.astype(np.float32), b.astype(np.float32)


def test_two_sum_is_exact_under_jit():
    a, b = _f32_operands()
    s, e = jax.jit(df32.two_sum)(jnp.asarray(a), jnp.asarray(b))
    assert s.dtype == jnp.float32 and e.dtype == jnp.float32
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_two_prod_is_exact_under_jit():
    a, b = _f32_operands(seed=1)
    p, e = jax.jit(df32.two_prod)(jnp.asarray(a), jnp.asarray(b))
    assert p.dtype == jnp.float32 and e.dtype == jnp.float32
    # a 24-bit by 24-bit product is exact in f64, and so is p + e
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_df32_residual_beats_plain_f32_by_two_orders():
    """At a near-solution iterate the EL residual is a cancellation of
    terms ~1e4x larger, which plain f32 cannot resolve; the df32 residual
    (the refinement's) must land at least 100x closer to the f64 one."""
    from opticalflow_tpu.core.synth import make_translating_blob_movie

    dim, alpha = 64, 1000.0
    movie, _ = make_translating_blob_movie(
        n_frames=2, dimension=dim, width=20.0, sigma=3.0, v_x=0.15, v_y=0.1,
        dtype=np.float64,
    )
    frames32 = np.asarray(np.asarray(movie) * 100.0, np.float32)
    prev64, cur64 = (frames32[k].astype(np.float64) for k in (0, 1))
    s = float(np.abs(frames32[0]).max())  # exact in f32

    # the normalised system, as the solver builds it, in f64
    pair64 = elop.compute_frame_pair_data(
        jnp.asarray(prev64 / s), jnp.asarray(cur64 / s), alpha / s**2, alpha,
        "compat",
    )
    u64, _ = direct.direct_solve(pair64.coeffs, np.asarray(pair64.rhs))
    x_hi = jnp.asarray(u64[:, 1:-1, 1:-1], jnp.float32)
    b64 = np.asarray(pair64.rhs)[:, 1:-1, 1:-1]
    r64 = b64 - np.asarray(elop.el_matvec_reduced(
        pair64.coeffs, jnp.asarray(np.asarray(x_hi, np.float64))))

    s32 = jnp.float32(s)
    prev32, cur32 = jnp.asarray(frames32[0]), jnp.asarray(frames32[1])
    dfd = elop.compute_frame_pair_data_df(
        prev32, cur32, jnp.float32(alpha), alpha, "compat", s32
    )
    r_df = np.asarray(jax.jit(elop.el_residual_df)(dfd, x_hi, jnp.zeros_like(x_hi)))
    pair32 = elop.compute_frame_pair_data(
        prev32 / s32, cur32 / s32, jnp.float32(alpha) / s32**2, alpha, "compat"
    )
    r32 = np.asarray(pair32.rhs[:, 1:-1, 1:-1] - elop.el_matvec_reduced(
        pair32.coeffs, x_hi))

    assert r_df.dtype == np.float32 and r32.dtype == np.float32
    err_df = np.linalg.norm(r_df - r64)
    err_32 = np.linalg.norm(r32 - r64)
    assert err_df * 100.0 <= err_32, (err_df, err_32)
