"""Liu-Shen physics-based optical flow (legacy Jacobi path).

On-device re-design of the reference's deprecated numba kernel
``liu_shen_optical_flow_jit`` (/root/reference/source/optical_flow.py:426-673)
and its driver ``conduct_variational_optical_flow_deprecated`` (:1318-1529):
a fixed-count synchronous (Jacobi) iteration of the Liu-Shen equations,
with a per-pixel 2x2 solve each sweep.  The per-pixel loops become
whole-plane stencil arithmetic inside ``lax.fori_loop``; frame pairs are
vmapped.

Faithful details replicated:
* the movie gets a one-pixel zero border, then mirror BCs (:493-502);
* mirror BCs re-applied to the velocity planes at every iteration (:518-520);
* the 8-neighbour sum ``V_bar`` excludes border-ring neighbours (the
  neighbourhood zeroing at :531-548) while ``V_barx/bary`` include them;
* boundary prefactor 8 / 5 / 3 (interior / edge / corner, :633-643);
* remodelling is carried but never updated (:511-515 — the kernel returns
  its initial value; the reference documents "returned as zeros").
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core.types import FlowResult
from opticalflow_tpu.ops.blur import blur_movie


def _mirror(v):
    v = v.at[0, :].set(v[2, :])
    v = v.at[-1, :].set(v[-3, :])
    v = v.at[:, 0].set(v[:, 2])
    v = v.at[:, -1].set(v[:, -3])
    return v


def _interior(f, di, dj):
    """f(i+di, j+dj) on the interior grid of a bordered plane."""
    ni, nj = f.shape
    return f[1 + di : ni - 1 + di, 1 + dj : nj - 1 + dj]


def _prefactor_plane(m, n, dtype):
    """Boundary prefactor on the interior grid: 8 interior, 5 edges, 3 corners."""
    p = np.full((m, n), 8.0)
    p[0, :] = p[-1, :] = 5.0
    p[:, 0] = p[:, -1] = 5.0
    p[0, 0] = p[0, -1] = p[-1, 0] = p[-1, -1] = 3.0
    return jnp.asarray(p, dtype=dtype)


def _bar8_masked(v):
    """8-neighbour sum with border-ring neighbours excluded (the
    reference's neighbourhood-zeroing, :531-548)."""
    vm = jnp.zeros_like(v).at[1:-1, 1:-1].set(v[1:-1, 1:-1])
    return (
        _interior(vm, -1, 0) + _interior(vm, +1, 0)
        + _interior(vm, 0, -1) + _interior(vm, 0, +1)
        + _interior(vm, -1, -1) + _interior(vm, -1, +1)
        + _interior(vm, +1, -1) + _interior(vm, +1, +1)
    )


def liu_shen_pair(
    prev_b: jnp.ndarray,
    cur_b: jnp.ndarray,
    v_x0: jnp.ndarray,
    v_y0: jnp.ndarray,
    alpha,
    iterations: int,
):
    """Run `iterations` Jacobi sweeps on one bordered frame pair.

    ``prev_b/cur_b``: (Ni+2, Nj+2) mirror-filled bordered frames;
    ``v_x0/v_y0``: bordered initial velocity planes (pixel units).
    Returns bordered (v_x, v_y).
    """
    I = _interior(prev_b, 0, 0)
    dIdx = (_interior(prev_b, 1, 0) - _interior(prev_b, -1, 0)) * 0.5
    dIdy = (_interior(prev_b, 0, 1) - _interior(prev_b, 0, -1)) * 0.5
    dIdx_t = (
        _interior(cur_b, 1, 0) - _interior(cur_b, -1, 0)
        - _interior(prev_b, 1, 0) + _interior(prev_b, -1, 0)
    ) * 0.5
    dIdy_t = (
        _interior(cur_b, 0, 1) - _interior(cur_b, 0, -1)
        - _interior(prev_b, 0, 1) + _interior(prev_b, 0, -1)
    ) * 0.5
    dIdxx = _interior(prev_b, 1, 0) + _interior(prev_b, -1, 0) - 2.0 * I
    dIdyy = _interior(prev_b, 0, 1) + _interior(prev_b, 0, -1) - 2.0 * I
    dIdxy = (
        _interior(prev_b, 1, 1) - _interior(prev_b, 1, -1)
        - _interior(prev_b, -1, 1) + _interior(prev_b, -1, -1)
    ) * 0.25

    m, n = I.shape
    pref = _prefactor_plane(m, n, I.dtype)
    alpha = jnp.asarray(alpha, dtype=I.dtype)

    # 2x2 system matrix (constant over iterations)
    a11 = I * dIdxx - 2.0 * I * I - pref * alpha
    a12 = I * dIdxy
    a22 = I * dIdyy - 2.0 * I * I - pref * alpha
    det = a11 * a22 - a12 * a12

    def body(_, carry):
        v_x, v_y = carry
        v_x = _mirror(v_x)
        v_y = _mirror(v_y)

        dxdVx = (_interior(v_x, 1, 0) - _interior(v_x, -1, 0)) * 0.5
        dydVx = (_interior(v_x, 0, 1) - _interior(v_x, 0, -1)) * 0.5
        dxydVx = (
            _interior(v_x, 1, 1) - _interior(v_x, 1, -1)
            - _interior(v_x, -1, 1) + _interior(v_x, -1, -1)
        ) * 0.25
        vx_barx = _interior(v_x, 1, 0) + _interior(v_x, -1, 0)
        vx_bar8 = _bar8_masked(v_x)

        dxdVy = (_interior(v_y, 1, 0) - _interior(v_y, -1, 0)) * 0.5
        dydVy = (_interior(v_y, 0, 1) - _interior(v_y, 0, -1)) * 0.5
        dxydVy = (
            _interior(v_y, 1, 1) - _interior(v_y, 1, -1)
            - _interior(v_y, -1, 1) + _interior(v_y, -1, -1)
        ) * 0.25
        vy_bary = _interior(v_y, 0, 1) + _interior(v_y, 0, -1)
        vy_bar8 = _bar8_masked(v_y)

        f1 = (
            -I * dIdx_t
            - I * (2.0 * dIdx * dxdVx + dIdy * dxdVy + dIdx * dydVy)
            - I * I * (vx_barx + dxydVy)
            - alpha * vx_bar8
        )
        f2 = (
            -I * dIdy_t
            - I * (2.0 * dIdy * dydVy + dIdx * dydVx + dIdy * dxdVx)
            - I * I * (vy_bary + dxydVx)
            - alpha * vy_bar8
        )

        new_vx = (a22 * f1 - a12 * f2) / det
        new_vy = (a11 * f2 - a12 * f1) / det

        v_x = v_x.at[1:-1, 1:-1].set(new_vx)
        v_y = v_y.at[1:-1, 1:-1].set(new_vy)
        return v_x, v_y

    v_x, v_y = jax.lax.fori_loop(0, iterations, body, (v_x0, v_y0))
    return v_x, v_y


@functools.partial(jax.jit, static_argnames=("iterations",))
def liu_shen_movie(movie, initial_v_x, initial_v_y, alpha, iterations: int,
                   delta_x: float = 1.0, delta_t: float = 1.0):
    """All frame pairs of a (T, X, Y) movie through `iterations` sweeps.

    ``initial_v_x/initial_v_y`` may be a single (X, Y) plane (broadcast
    to every pair, in physical units — scaled by delta_t/delta_x like the
    reference's :507-508) or a per-pair (T-1, X, Y) stack *already in
    pixel units* (the continuation form used by the incremental
    iteration-recording mode, matching the reference's state-carrying
    recording loop at :1458-1470).

    Returns (v_x, v_y) stacks of shape (T-1, X, Y) in pixel units (the
    caller applies physical scaling like the reference's :670-671).
    """
    bordered = jnp.pad(movie, ((0, 0), (1, 1), (1, 1)))
    bordered = jax.vmap(_mirror)(bordered)

    n_pairs = movie.shape[0] - 1
    if initial_v_x.ndim == 2:
        v0x = jnp.broadcast_to(
            jnp.pad(initial_v_x * (delta_t / delta_x), ((1, 1), (1, 1))),
            (n_pairs,) + (movie.shape[1] + 2, movie.shape[2] + 2),
        )
        v0y = jnp.broadcast_to(
            jnp.pad(initial_v_y * (delta_t / delta_x), ((1, 1), (1, 1))),
            (n_pairs,) + (movie.shape[1] + 2, movie.shape[2] + 2),
        )
    else:
        v0x = jnp.pad(initial_v_x, ((0, 0), (1, 1), (1, 1)))
        v0y = jnp.pad(initial_v_y, ((0, 0), (1, 1), (1, 1)))

    def run_pair(prev_b, cur_b, v0x_b, v0y_b):
        vx, vy = liu_shen_pair(prev_b, cur_b, v0x_b, v0y_b, alpha, iterations)
        return vx[1:-1, 1:-1], vy[1:-1, 1:-1]

    v_x, v_y = jax.vmap(run_pair)(bordered[:-1], bordered[1:], v0x, v0y)
    return v_x, v_y


def conduct_variational_optical_flow_deprecated(
    movie,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    speed_alpha: float = 1.0,
    remodelling_alpha: float = 1000.0,
    v_x_guess: float = 0.1,
    v_y_guess: float = 0.1,
    remodelling_guess: float = 0.5,
    max_iterations: int = 10,
    smoothing_sigma: Optional[float] = None,
    return_iterations: bool = False,
    iteration_stepsize: int = 1,
    tolerance: float = 1e-10,
    include_remodelling: bool = True,
    use_liu_shen: bool = False,
    dtype=None,
) -> FlowResult:
    """Drop-in equivalent of the reference's deprecated driver (ref
    :1318-1529), including the iteration-recording mode used by the
    convergence plots.  ``remodelling`` is carried unchanged, as in the
    reference kernel.

    ``tolerance`` and ``include_remodelling`` are accepted and ignored —
    faithfully: the reference kernel declares both but never uses them
    (ref :470-471 documents include_remodelling as "ignored, and exists
    to ensure that this method has the same call signature"; the
    tolerance-based early stop is commented out at ref :1457, :1485-1490
    and ``iterations = max_iterations`` unconditionally at ref :491)."""
    if not use_liu_shen:
        raise ValueError(
            "the deprecated path only supports the Liu-Shen kernel "
            "(matching the reference, ref :1399-1402)"
        )
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    movie = jnp.asarray(movie, dtype=dtype)
    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie, smoothing_sigma=smoothing_sigma)
    else:
        movie_to_analyse = movie

    shape = (movie.shape[1], movie.shape[2])
    init_vx = jnp.full(shape, float(v_x_guess), dtype=dtype)
    init_vy = jnp.full(shape, float(v_y_guess), dtype=dtype)
    init_rem = np.full(shape, float(remodelling_guess))
    scale = delta_x / delta_t

    result = FlowResult(
        original_data=np.asarray(movie),
        blurred_data=np.asarray(movie_to_analyse),
        delta_x=delta_x,
        delta_t=delta_t,
    )
    result["max_iterations"] = max_iterations
    n_pairs = movie.shape[0] - 1

    if return_iterations:
        n_records = max_iterations // iteration_stepsize
        vx_steps = np.zeros((n_pairs, n_records + 1) + shape)
        vy_steps = np.zeros_like(vx_steps)
        vx_steps[:, 0] = np.asarray(init_vx)
        vy_steps[:, 0] = np.asarray(init_vy)
        # incremental continuation, like the reference's recording loop
        # (ref :1458-1470): each record runs `iteration_stepsize` sweeps
        # from the previous record's per-pair state (pixel units)
        if n_records >= 1:
            v_x, v_y = liu_shen_movie(
                movie_to_analyse, init_vx, init_vy, speed_alpha,
                iteration_stepsize, delta_x, delta_t,
            )
            vx_steps[:, 1] = np.asarray(v_x) * scale
            vy_steps[:, 1] = np.asarray(v_y) * scale
        for rec in range(2, n_records + 1):
            v_x, v_y = liu_shen_movie(
                movie_to_analyse, v_x, v_y, speed_alpha,
                iteration_stepsize, delta_x, delta_t,
            )
            vx_steps[:, rec] = np.asarray(v_x) * scale
            vy_steps[:, rec] = np.asarray(v_y) * scale
        speed_steps = np.sqrt(vx_steps**2 + vy_steps**2)
        rem_steps = np.broadcast_to(
            init_rem, (n_pairs, n_records + 1) + shape
        ).copy()
        result["v_x_steps"] = vx_steps
        result["v_y_steps"] = vy_steps
        result["speed_steps"] = speed_steps
        result["remodelling_steps"] = rem_steps
        result["iteration_stepsize"] = iteration_stepsize
        result["v_x"] = vx_steps[:, -1]
        result["v_y"] = vy_steps[:, -1]
        result["speed"] = speed_steps[:, -1]
        result["remodelling"] = rem_steps[:, -1]
    else:
        v_x, v_y = liu_shen_movie(
            movie_to_analyse, init_vx, init_vy, speed_alpha, max_iterations,
            delta_x, delta_t,
        )
        result["v_x"] = np.asarray(v_x) * scale
        result["v_y"] = np.asarray(v_y) * scale
        result["speed"] = np.sqrt(result["v_x"] ** 2 + result["v_y"] ** 2)
        result["remodelling"] = np.broadcast_to(init_rem, (n_pairs,) + shape).copy()

    result["total_iterations"] = max_iterations
    return result
