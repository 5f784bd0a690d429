"""Hyperparameter-sensitivity sweeps for the box-method flow.

On-device equivalents of the reference's box-size and blur-size
analyses (/root/reference/analysis/compare_rho_and_actin.py:377-483 and
:485-614), which run one full ``conduct_optical_flow`` per parameter
value in a serial matplotlib-animation loop.  Here each sweep is a single
vmapped device computation:

* **box-size sweep** — the box sums use :func:`ops.boxsum.box_sum_dynamic`
  (static-length masked-kernel correlations), so the box size is a
  *traced* value and all sizes batch;
* **blur-size sweep** — the Gaussian kernel is evaluated at a static
  maximum radius with the weights outside scipy's ``int(4*sigma + 0.5)``
  radius masked to zero and renormalised, which reproduces
  ``skimage.filters.gaussian`` exactly per sigma while keeping shapes
  static, so sigma is a traced value and all sigmas batch.

Per parameter value the sweep records what the reference's figures plot:
mean speed, speed standard deviation, and the local speed at a set of
probe locations (ref :391-394 / :502-510).
"""

from __future__ import annotations

from typing import Dict, Optional

import functools

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.ops.boxsum import box_sum_dynamic


def _pair_gradients(prev, cur):
    """Frame-pair-averaged central-difference gradients (zero border ring),
    as in flow.boxflow (ref optical_flow.py:88-92)."""
    dIdx = jnp.zeros_like(prev)
    dIdy = jnp.zeros_like(prev)
    dIdx = dIdx.at[1:-1, 1:-1].set(
        (cur[2:, 1:-1] + prev[2:, 1:-1] - cur[:-2, 1:-1] - prev[:-2, 1:-1]) * 0.25
    )
    dIdy = dIdy.at[1:-1, 1:-1].set(
        (cur[1:-1, 2:] + prev[1:-1, 2:] - cur[1:-1, :-2] - prev[1:-1, :-2]) * 0.25
    )
    return dIdx, dIdy


def _box_flow_fields_dynamic(prev, cur, half, max_half: int):
    """Box-method (2x2 branch) velocity fields with a traced box size."""
    dIdx, dIdy = _pair_gradients(prev, cur)
    delta_I = cur - prev
    sum1 = box_sum_dynamic(delta_I * dIdx, half, max_half)
    sum2 = box_sum_dynamic(delta_I * dIdy, half, max_half)
    A = box_sum_dynamic(dIdx * dIdx, half, max_half)
    B = box_sum_dynamic(dIdx * dIdy, half, max_half)
    C = box_sum_dynamic(dIdy * dIdy, half, max_half)
    det = A * C - B * B
    v_x = (-C * sum1 + B * sum2) / det
    v_y = (-A * sum2 + B * sum1) / det
    return v_x, v_y


def _gaussian_blur_traced(movie, sigma, max_radius: int):
    """Edge-replicate separable Gaussian blur with a traced sigma.

    The kernel is sampled on a static ``[-max_radius, max_radius]`` grid,
    masked to scipy's dynamic radius ``int(4*sigma + 0.5)`` and
    renormalised — bitwise the same weights scipy.ndimage uses, with
    static shapes so sigma can batch under vmap.
    """
    x = jnp.arange(-max_radius, max_radius + 1, dtype=movie.dtype)
    radius = jnp.floor(4.0 * sigma + 0.5)
    phi = jnp.exp(-0.5 * (x / sigma) ** 2)
    phi = jnp.where(jnp.abs(x) <= radius, phi, 0.0)
    kernel = phi / jnp.sum(phi)

    def correlate(m, axis):
        pad = [(0, 0)] * m.ndim
        pad[axis] = (max_radius, max_radius)
        padded = jnp.pad(m, pad, mode="edge")
        lhs = padded[:, None]
        rhs = kernel[::-1].reshape((1, 1) + ((-1, 1) if axis == 1 else (1, -1)))
        out = jax.lax.conv_general_dilated(
            lhs, rhs, (1, 1), "VALID", dimension_numbers=("NCHW", "OIHW", "NCHW")
        )
        return out[:, 0]

    return correlate(correlate(movie, 1), 2)


@functools.partial(jax.jit, static_argnames=("max_half",))
def _boxsize_sweep_kernel(prev, cur, halves, location_indices, scale, max_half):
    def one(half):
        v_x, v_y = _box_flow_fields_dynamic(prev, cur, half, max_half)
        speed = jnp.sqrt(v_x**2 + v_y**2) * scale
        local = speed[location_indices[:, 0], location_indices[:, 1]]
        return jnp.mean(speed), jnp.std(speed), local

    return jax.vmap(one)(halves)


@functools.partial(jax.jit, static_argnames=("max_radius", "boxsize"))
def _blursize_sweep_kernel(prev_cur, sigmas, location_indices, scale,
                           max_radius, boxsize):
    from opticalflow_tpu.ops.boxsum import box_sum

    def one(sigma):
        blurred = _gaussian_blur_traced(prev_cur, sigma, max_radius)
        dIdx, dIdy = _pair_gradients(blurred[0], blurred[1])
        delta_I = blurred[1] - blurred[0]
        sum1 = box_sum(delta_I * dIdx, boxsize)
        sum2 = box_sum(delta_I * dIdy, boxsize)
        A = box_sum(dIdx * dIdx, boxsize)
        B = box_sum(dIdx * dIdy, boxsize)
        C = box_sum(dIdy * dIdy, boxsize)
        det = A * C - B * B
        v_x = (-C * sum1 + B * sum2) / det
        v_y = (-A * sum2 + B * sum1) / det
        speed = jnp.sqrt(v_x**2 + v_y**2) * scale
        local = speed[location_indices[:, 0], location_indices[:, 1]]
        return jnp.mean(speed), jnp.std(speed), local

    return jax.vmap(one)(sigmas)


DEFAULT_TEST_LOCATIONS = np.array([[12.5, 7.0], [20.0, 15.0], [22.0, 19.0], [30.0, 19.0]])


def _locations_to_indices(test_locations, delta_x, shape):
    """µm probe coordinates -> pixel indices (ref :396-398 arithmetic:
    index = coordinate / delta_x, clipped into the frame)."""
    idx = np.asarray(test_locations, dtype=float) / float(delta_x)
    idx = np.round(idx).astype(np.int32)
    idx[:, 0] = np.clip(idx[:, 0], 0, shape[0] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, shape[1] - 1)
    return idx


def vary_boxsize(
    movie,
    boxsizes=np.arange(5, 150, 2),
    frame_index: int = 3,
    delta_x: float = 0.0913,
    delta_t: float = 10.0,
    smoothing_sigma: Optional[float] = 1.3,
    test_locations=DEFAULT_TEST_LOCATIONS,
    filename: Optional[str] = None,
    dtype=jnp.float32,
) -> Dict[str, np.ndarray]:
    """Box-size sensitivity sweep on one frame pair
    (ref compare_rho_and_actin.py:377-483: frames [3:5), per-size mean
    speed, speed std, and local speeds at µm probe locations).

    The whole sweep is one device computation (vmap over traced box
    half-widths); the reference recomputes the full flow serially per
    size inside a matplotlib animation callback.
    """
    from opticalflow_tpu.ops.blur import blur_movie

    boxsizes = np.asarray(boxsizes, dtype=int)
    pair = jnp.asarray(np.asarray(movie)[frame_index : frame_index + 2], dtype=dtype)
    if smoothing_sigma is not None:
        pair = blur_movie(pair, smoothing_sigma=smoothing_sigma)
    halves = jnp.asarray(boxsizes // 2, dtype=jnp.int32)
    loc_idx = jnp.asarray(_locations_to_indices(test_locations, delta_x, pair.shape[1:]))
    mean, std, local = _boxsize_sweep_kernel(
        pair[0], pair[1], halves, loc_idx, jnp.asarray(delta_x / delta_t, dtype=dtype),
        int(boxsizes.max()) // 2,
    )
    out = {
        "boxsizes": boxsizes,
        "mean_speeds": np.asarray(mean),
        "speed_stds": np.asarray(std),
        "local_speeds": np.asarray(local).T,  # (n_locations, n_boxsizes)
        "test_locations": np.asarray(test_locations),
        "delta_x": delta_x,
        "delta_t": delta_t,
    }
    if filename is not None:
        np.save(filename, out)
    return out


def vary_blursize(
    movie,
    blur_sizes=np.arange(0.5, 15, 0.1),
    boxsize: int = 21,
    frame_index: int = 3,
    delta_x: float = 0.0913,
    delta_t: float = 10.0,
    test_locations=DEFAULT_TEST_LOCATIONS,
    filename: Optional[str] = None,
    dtype=jnp.float32,
) -> Dict[str, np.ndarray]:
    """Blur-size sensitivity sweep on one frame pair
    (ref compare_rho_and_actin.py:485-614), batched over traced sigmas.
    """
    blur_sizes = np.asarray(blur_sizes, dtype=float)
    pair = jnp.asarray(np.asarray(movie)[frame_index : frame_index + 2], dtype=dtype)
    max_radius = int(4.0 * float(blur_sizes.max()) + 0.5)
    loc_idx = jnp.asarray(_locations_to_indices(test_locations, delta_x, pair.shape[1:]))
    mean, std, local = _blursize_sweep_kernel(
        pair,
        jnp.asarray(blur_sizes, dtype=dtype),
        loc_idx,
        jnp.asarray(delta_x / delta_t, dtype=dtype),
        max_radius,
        int(boxsize),
    )
    out = {
        "blur_sizes": blur_sizes,
        "boxsize": int(boxsize),
        "mean_speeds": np.asarray(mean),
        "speed_stds": np.asarray(std),
        "local_speeds": np.asarray(local).T,
        "test_locations": np.asarray(test_locations),
        "delta_x": delta_x,
        "delta_t": delta_t,
    }
    if filename is not None:
        np.save(filename, out)
    return out
