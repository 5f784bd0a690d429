"""Box-method optical flow (Vig et al. Biophysical Journal 2016).

On-device re-design of the reference's numba kernel
``conduct_optical_flow_jit`` (/root/reference/source/optical_flow.py:24-157)
and its wrapper ``conduct_optical_flow`` (:159-218).

The reference runs an O(X * Y * box^2) per-pixel loop per frame pair.  Here
the box sums become separable windowed reductions (see ops.boxsum) and the
per-pixel 2x2 / 3x3 normal-equation solves become closed-form vectorized
arithmetic, batched over all frame pairs at once — the whole movie is one
fused XLA computation.

Deliberate deviations from the reference (documented, all quirks of the
original):
* speed is computed as sqrt(v_x^2 + v_y^2) in the remodelling branch too
  (the reference leaves it zero there, ref :131-151);
* the window is clipped with the correct axis length on both axes (the
  reference clamps the y-window with ``movie.shape[1]``, ref :108, which is
  only correct for square images).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core.types import FlowResult
from opticalflow_tpu.ops.blur import blur_movie
from opticalflow_tpu.ops.boxsum import box_sum


def _pair_gradients(prev: jnp.ndarray, cur: jnp.ndarray):
    """Frame-pair-averaged central-difference gradients, zero on the border
    ring (ref :88-92)."""
    dIdx = jnp.zeros_like(prev)
    dIdy = jnp.zeros_like(prev)
    dIdx = dIdx.at[1:-1, 1:-1].set(
        (cur[2:, 1:-1] + prev[2:, 1:-1] - cur[:-2, 1:-1] - prev[:-2, 1:-1]) * 0.25
    )
    dIdy = dIdy.at[1:-1, 1:-1].set(
        (cur[1:-1, 2:] + prev[1:-1, 2:] - cur[1:-1, :-2] - prev[1:-1, :-2]) * 0.25
    )
    return dIdx, dIdy


def _box_flow_pair(prev, cur, box_size: int, include_remodelling: bool):
    dIdx, dIdy = _pair_gradients(prev, cur)
    delta_I = cur - prev

    sum1 = box_sum(delta_I * dIdx, box_size)
    sum2 = box_sum(delta_I * dIdy, box_size)
    A = box_sum(dIdx * dIdx, box_size)
    B = box_sum(dIdx * dIdy, box_size)

    if not include_remodelling:
        C = box_sum(dIdy * dIdy, box_size)
        det = A * C - B * B
        v_x = (-C * sum1 + B * sum2) / det
        v_y = (-A * sum2 + B * sum1) / det
        gamma = jnp.zeros_like(v_x)
    else:
        # Coefficient names follow the reference's 3x3 closed form (:131-151).
        C = box_sum(dIdx, box_size)
        D = box_sum(dIdy * dIdy, box_size)
        E = box_sum(dIdy, box_size)
        sum3 = box_sum(delta_I, box_size)
        # The reference uses the *nominal* box pixel count here even at
        # clipped boundary windows (ref :139-140) — reproduced.
        n = float(box_size * box_size)
        det = n * A * D - A * E * E - n * B * B - C * C * D + 2.0 * B * C * E
        safe = det != 0.0
        det_safe = jnp.where(safe, det, 1.0)
        v_x = ((E * E - n * D) * sum1 + (n * B - C * E) * sum2 + (C * D - B * E) * sum3) / det_safe
        v_y = ((n * B - C * E) * sum1 + (C * C - n * A) * sum2 + (A * E - B * C) * sum3) / det_safe
        gamma = -((B * E - C * D) * sum1 + (B * C - A * E) * sum2 + (A * D - B * B) * sum3) / det_safe
        nan = jnp.asarray(jnp.nan, dtype=v_x.dtype)
        v_x = jnp.where(safe, v_x, nan)
        v_y = jnp.where(safe, v_y, nan)
        gamma = jnp.where(safe, gamma, nan)

    speed = jnp.sqrt(v_x * v_x + v_y * v_y)
    return v_x, v_y, speed, gamma


@functools.partial(jax.jit, static_argnames=("box_size", "include_remodelling"))
def box_flow(movie: jnp.ndarray, box_size: int, delta_x: float, delta_t: float,
             include_remodelling: bool = False):
    """Run box-method flow on every consecutive frame pair of a (T, X, Y)
    movie.  Returns (v_x, v_y, speed, remodelling), each (T-1, X, Y), in
    physical units (delta_x / delta_t applied, ref :153-155)."""
    prev = movie[:-1]
    cur = movie[1:]
    v_x, v_y, speed, gamma = jax.vmap(
        lambda p, c: _box_flow_pair(p, c, box_size, include_remodelling)
    )(prev, cur)
    scale = delta_x / delta_t
    return v_x * scale, v_y * scale, speed * scale, gamma


def conduct_optical_flow(
    movie,
    boxsize: int = 15,
    delta_x: float = 1.0,
    delta_t: float = 1.0,
    smoothing_sigma: Optional[float] = None,
    background: Optional[float] = None,
    include_remodelling: bool = False,
    dtype=jnp.float32,
) -> FlowResult:
    """Drop-in equivalent of the reference's ``conduct_optical_flow``
    (ref :159-218): optional background subtraction (sigma-10 blur mask),
    optional Gaussian smoothing, then the box-method kernel."""
    movie = jnp.asarray(movie, dtype=dtype)

    if background is not None:
        # ref :195-198: threshold on a sigma=10 blur, subtract background level.
        mask_movie = blur_movie(movie, smoothing_sigma=10)
        movie_to_analyse = jnp.where(mask_movie > background, movie - background, 0.0)
    else:
        movie_to_analyse = movie

    if smoothing_sigma is not None:
        movie_to_analyse = blur_movie(movie_to_analyse, smoothing_sigma=smoothing_sigma)

    v_x, v_y, speed, gamma = box_flow(
        movie_to_analyse, int(boxsize), float(delta_x), float(delta_t), include_remodelling
    )

    result = FlowResult(
        v_x=np.asarray(v_x),
        v_y=np.asarray(v_y),
        speed=np.asarray(speed),
        original_data=np.asarray(movie),
        blurred_data=np.asarray(movie_to_analyse),
        delta_x=delta_x,
        delta_t=delta_t,
    )
    if include_remodelling:
        result["net_remodelling"] = np.asarray(gamma)
    return result
