"""On-device area resize (downsampling).

Equivalent of the reference's ``cv2.resize(..., interpolation=cv2.INTER_AREA)``
downsampling of large movies (ref analysis/analyse_variational_optical_flow.py:534-539).
INTER_AREA with an integer factor is exact average pooling; the general
fractional case is pixel-area-weighted averaging, implemented here as two
separable 1-D area resamples.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _area_weights(n_in: int, n_out: int, scale=None) -> np.ndarray:
    """(n_out, n_in) row-stochastic area-overlap matrix for 1-D resize.

    ``scale`` defaults to n_in/n_out; cv2's fx/fy call path instead uses
    the reciprocal factor directly (windows of width 1/f clipped at the
    edge), which matters for fractional factors — pass it explicitly for
    that semantic."""
    if scale is None:
        scale = n_in / n_out
    w = np.zeros((n_out, n_in))
    for o in range(n_out):
        start = o * scale
        end = min((o + 1) * scale, n_in)
        i0 = int(np.floor(start))
        i1 = int(np.ceil(end))
        for i in range(i0, min(i1, n_in)):
            overlap = min(end, i + 1) - max(start, i)
            if overlap > 0:
                w[o, i] = overlap
        w[o] /= w[o].sum()
    return w


@functools.partial(jax.jit, static_argnames=("out_x", "out_y"))
def _resize_movie_impl(movie, wx, wy, out_x, out_y):
    # (T, X, Y) -> (T, out_x, Y) -> (T, out_x, out_y) via two contractions;
    # HIGHEST keeps f32 contractions out of TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("oi,tij->toj", wx, movie, precision=hi)
    out = jnp.einsum("oj,tij->tio", wy, out, precision=hi)
    return out


def area_resize_movie(movie, out_x: int, out_y: int, scale_x=None, scale_y=None):
    """Resize every frame of a (T, X, Y) movie to (out_x, out_y) with
    area-weighted averaging (cv2 INTER_AREA semantics for shrinking)."""
    movie = jnp.asarray(movie)
    if not jnp.issubdtype(movie.dtype, jnp.floating):
        movie = movie.astype(jnp.float32)
    if out_x > movie.shape[1] or out_y > movie.shape[2]:
        raise ValueError("area_resize_movie only supports downsampling")
    wx = jnp.asarray(_area_weights(movie.shape[1], out_x, scale_x), dtype=movie.dtype)
    wy = jnp.asarray(_area_weights(movie.shape[2], out_y, scale_y), dtype=movie.dtype)
    return _resize_movie_impl(movie, wx, wy, int(out_x), int(out_y))


def downsample_movie(movie, factor: float):
    """Convenience: shrink by a scale factor (e.g. 0.5), like the
    reference driver's ``cv2.resize(dsize=None, fx=f, fy=f, INTER_AREA)``."""
    movie = jnp.asarray(movie)
    out_x = int(round(movie.shape[1] * factor))
    out_y = int(round(movie.shape[2] * factor))
    return area_resize_movie(movie, out_x, out_y, scale_x=1.0 / factor, scale_y=1.0 / factor)
