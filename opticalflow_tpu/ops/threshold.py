"""On-device adaptive thresholding.

On-device equivalent of the reference's ``apply_adaptive_threshold``
(/root/reference/source/optical_flow.py:308-338): rescale the movie to
uint8 range, then binarise each pixel against the mean of its
``window_size`` neighbourhood minus ``threshold`` (cv2
ADAPTIVE_THRESH_MEAN_C / THRESH_BINARY semantics, replicate borders).
Returns a boolean movie like the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _local_mean_replicate(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Windowed mean with replicate (cv2 BORDER_REPLICATE) padding over the
    last two axes."""
    pad = window // 2
    nd = x.ndim
    pad_widths = [(0, 0)] * (nd - 2) + [(pad, pad), (pad, pad)]
    xp = jnp.pad(x, pad_widths, mode="edge")
    win = [1] * nd
    win[-2] = window
    out = lax.reduce_window(xp, 0.0, lax.add, tuple(win), (1,) * nd, "VALID")
    win = [1] * nd
    win[-1] = window
    out = lax.reduce_window(out, 0.0, lax.add, tuple(win), (1,) * nd, "VALID")
    return out / float(window * window)


@functools.partial(jax.jit, static_argnames=("window_size",))
def _adaptive_threshold_impl(movie, window_size, threshold):
    # uint8 conversion exactly like the reference (:330): scale by the
    # global max then truncate toward zero.
    scaled = movie / jnp.max(movie) * 255.0
    as_uint8 = scaled.astype(jnp.uint8).astype(movie.dtype)
    # cv2 computes the mean on the uint8 image and rounds it to uint8;
    # the comparison is src > mean - C
    local_mean = _local_mean_replicate(as_uint8, window_size)
    thresh = jnp.round(local_mean) - threshold
    return as_uint8 > thresh


def apply_adaptive_threshold(movie, window_size: int = 51, threshold: float = 0.0):
    """Boolean mask movie via mean-C adaptive threshold (ref :308-338)."""
    movie = jnp.asarray(movie)
    if not jnp.issubdtype(movie.dtype, jnp.floating):
        movie = movie.astype(jnp.float32)
    return _adaptive_threshold_impl(movie, int(window_size), float(threshold))
