"""On-device Gaussian blur.

On-device equivalent of the reference's per-frame
``skimage.filters.gaussian(frame, sigma, preserve_range=True)`` loop
(/root/reference/source/optical_flow.py:282-306).  skimage delegates to
``scipy.ndimage.gaussian_filter`` with ``mode='nearest'`` (edge replicate)
and ``truncate=4.0``; we reproduce that kernel and padding exactly so that
blurred movies agree with the reference to floating-point roundoff, but as
a single fused separable convolution over the whole (T, X, Y) stack.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0, dtype=np.float64) -> np.ndarray:
    """The exact sampled-Gaussian kernel scipy.ndimage uses."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / float(sigma)) ** 2)
    phi /= phi.sum()
    return phi.astype(dtype)


def _correlate_axis(movie: jnp.ndarray, kernel: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Separable 1-D correlation along a spatial axis of a (T, X, Y) stack,
    with edge-replicate padding (scipy mode='nearest')."""
    radius = kernel.shape[0] // 2
    pad_widths = [(0, 0)] * movie.ndim
    pad_widths[axis] = (radius, radius)
    padded = jnp.pad(movie, pad_widths, mode="edge")

    # Treat T as the batch dim and run a depthwise 1-D conv via conv_general_dilated.
    t, x, y = padded.shape
    lhs = padded[:, None, :, :]  # NCHW with C=1
    if axis == 1:
        rhs = kernel[::-1].reshape(1, 1, -1, 1)
    elif axis == 2:
        rhs = kernel[::-1].reshape(1, 1, 1, -1)
    else:
        raise ValueError("axis must be 1 or 2 (spatial axes of a (T, X, Y) stack)")
    out = lax.conv_general_dilated(
        lhs,
        rhs.astype(movie.dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # f32 convolutions may otherwise run in TF32 on the GPU (about
        # three decimal digits), far from scipy's f64 result
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0, :, :]


@functools.partial(jax.jit, static_argnames=("smoothing_sigma", "truncate"))
def _blur_movie_impl(movie: jnp.ndarray, smoothing_sigma: float, truncate: float) -> jnp.ndarray:
    kernel = jnp.asarray(gaussian_kernel_1d(smoothing_sigma, truncate), dtype=movie.dtype)
    out = _correlate_axis(movie, kernel, axis=1)
    out = _correlate_axis(out, kernel, axis=2)
    return out


def blur_movie(movie, smoothing_sigma: float, truncate: float = 4.0) -> jnp.ndarray:
    """Gaussian-blur every frame of a (T, X, Y) movie on device.

    Matches ``skimage.filters.gaussian(..., preserve_range=True)`` /
    ``scipy.ndimage.gaussian_filter(mode='nearest', truncate=4.0)``.
    """
    movie = jnp.asarray(movie)
    if not jnp.issubdtype(movie.dtype, jnp.floating):
        movie = movie.astype(jnp.float32)
    return _blur_movie_impl(movie, float(smoothing_sigma), float(truncate))


def blur_frame(frame, smoothing_sigma: float, truncate: float = 4.0) -> jnp.ndarray:
    """Single-frame convenience wrapper."""
    return blur_movie(frame[None, :, :], smoothing_sigma, truncate)[0]
