"""Boundary-clipped box sums (uniform filters).

The reference's box-method kernel sums image products over a ``box_size``
neighbourhood clipped at the image boundary, per pixel
(/root/reference/source/optical_flow.py:102-117).  On device that per-pixel
loop becomes a separable windowed reduction: two 1-D
``lax.reduce_window`` passes with zero ("SAME") padding reproduce the
clipped sums exactly, in O(box) adds per pixel, fully fused by XLA.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def effective_window(box_size: int) -> int:
    """The reference clips the window to ``[i - b//2, i + b//2]`` inclusive
    (ref :105-108), which spans ``b`` pixels for odd ``b`` and ``b + 1``
    pixels for even ``b``.  We reproduce that."""
    half = box_size // 2
    return 2 * half + 1


def box_sum_dynamic(x: jnp.ndarray, half, max_half: int) -> jnp.ndarray:
    """Boundary-clipped box sum with a *traced* half-width.

    Same result as ``box_sum(x, 2*half+1)`` but ``half`` may be a traced
    integer bounded by the static ``max_half``, so a whole box-size sweep
    (ref analysis/compare_rho_and_actin.py:377-483 runs one full flow
    solve per box size, serially) can be one ``vmap`` over half-widths.

    Implemented as a separable correlation with a static-length 0/1
    kernel whose active taps depend on the traced ``half`` — each output
    is a short windowed sum (no prefix-sum cancellation, important for
    f32: a cumsum formulation loses ~2% accuracy in low-signal regions).

    Works on the last two axes of ``x`` (supports leading batch axes).
    """
    half = jnp.asarray(half, dtype=jnp.int32)
    offsets = jnp.arange(-max_half, max_half + 1, dtype=jnp.int32)
    taps = (jnp.abs(offsets) <= half).astype(x.dtype)

    lead = x.shape[:-2]
    lhs = x.reshape((-1, 1) + x.shape[-2:])

    def correlate(m, axis):
        rhs = taps.reshape((1, 1) + ((-1, 1) if axis == 0 else (1, -1)))
        pad = [(max_half, max_half), (0, 0)] if axis == 0 else [(0, 0), (max_half, max_half)]
        # HIGHEST: no TF32 rounding of the f32 sums on the GPU
        return lax.conv_general_dilated(
            m, rhs, (1, 1), pad, dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=lax.Precision.HIGHEST,
        )

    out = correlate(correlate(lhs, 0), 1)
    return out.reshape(lead + x.shape[-2:])


def box_sum(x: jnp.ndarray, box_size: int) -> jnp.ndarray:
    """Sum of x over the clipped box window centred at every pixel.

    Works on the last two axes of ``x`` (supports a leading batch axis).
    """
    win = effective_window(box_size)
    pad = win // 2
    nd = x.ndim
    window = [1] * nd
    padding = [(0, 0)] * nd
    window[-2] = win
    padding[-2] = (pad, pad)
    out = lax.reduce_window(x, 0.0, lax.add, tuple(window), (1,) * nd, padding)
    window = [1] * nd
    padding = [(0, 0)] * nd
    window[-1] = win
    padding[-1] = (pad, pad)
    out = lax.reduce_window(out, 0.0, lax.add, tuple(window), (1,) * nd, padding)
    return out
