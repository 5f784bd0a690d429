"""Finite-difference stencil operators with the reference's conventions.

These are the on-device (pure jnp, fully vectorized, jit/vmap-friendly)
equivalents of the reference's numba helpers
``apply_numerical_derivative`` (/root/reference/source/optical_flow.py:676-713)
and ``apply_constant_boundary_condition`` (:1304-1316).

Conventions (shared across the whole package):

* An image/frame is indexed ``[i, j]`` with ``i`` along "x" (first axis) and
  ``j`` along "y" (second axis), matching the reference.
* Interior derivatives consume a full ``(Ni, Nj)`` frame whose outermost
  one-pixel ring is treated as dummy/halo, and return the ``(Ni-2, Nj-2)``
  interior, exactly like the reference helper.
* The reference's ``'dy'`` rule is a known defect: it duplicates ``'dx'``
  (:696-699), so the flagship path's dI/dy is actually a second copy of
  dI/dx (:813).  We expose both behaviours: ``DY_COMPAT`` replicates the
  reference bit-for-bit (needed for parity tests against the PETSc
  solution), ``DY_FIXED`` is the mathematically correct derivative.
"""

from __future__ import annotations

import jax.numpy as jnp

# dy-rule modes
DY_FIXED = "fixed"
DY_COMPAT = "compat"


def ddx(m: jnp.ndarray) -> jnp.ndarray:
    """Central difference along axis 0, interior points."""
    return (m[2:, 1:-1] - m[:-2, 1:-1]) * 0.5


def ddy(m: jnp.ndarray, mode: str = DY_FIXED) -> jnp.ndarray:
    """Central difference along axis 1, interior points.

    ``mode=DY_COMPAT`` reproduces the reference defect where the 'dy' rule
    differentiates along axis 0 (ref optical_flow.py:698-699).
    """
    if mode == DY_COMPAT:
        return ddx(m)
    return (m[1:-1, 2:] - m[1:-1, :-2]) * 0.5


def ddxx(m: jnp.ndarray) -> jnp.ndarray:
    """Second difference along axis 0 (unit spacing), interior points."""
    return m[2:, 1:-1] + m[:-2, 1:-1] - 2.0 * m[1:-1, 1:-1]


def ddyy(m: jnp.ndarray) -> jnp.ndarray:
    """Second difference along axis 1 (unit spacing), interior points."""
    return m[1:-1, 2:] + m[1:-1, :-2] - 2.0 * m[1:-1, 1:-1]


def ddxy(m: jnp.ndarray) -> jnp.ndarray:
    """Mixed second difference, interior points."""
    return (m[2:, 2:] - m[2:, :-2] - m[:-2, 2:] + m[:-2, :-2]) * 0.25


def bar_x(m: jnp.ndarray) -> jnp.ndarray:
    """Sum of axis-0 neighbours, interior points."""
    return m[2:, 1:-1] + m[:-2, 1:-1]


def bar_y(m: jnp.ndarray) -> jnp.ndarray:
    """Sum of axis-1 neighbours, interior points."""
    return m[1:-1, 2:] + m[1:-1, :-2]


def bar4(m: jnp.ndarray) -> jnp.ndarray:
    """Sum of the 4-neighbourhood, interior points."""
    return m[2:, 1:-1] + m[:-2, 1:-1] + m[1:-1, 2:] + m[1:-1, :-2]


_RULES = {
    "dx": lambda m, mode: ddx(m),
    "dy": lambda m, mode: ddy(m, mode),
    "dxx": lambda m, mode: ddxx(m),
    "dyy": lambda m, mode: ddyy(m),
    "dxy": lambda m, mode: ddxy(m),
    "dyx": lambda m, mode: ddxy(m),
    "bar_x": lambda m, mode: bar_x(m),
    "bar_y": lambda m, mode: bar_y(m),
    "bar": lambda m, mode: bar4(m),
}


def interior_derivative(m: jnp.ndarray, rule: str, dy_mode: str = DY_FIXED) -> jnp.ndarray:
    """Dispatch on a rule name, mirroring the reference helper's interface."""
    try:
        fn = _RULES[rule]
    except KeyError:
        raise ValueError(f"unknown derivative rule {rule!r}") from None
    return fn(m, dy_mode)


def mirror_edges(image: jnp.ndarray) -> jnp.ndarray:
    """Mirror (zero-gradient) boundary fill, matching the reference's
    ``apply_constant_boundary_condition`` including its corner semantics:
    rows are filled first, then columns overwrite (so corners take the
    column rule applied to the already row-filled array).

    Functional (returns a new array) rather than in-place.
    """
    image = jnp.asarray(image)
    image = image.at[0, :].set(image[2, :])
    image = image.at[-1, :].set(image[-3, :])
    image = image.at[:, 0].set(image[:, 2])
    image = image.at[:, -1].set(image[:, -3])
    return image


def mirror_edges_movie(movie: jnp.ndarray) -> jnp.ndarray:
    """Apply :func:`mirror_edges` to every frame of a (T, X, Y) stack."""
    movie = jnp.asarray(movie)
    movie = movie.at[:, 0, :].set(movie[:, 2, :])
    movie = movie.at[:, -1, :].set(movie[:, -3, :])
    movie = movie.at[:, :, 0].set(movie[:, :, 2])
    movie = movie.at[:, :, -1].set(movie[:, :, -3])
    return movie
