"""Double-float ("df32") compensated arithmetic for residual evaluation.

Why this exists: the EL matvec is catastrophically cancellative — individual
stencil terms are O(alpha * u) ~ 0.1-1 in normalised units while the result
(and the RHS) is O(1e-4), so a plain f32 evaluation of ``b - A x`` carries
~1e3 * eps(f32) of relative noise.  That noise — not the Krylov iteration —
is the accuracy floor of the f32 solve (the true relative residual stalls
far above f64 quality no matter how many restarts).  The reference never
faces this because PETSc solves in f64 end-to-end (ref
optical_flow.py:1096-1147); here the Krylov iteration stays in f32 and
only the *residual for iterative refinement* is evaluated in
error-free-transformed f32 arithmetic (~2x the significand bits), which
restores the f64-quality residual with f32 elementwise work.

The primitives are the classical error-free transforms (Dekker 1971,
Knuth TAOCP v2) — exact under IEEE round-to-nearest, which XLA preserves
(no reassociation; FP contraction of ``a*b - p`` into an FMA only makes
the error term *exact*, so contraction is safe here):

* ``two_sum(a, b)``  -> (s, e) with a + b = s + e exactly
* ``two_prod(a, b)`` -> (p, e) with a * b = p + e exactly (split method)

A value is carried as a head/tail pair ``(hi, lo)`` with |lo| <= ulp(hi)/2.
Works for f32 and f64 inputs (split constant chosen per dtype; for f64
this yields double-double, used only by the x64 oracle paths).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Pair = Tuple[jnp.ndarray, jnp.ndarray]


def _split_constant(dtype) -> float:
    # 2^ceil(p/2) + 1 where p = significand bits (24 for f32, 53 for f64)
    if jnp.dtype(dtype) == jnp.float64:
        return float(2**27 + 1)
    return float(2**12 + 1)


def two_sum(a: jnp.ndarray, b: jnp.ndarray) -> Pair:
    """Knuth two-sum: s = fl(a+b), e = exact error, for any a, b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: jnp.ndarray, b: jnp.ndarray) -> Pair:
    """Dekker fast-two-sum; requires |a| >= |b| (used only after
    renormalising where that ordering is guaranteed)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: jnp.ndarray) -> Pair:
    """Dekker split of a into hi + lo with non-overlapping half-width
    significands (exact)."""
    c = jnp.asarray(_split_constant(a.dtype), a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a: jnp.ndarray, b: jnp.ndarray) -> Pair:
    """p = fl(a*b), e = exact error: a*b = p + e."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add_f(acc: Pair, x: jnp.ndarray) -> Pair:
    """acc + plain float x (Kahan-style growing accumulator; error of the
    tail additions is below the df precision)."""
    hi, lo = acc
    s, e = two_sum(hi, x)
    return s, lo + e


def df_add_prod(acc: Pair, a: jnp.ndarray, b: jnp.ndarray) -> Pair:
    """acc + a * b with the product's rounding error captured exactly."""
    p, e = two_prod(a, b)
    hi, lo = acc
    s, e2 = two_sum(hi, p)
    return s, lo + (e + e2)


def df_neg(acc: Pair) -> Pair:
    return -acc[0], -acc[1]


def df_result(acc: Pair) -> jnp.ndarray:
    """Round the pair to a single float (the refined residual handed to
    the f32 correction solve)."""
    return acc[0] + acc[1]


# -- full pair arithmetic (Dekker / Bailey double-float) ---------------------


def df_from(a: jnp.ndarray) -> Pair:
    return a, jnp.zeros_like(a)


def df_renorm(hi: jnp.ndarray, lo: jnp.ndarray) -> Pair:
    return fast_two_sum(hi, lo)


def df_add(x: Pair, y: Pair) -> Pair:
    """Pair + pair (Dekker add2, ~eps^2 relative error)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def df_add_pf(x: Pair, a: jnp.ndarray) -> Pair:
    """Pair + plain float."""
    s, e = two_sum(x[0], a)
    return fast_two_sum(s, e + x[1])


def df_sub(x: Pair, y: Pair) -> Pair:
    return df_add(x, df_neg(y))


def df_mul(x: Pair, y: Pair) -> Pair:
    """Pair * pair (~eps^2 relative error)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def df_mul_f(x: Pair, a: jnp.ndarray) -> Pair:
    """Pair * plain float (a's value taken exactly)."""
    p, e = two_prod(x[0], a)
    return fast_two_sum(p, e + x[1] * a)


def df_scale_pow2(x: Pair, c: float) -> Pair:
    """Pair * a power of two (exact)."""
    return x[0] * c, x[1] * c


def df_div_f(a: jnp.ndarray, s: jnp.ndarray) -> Pair:
    """Plain / plain as a pair: q + rem/s with the remainder computed via
    an exact product (the correction term is accurate to ~eps^2)."""
    q = a / s
    p, e = two_prod(q, s)
    rem = (a - p) - e
    return fast_two_sum(q, rem / s)


def df_div(x: Pair, s: jnp.ndarray) -> Pair:
    """Pair / plain float."""
    q = x[0] / s
    p, e = two_prod(q, s)
    rem = ((x[0] - p) - e) + x[1]
    return fast_two_sum(q, rem / s)
