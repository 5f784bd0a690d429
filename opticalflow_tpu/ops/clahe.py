"""On-device CLAHE (contrast-limited adaptive histogram equalisation).

On-device equivalent of the reference's ``apply_clahe``
(/root/reference/source/optical_flow.py:340-374), which runs cv2's CLAHE on
uint16 frames with a tile grid scaled by the image aspect ratio.

Implementation: per-tile histograms (scatter-add), clip-limit
redistribution, per-tile CDF lookup tables, and bilinear interpolation of
the four surrounding tile mappings per pixel — the standard CLAHE
pipeline, fully vectorized.  cv2 parity is statistical, not bitwise (cv2's
uint16 path uses its own binning and residual-redistribution order);
tests check strong rank correlation against cv2 when available.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("tiles_x", "tiles_y", "n_bins", "max_value"))
def _clahe_frame(frame, clip_limit, tiles_x, tiles_y, n_bins, max_value):
    ni, nj = frame.shape
    # pad to a multiple of the tile grid (reflect-101, like cv2)
    th = -(-ni // tiles_x)
    tw = -(-nj // tiles_y)
    pad_i = th * tiles_x - ni
    pad_j = tw * tiles_y - nj
    fp = jnp.pad(frame, ((0, pad_i), (0, pad_j)), mode="reflect")

    # bin index per pixel
    scale = (n_bins - 1) / max_value
    bins = jnp.clip((fp * scale).astype(jnp.int32), 0, n_bins - 1)

    # per-tile histograms via one scatter-add on (tile_id, bin)
    ti = jnp.arange(th * tiles_x) // th
    tj = jnp.arange(tw * tiles_y) // tw
    tile_id = ti[:, None] * tiles_y + tj[None, :]
    flat_idx = tile_id.ravel() * n_bins + bins.ravel()
    hist = jnp.zeros((tiles_x * tiles_y * n_bins,), jnp.float32)
    hist = hist.at[flat_idx].add(1.0).reshape(tiles_x * tiles_y, n_bins)

    # clip + redistribute (cv2: clip value = clipLimit * tileArea / histSize,
    # floored at 1)
    tile_area = th * tw
    clip = jnp.maximum(clip_limit * tile_area / n_bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / n_bins

    # LUT per tile: scaled CDF
    cdf = jnp.cumsum(hist, axis=1)
    luts = (cdf - cdf[:, :1]) / jnp.maximum(tile_area - cdf[:, :1], 1.0) * max_value
    luts = jnp.clip(luts, 0.0, max_value)  # (n_tiles, n_bins)

    # bilinear interpolation between the 4 surrounding tile LUTs
    ci = (jnp.arange(th * tiles_x) + 0.5) / th - 0.5  # tile-space coordinate
    cj = (jnp.arange(tw * tiles_y) + 0.5) / tw - 0.5
    i0 = jnp.clip(jnp.floor(ci).astype(jnp.int32), 0, tiles_x - 1)
    i1 = jnp.clip(i0 + 1, 0, tiles_x - 1)
    wi = jnp.clip(ci - jnp.floor(ci), 0.0, 1.0)
    wi = jnp.where(ci < 0, 0.0, jnp.where(ci > tiles_x - 1, 1.0, wi))
    j0 = jnp.clip(jnp.floor(cj).astype(jnp.int32), 0, tiles_y - 1)
    j1 = jnp.clip(j0 + 1, 0, tiles_y - 1)
    wj = jnp.clip(cj - jnp.floor(cj), 0.0, 1.0)
    wj = jnp.where(cj < 0, 0.0, jnp.where(cj > tiles_y - 1, 1.0, wj))

    def lookup(ti_idx, tj_idx):
        ids = ti_idx[:, None] * tiles_y + tj_idx[None, :]
        return luts[ids, bins]

    v00 = lookup(i0, j0)
    v01 = lookup(i0, j1)
    v10 = lookup(i1, j0)
    v11 = lookup(i1, j1)
    wi2 = wi[:, None]
    wj2 = wj[None, :]
    out = (
        (1 - wi2) * ((1 - wj2) * v00 + wj2 * v01)
        + wi2 * ((1 - wj2) * v10 + wj2 * v11)
    )
    return out[:ni, :nj]


def apply_clahe(movie, clipLimit: float = 50000, tile_number: int = 10,
                n_bins: int = 4096):
    """CLAHE on every frame (ref :340-374): frames are treated as uint16
    data; the tile grid in the second image axis is scaled by the aspect
    ratio so tiles stay approximately square."""
    movie = jnp.asarray(movie)
    converted = movie.astype(jnp.uint16).astype(jnp.float32)
    aspect = movie.shape[2] / movie.shape[1]
    tiles_x = int(tile_number)
    tiles_y = int(round(tile_number * aspect))
    max_value = 65535.0
    out = jax.vmap(
        lambda f: _clahe_frame(f, jnp.float32(clipLimit), tiles_x, tiles_y,
                               int(n_bins), max_value)
    )(converted)
    return out.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
