"""Synthetic ("fake") test-data generation.

Vectorized on-device equivalent of the reference's numba generator
``make_fake_data_frame`` (/root/reference/source/optical_flow.py:376-423):
a Gaussian hat exp(-((x-x0)^2 + (y-y0)^2)/sigma^2) sampled on a square
grid, optionally with tiny uniform noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def make_fake_data_frame(
    x_position: float,
    y_position: float,
    sigma: float = 1.0,
    width: float = 20.0,
    include_noise: bool = False,
    dimension: int = 1000,
    key: Optional[jax.Array] = None,
    dtype=jnp.float64,
) -> Tuple[jnp.ndarray, float]:
    """Draw a Gaussian hat centred at (x_position, y_position).

    Returns ``(frame, delta_x)`` where ``delta_x`` is the pixel size in the
    same units as the positions, exactly like the reference helper.
    """
    coords = jnp.linspace(0.0, width, dimension, dtype=dtype)
    dx2 = (coords[:, None] - x_position) ** 2
    dy2 = (coords[None, :] - y_position) ** 2
    frame = jnp.exp(-(dx2 + dy2) / sigma**2)
    delta_x = float(width / (dimension - 1))
    if include_noise:
        if key is None:
            key = jax.random.PRNGKey(0)
        frame = jnp.abs(frame + jax.random.uniform(key, frame.shape, dtype=dtype) * 1e-7)
    return frame, delta_x


def _texture(x, y, mean_intensity, contrast):
    """Analytic smooth positive texture: multi-frequency sinusoid mixture.

    Being a closed-form function of (x, y), it can be sampled at warped
    coordinates, so translations/advections built from it are exact (up to
    the warp model), with no interpolation error.
    """
    tau = 2.0 * jnp.pi
    p = (
        0.45 * jnp.sin(tau * x / 73.0) * jnp.cos(tau * y / 91.0)
        + 0.30 * jnp.cos(tau * (x + 0.7 * y) / 41.0)
        + 0.15 * jnp.sin(tau * (0.4 * x - y) / 157.0)
        + 0.10 * jnp.cos(tau * x / 23.0) * jnp.cos(tau * y / 19.0)
    )
    return mean_intensity * (1.0 + contrast * 0.5 * p)


def random_fourier_texture(
    x,
    y,
    n_modes: int = 96,
    min_period: float = 8.0,
    max_period: float = 24.0,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    seed: int = 0,
):
    """Isotropic broadband analytic texture: a sum of random plane waves.

    ``sum_k a_k cos(k . x + phi_k)`` with wavenumber magnitudes uniform in
    ``[2*pi/max_period, 2*pi/min_period]`` and uniformly random directions
    and phases; amplitudes are normalised so the pattern has unit variance
    before the contrast scaling.  Closed-form in (x, y), so it can be
    sampled at warped coordinates for exact synthetic advection.

    Unlike the fixed sinusoid mixture of ``_texture`` this carrier is
    locally two-dimensional everywhere (no dominant orientation, no
    near-DC component), which the quantitative physics tests need: a
    narrowband carrier leaves the aperture problem's perpendicular
    component unconstrained (shrinking recovered magnitudes), and a
    near-DC component lets a smooth remodelling field absorb uniform
    velocity errors.
    """
    rng = np.random.default_rng(seed)
    kmag = rng.uniform(2.0 * np.pi / max_period, 2.0 * np.pi / min_period, n_modes)
    theta = rng.uniform(0.0, 2.0 * np.pi, n_modes)
    phase = rng.uniform(0.0, 2.0 * np.pi, n_modes)
    amp = rng.uniform(0.5, 1.0, n_modes)
    amp = amp / np.sqrt((amp**2).sum() / 2.0)
    kx = kmag * np.cos(theta)
    ky = kmag * np.sin(theta)
    p = jnp.zeros_like(x + y)
    # accumulate mode-by-mode: keeps peak memory at one (Ni, Nj) plane
    # instead of an (n_modes, Ni, Nj) broadcast (matters at 1024^2+)
    for i in range(n_modes):
        p = p + amp[i] * jnp.cos(kx[i] * x + ky[i] * y + phase[i])
    return mean_intensity * (1.0 + contrast * 0.5 * p)


def make_translating_texture_movie(
    n_frames: int = 2,
    dimension: int = 1024,
    v_x: float = 0.15,
    v_y: float = 0.1,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    dtype=jnp.float64,
) -> Tuple[np.ndarray, float]:
    """A full-field smooth positive texture translating at a known uniform
    velocity (in pixels per frame interval; delta_x = delta_t = 1).

    This is the workload-scale analogue of the reference's 1024^2 embryo
    movies (ref analysis/analyse_variational_optical_flow.py:201-272):
    unlike the tiny-blob synthetic, the intensity covers the whole frame,
    so the EL system's data term constrains the velocity everywhere —
    the conditioning regime of the real microscopy data.
    """
    ii = jnp.arange(dimension, dtype=dtype)[:, None]
    jj = jnp.arange(dimension, dtype=dtype)[None, :]
    frames = [
        _texture(ii - v_x * t, jj - v_y * t, mean_intensity, contrast)
        for t in range(n_frames)
    ]
    return np.asarray(jnp.stack(frames, axis=0)), 1.0


def make_remodelling_ramp_movie(
    n_frames: int = 2,
    dimension: int = 50,
    width: float = 5.0,
    sigma: float = 3.0,
    v_x: float = 0.05,
    v_y: float = 0.1,
    remodelling_max: float = 0.05,
    background: str = "blob",
    mean_intensity: float = 100.0,
    dtype=jnp.float64,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Synthetic movie with a known NON-uniform remodelling rate.

    Ground-truth generator for the reference's only analytic validation of
    the third field gamma (intent of ``identify_non_uniform_remodelling_rate``,
    ref analysis/analyse_variational_optical_flow.py:450-524 — the
    ``make_fake_data`` helper it calls no longer exists in the reference
    tree, so this is rebuilt from the physics): material advected at
    uniform (v_x, v_y) while being created at rate
    ``gamma(x, y) = linspace(0, remodelling_max)`` tiled along rows — the
    exact "true remodelling" plane the reference plots (ref :511-512).

    The continuity model the solver inverts is
    ``dI/dt + v . grad I + I div v = gamma``; with uniform v (div v = 0)
    the one-step movie ``I_t = I_0(x - v t) + t * gamma`` satisfies it
    exactly to first order in ``t * v . grad(gamma)`` — for spatially
    varying gamma the created material is *not* advected along the
    characteristic, leaving that O(t * |v| * |grad gamma|) residual
    (negligible at the test parameters; gamma in intensity units per
    frame interval, delta_t = 1).

    ``background`` selects the carrier image:

    * ``'blob'`` — the reference's Gaussian hat.  NOTE: away from the blob
      the intensity is ~0, so the data term constrains neither v nor the
      v-gamma coupling there and the recovered gamma is meaningful only
      as a qualitative picture (which is all the reference's dead check
      plotted).  Positions move at (v_x, v_y) in *physical* units over a
      ``width``-sized domain; gamma is in intensity/frame units.
    * ``'texture'`` — a full-field broadband isotropic texture
      (:func:`random_fourier_texture`; delta_x = 1, v in px/frame):
      intensity constrains the system everywhere and in every direction,
      so gamma recovery can be asserted quantitatively (the pytest uses
      this).

    Returns ``(movie, delta_x, gamma_true)``; the solver's ``remodelling``
    output is in the same intensity/frame units (ref :1189-1190 applies no
    unit scaling to gamma).
    """
    row = jnp.linspace(0.0, remodelling_max, dimension, dtype=dtype)
    gamma_true = jnp.tile(row, (dimension, 1))
    frames = []
    if background == "blob":
        delta_x = None
        for t in range(n_frames):
            blob, delta_x = make_fake_data_frame(
                width / 2.0 + v_x * t,
                width / 2.0 + v_y * t,
                sigma=sigma,
                width=width,
                dimension=dimension,
                dtype=dtype,
            )
            frames.append(blob + t * gamma_true)
    elif background == "texture":
        delta_x = 1.0
        ii = jnp.arange(dimension, dtype=dtype)[:, None]
        jj = jnp.arange(dimension, dtype=dtype)[None, :]
        for t in range(n_frames):
            frames.append(
                random_fourier_texture(
                    ii - v_x * t, jj - v_y * t, mean_intensity=mean_intensity
                )
                + t * gamma_true
            )
    else:
        raise ValueError(f"unknown background {background!r}")
    movie = jnp.stack(frames, axis=0)
    return np.asarray(movie), delta_x, np.asarray(gamma_true)


def vortex_pair_velocity(
    dimension: int,
    centers=None,
    core_sigma: float = None,
    peak_speed: float = 1.0,
    dtype=jnp.float64,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic counter-rotating vortex-pair velocity field (px/frame).

    Stream function ``psi = A [exp(-r1^2/s^2) - exp(-r2^2/s^2)]`` with
    ``v = (dpsi/dy, -dpsi/dx)`` — divergence-free by construction, the
    synthetic analogue of the Liu-Shen MATLAB vortex-pair example the
    reference reproduces (ref analysis/analyse_variational_optical_flow.py:114-179;
    its .tif input data is stripped from the mirror, so the workload is
    rebuilt analytically).  ``peak_speed`` sets max |v|.
    """
    if centers is None:
        centers = (
            (dimension * 0.5, dimension * 0.35),
            (dimension * 0.5, dimension * 0.65),
        )
    if core_sigma is None:
        core_sigma = dimension / 8.0
    ii = jnp.arange(dimension, dtype=dtype)[:, None]
    jj = jnp.arange(dimension, dtype=dtype)[None, :]
    s2 = core_sigma**2
    v_x = jnp.zeros((dimension, dimension), dtype)
    v_y = jnp.zeros((dimension, dimension), dtype)
    for sign, (cx, cy) in zip((1.0, -1.0), centers):
        e = jnp.exp(-((ii - cx) ** 2 + (jj - cy) ** 2) / s2)
        v_x = v_x + sign * (-2.0 * (jj - cy) / s2) * e
        v_y = v_y - sign * (-2.0 * (ii - cx) / s2) * e
    # Normalise against the sampled *pair* field: between the cores the
    # counter-rotating partners add, so the single-vortex analytic peak
    # (A*sqrt(2/e)/s at r=s/sqrt(2)) understates max |v| and would let
    # the actual peak exceed peak_speed — eroding the O(|v|^2)
    # warp-accuracy margin callers size via peak_speed.
    vmax = jnp.sqrt(jnp.max(v_x**2 + v_y**2))
    scale = peak_speed / jnp.maximum(vmax, jnp.asarray(1e-300, dtype))
    return v_x * scale, v_y * scale


def make_vortex_pair_movie(
    n_frames: int = 2,
    dimension: int = 128,
    peak_speed: float = 0.5,
    mean_intensity: float = 100.0,
    contrast: float = 0.8,
    dtype=jnp.float64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Broadband texture advected by a vortex-pair field: the
    cross-implementation oracle workload (variational vs Liu-Shen vs
    truth; ref intent analyse_variational_optical_flow.py:114-179).

    Frames are the analytic :func:`random_fourier_texture` sampled at
    semi-Lagrangian backward-warped coordinates ``x - t v(x)`` — exact
    for one step up to O(|v|^2 |grad v|), which is why the default peak
    speed is 0.5 px/frame.  Returns ``(movie, v_x_true, v_y_true)`` with
    velocities in px/frame (delta_x = delta_t = 1).
    """
    v_x, v_y = vortex_pair_velocity(dimension, peak_speed=peak_speed, dtype=dtype)
    ii = jnp.arange(dimension, dtype=dtype)[:, None]
    jj = jnp.arange(dimension, dtype=dtype)[None, :]
    frames = [
        random_fourier_texture(
            ii - t * v_x, jj - t * v_y,
            mean_intensity=mean_intensity, contrast=contrast,
        )
        for t in range(n_frames)
    ]
    movie = jnp.stack(frames, axis=0)
    return np.asarray(movie), np.asarray(v_x), np.asarray(v_y)


def make_translating_blob_movie(
    n_frames: int = 2,
    dimension: int = 256,
    width: float = 20.0,
    sigma: float = 3.0,
    v_x: float = 0.1,
    v_y: float = 0.2,
    start: Tuple[float, float] = None,
    include_noise: bool = False,
    dtype=jnp.float64,
) -> Tuple[np.ndarray, float]:
    """A movie of a Gaussian blob translating at a known uniform velocity
    (the synthetic ground-truth workload of ref
    analysis/compare_rho_and_actin.py:302-375 ``check_error_of_method`` and
    analysis/analyse_variational_optical_flow.py:26-112).

    Velocities are in physical units per frame interval of 1.0; returns
    ``(movie, delta_x)`` with movie shape ``(n_frames, dimension, dimension)``.
    """
    if start is None:
        start = (width / 2.0, width / 2.0)
    frames = []
    delta_x = None
    for t in range(n_frames):
        frame, delta_x = make_fake_data_frame(
            start[0] + v_x * t,
            start[1] + v_y * t,
            sigma=sigma,
            width=width,
            include_noise=include_noise,
            dimension=dimension,
            key=jax.random.PRNGKey(t) if include_noise else None,
            dtype=dtype,
        )
        frames.append(frame)
    movie = jnp.stack(frames, axis=0)
    return np.asarray(movie), delta_x
