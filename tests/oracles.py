"""Pure-numpy oracle implementations used to validate the JAX engine.

These follow the *semantics* of the reference numba kernels
(/root/reference/source/optical_flow.py) as documented in SURVEY.md, written
independently as straightforward loops so that agreement between the fused
device path and these oracles is meaningful evidence of correctness.
"""

from __future__ import annotations

import numpy as np


def box_flow_oracle(movie, box_size, delta_x=1.0, delta_t=1.0, include_remodelling=False):
    """Loop-based box-method flow (semantics of ref optical_flow.py:24-157,
    with the y-window clamped by the correct axis length)."""
    movie = np.asarray(movie, dtype=np.float64)
    T, X, Y = movie.shape
    v_x = np.zeros((T - 1, X, Y))
    v_y = np.zeros((T - 1, X, Y))
    speed = np.zeros((T - 1, X, Y))
    gamma = np.zeros((T - 1, X, Y))
    half = box_size // 2
    n = float(box_size * box_size)

    for t in range(1, T):
        cur, prev = movie[t], movie[t - 1]
        dIdx = np.zeros((X, Y))
        dIdy = np.zeros((X, Y))
        dIdx[1:-1, 1:-1] = (cur[2:, 1:-1] + prev[2:, 1:-1] - cur[:-2, 1:-1] - prev[:-2, 1:-1]) / 4
        dIdy[1:-1, 1:-1] = (cur[1:-1, 2:] + prev[1:-1, 2:] - cur[1:-1, :-2] - prev[1:-1, :-2]) / 4
        dI = cur - prev
        for i in range(X):
            for j in range(Y):
                x0, x1 = max(i - half, 0), min(i + half + 1, X)
                y0, y1 = max(j - half, 0), min(j + half + 1, Y)
                ldx = dIdx[x0:x1, y0:y1]
                ldy = dIdy[x0:x1, y0:y1]
                ldI = dI[x0:x1, y0:y1]
                s1 = np.sum(ldI * ldx)
                s2 = np.sum(ldI * ldy)
                A = np.sum(ldx**2)
                B = np.sum(ldx * ldy)
                if not include_remodelling:
                    C = np.sum(ldy**2)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        det = A * C - B**2
                        v_x[t - 1, i, j] = (-C * s1 + B * s2) / det
                        v_y[t - 1, i, j] = (-A * s2 + B * s1) / det
                    speed[t - 1, i, j] = np.sqrt(v_x[t - 1, i, j] ** 2 + v_y[t - 1, i, j] ** 2)
                else:
                    C = np.sum(ldx)
                    D = np.sum(ldy**2)
                    E = np.sum(ldy)
                    s3 = np.sum(ldI)
                    det = n * A * D - A * E**2 - n * B**2 - C**2 * D + 2 * B * C * E
                    if det == 0.0:
                        v_x[t - 1, i, j] = np.nan
                        v_y[t - 1, i, j] = np.nan
                        gamma[t - 1, i, j] = np.nan
                    else:
                        v_x[t - 1, i, j] = (
                            (E**2 - n * D) * s1 + (n * B - C * E) * s2 + (C * D - B * E) * s3
                        ) / det
                        v_y[t - 1, i, j] = (
                            (n * B - C * E) * s1 + (C**2 - n * A) * s2 + (A * E - B * C) * s3
                        ) / det
                        gamma[t - 1, i, j] = -(
                            (B * E - C * D) * s1 + (B * C - A * E) * s2 + (A * D - B**2) * s3
                        ) / det
                    speed[t - 1, i, j] = np.sqrt(v_x[t - 1, i, j] ** 2 + v_y[t - 1, i, j] ** 2)

    scale = delta_x / delta_t
    return v_x * scale, v_y * scale, speed * scale, gamma


def derivative_oracle(m, rule, compat_dy=False):
    """Interior finite differences (semantics of ref optical_flow.py:676-713)."""
    m = np.asarray(m, dtype=np.float64)
    if rule == "dx" or (rule == "dy" and compat_dy):
        return (m[2:, 1:-1] - m[:-2, 1:-1]) / 2
    if rule == "dy":
        return (m[1:-1, 2:] - m[1:-1, :-2]) / 2
    if rule in ("dxy", "dyx"):
        return (m[2:, 2:] - m[2:, :-2] - m[:-2, 2:] + m[:-2, :-2]) / 4
    if rule == "dxx":
        return m[2:, 1:-1] + m[:-2, 1:-1] - 2 * m[1:-1, 1:-1]
    if rule == "dyy":
        return m[1:-1, 2:] + m[1:-1, :-2] - 2 * m[1:-1, 1:-1]
    if rule == "bar_x":
        return m[2:, 1:-1] + m[:-2, 1:-1]
    if rule == "bar_y":
        return m[1:-1, 2:] + m[1:-1, :-2]
    if rule == "bar":
        return m[:-2, 1:-1] + m[2:, 1:-1] + m[1:-1, 2:] + m[1:-1, :-2]
    raise ValueError(rule)


def mirror_edges_oracle(image):
    image = np.array(image, copy=True)
    image[0, :] = image[2, :]
    image[-1, :] = image[-3, :]
    image[:, 0] = image[:, 2]
    image[:, -1] = image[:, -3]
    return image


def reference_el_system(prev_full, cur_full, speed_alpha, remodelling_alpha, compat_dy=True):
    """Assemble the variational EL system exactly as the reference does
    (write-for-write semantics of ref optical_flow.py:829-1072: lil-matrix
    SET assignments for interior rows, then overlapping boundary writers),
    as an independent oracle for both the matrix-free operator and the
    engine's own vectorized assembly.  Returns (A_csr, b_flat)."""
    import scipy.sparse

    prev_full = np.asarray(prev_full, dtype=np.float64)
    cur_full = np.asarray(cur_full, dtype=np.float64)
    Ni, Nj = prev_full.shape
    I = prev_full[1:-1, 1:-1]
    a_s, a_r = float(speed_alpha), float(remodelling_alpha)

    dIdx = derivative_oracle(prev_full, "dx")
    dIdy = derivative_oracle(prev_full, "dy", compat_dy=compat_dy)
    dIdxx = derivative_oracle(prev_full, "dxx")
    dIdyy = derivative_oracle(prev_full, "dyy")
    dIdxy = derivative_oracle(prev_full, "dxy")
    dIdx_t = derivative_oracle(cur_full, "dx") - derivative_oracle(prev_full, "dx")
    dIdy_t = derivative_oracle(cur_full, "dy") - derivative_oracle(prev_full, "dy")
    dIdt = (cur_full - prev_full)[1:-1, 1:-1]

    n = 3 * Ni * Nj
    A = scipy.sparse.lil_matrix((n, n))
    b = np.zeros(n)

    def iset(di, dj, q, boundaries=False):
        if boundaries:
            ii, jj = np.meshgrid(np.arange(Ni), np.arange(Nj), indexing="ij")
        else:
            ii, jj = np.meshgrid(np.arange(1, Ni - 1), np.arange(1, Nj - 1), indexing="ij")
        return (3 * Nj * (ii + di) + 3 * (jj + dj) + q).ravel()

    UX, UY, G = 0, 1, 2
    ux0, uy0, g0 = iset(0, 0, UX), iset(0, 0, UY), iset(0, 0, G)

    A[ux0, ux0] = (I * (dIdxx - 2 * I) - 4 * a_s).ravel()
    A[ux0, uy0] = (I * dIdxy).ravel()
    A[ux0, iset(-1, 0, UX)] = (I * (-dIdx + I) + a_s).ravel()
    A[ux0, iset(+1, 0, UX)] = (I * (dIdx + I) + a_s).ravel()
    A[ux0, iset(0, -1, UX)] = a_s
    A[ux0, iset(0, +1, UX)] = a_s
    A[ux0, iset(0, -1, UY)] = (-I * dIdx / 2).ravel()
    A[ux0, iset(0, +1, UY)] = (I * dIdx / 2).ravel()
    A[ux0, iset(-1, 0, UY)] = (-I * dIdy / 2).ravel()
    A[ux0, iset(+1, 0, UY)] = (I * dIdy / 2).ravel()
    A[ux0, iset(-1, -1, UY)] = (I * I / 4).ravel()
    A[ux0, iset(+1, +1, UY)] = (I * I / 4).ravel()
    A[ux0, iset(-1, +1, UY)] = (-I * I / 4).ravel()
    A[ux0, iset(+1, -1, UY)] = (-I * I / 4).ravel()
    A[ux0, iset(-1, 0, G)] = (I / 2).ravel()
    A[ux0, iset(+1, 0, G)] = (-I / 2).ravel()
    b[ux0] = (-I * dIdx_t).ravel()

    A[uy0, uy0] = (I * (dIdyy - 2 * I) - 4 * a_s).ravel()
    A[uy0, ux0] = (I * dIdxy).ravel()
    A[uy0, iset(0, -1, UY)] = (I * (-dIdy + I) + a_s).ravel()
    A[uy0, iset(0, +1, UY)] = (I * (dIdy + I) + a_s).ravel()
    A[uy0, iset(-1, 0, UY)] = a_s
    A[uy0, iset(+1, 0, UY)] = a_s
    A[uy0, iset(-1, 0, UX)] = (-I * dIdy / 2).ravel()
    A[uy0, iset(+1, 0, UX)] = (I * dIdy / 2).ravel()
    A[uy0, iset(0, -1, UX)] = (-I * dIdx / 2).ravel()
    A[uy0, iset(0, +1, UX)] = (I * dIdx / 2).ravel()
    A[uy0, iset(-1, -1, UX)] = (I * I / 4).ravel()
    A[uy0, iset(+1, +1, UX)] = (I * I / 4).ravel()
    A[uy0, iset(-1, +1, UX)] = (-I * I / 4).ravel()
    A[uy0, iset(+1, -1, UX)] = (-I * I / 4).ravel()
    A[uy0, iset(0, -1, G)] = (I / 2).ravel()
    A[uy0, iset(0, +1, G)] = (-I / 2).ravel()
    b[uy0] = (-I * dIdy_t).ravel()

    A[g0, g0] = -1 - 4 * a_r
    A[g0, ux0] = dIdx.ravel()
    A[g0, uy0] = dIdy.ravel()
    A[g0, iset(-1, 0, G)] = a_r
    A[g0, iset(+1, 0, G)] = a_r
    A[g0, iset(0, -1, G)] = a_r
    A[g0, iset(0, +1, G)] = a_r
    A[g0, iset(-1, 0, UX)] = (-I / 2).ravel()
    A[g0, iset(+1, 0, UX)] = (I / 2).ravel()
    A[g0, iset(0, -1, UY)] = (-I / 2).ravel()
    A[g0, iset(0, +1, UY)] = (I / 2).ravel()
    b[g0] = -dIdt.ravel()

    # boundary writers, in the reference's order: top, bottom, left, right
    for q in range(3):
        top = np.arange(Nj) * 3 + q
        A[top, top] = 1
        A[top, top + 6 * Nj] = -1
        bot = 3 * Nj * (Ni - 1) + np.arange(Nj) * 3 + q
        A[bot, bot] = 1
        A[bot, bot - 6 * Nj] = -1
        left = np.arange(Ni) * 3 * Nj + q
        A[left, left] = 1
        A[left, left + 6] = -1
        right = np.arange(Ni) * 3 * Nj + 3 * (Nj - 1) + q
        A[right, right] = 1
        A[right, right - 6] = -1

    return A.tocsr(), b
