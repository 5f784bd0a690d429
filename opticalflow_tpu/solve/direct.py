"""Assembled sparse EL system + direct solve (host-side, CPU).

The reference assembles a ``3*Ni*Nj`` sparse matrix with scipy.lil and
either hands it to PETSc or to ``scipy.sparse.linalg.spsolve``
(/root/reference/source/optical_flow.py:829-1072, 1147).  In this
engine the assembled form exists only here, as

* the *oracle* that the matrix-free stencil operator (ops.elop) is tested
  against, and
* the ``use_direct_solver=True`` parity path for small images.

The assembly below is an independent vectorized COO construction from the
same coefficient planes the matvec uses — not a translation of the
reference's lil-matrix writes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from opticalflow_tpu.ops.elop import ELCoefficients


def flat_index(i, j, q, n_j: int):
    """Interleaved 3-field flat index, ref ``get_index_set`` (:1241-1302)."""
    return 3 * n_j * np.asarray(i) + 3 * np.asarray(j) + q


def assemble_el_matrix(coeffs: ELCoefficients, n_i: int, n_j: int):
    """Build the full EL system matrix as scipy CSR (float64)."""
    import scipy.sparse

    c = {k: np.asarray(v, dtype=np.float64) for k, v in coeffs._asdict().items()}
    a_s = float(c["speed_alpha"])
    a_r = float(c["remodelling_alpha"])

    ii, jj = np.meshgrid(np.arange(1, n_i - 1), np.arange(1, n_j - 1), indexing="ij")
    ones = np.ones_like(ii, dtype=np.float64)

    rows, cols, vals = [], [], []

    def add(q_row, q_col, di, dj, plane):
        rows.append(flat_index(ii, jj, q_row, n_j).ravel())
        cols.append(flat_index(ii + di, jj + dj, q_col, n_j).ravel())
        vals.append(np.broadcast_to(plane, ii.shape).ravel())

    UX, UY, G = 0, 1, 2
    # u_x equation
    add(UX, UX, 0, 0, c["diag_x"])
    add(UX, UY, 0, 0, c["cross"])
    add(UX, UX, -1, 0, c["adv_xm"])
    add(UX, UX, +1, 0, c["adv_xp"])
    add(UX, UX, 0, -1, a_s * ones)
    add(UX, UX, 0, +1, a_s * ones)
    add(UX, UY, 0, -1, -c["gx"])
    add(UX, UY, 0, +1, c["gx"])
    add(UX, UY, -1, 0, -c["gy"])
    add(UX, UY, +1, 0, c["gy"])
    add(UX, UY, -1, -1, c["quart"])
    add(UX, UY, +1, +1, c["quart"])
    add(UX, UY, -1, +1, -c["quart"])
    add(UX, UY, +1, -1, -c["quart"])
    add(UX, G, -1, 0, c["half_I"])
    add(UX, G, +1, 0, -c["half_I"])
    # u_y equation
    add(UY, UY, 0, 0, c["diag_y"])
    add(UY, UX, 0, 0, c["cross"])
    add(UY, UY, 0, -1, c["adv_ym"])
    add(UY, UY, 0, +1, c["adv_yp"])
    add(UY, UY, -1, 0, a_s * ones)
    add(UY, UY, +1, 0, a_s * ones)
    add(UY, UX, -1, 0, -c["gy"])
    add(UY, UX, +1, 0, c["gy"])
    add(UY, UX, 0, -1, -c["gx"])
    add(UY, UX, 0, +1, c["gx"])
    add(UY, UX, -1, -1, c["quart"])
    add(UY, UX, +1, +1, c["quart"])
    add(UY, UX, -1, +1, -c["quart"])
    add(UY, UX, +1, -1, -c["quart"])
    add(UY, G, 0, -1, c["half_I"])
    add(UY, G, 0, +1, -c["half_I"])
    # gamma equation
    add(G, G, 0, 0, (-1.0 - 4.0 * a_r) * ones)
    add(G, UX, 0, 0, c["dIdx"])
    add(G, UY, 0, 0, c["dIdy"])
    add(G, G, -1, 0, a_r * ones)
    add(G, G, +1, 0, a_r * ones)
    add(G, G, 0, -1, a_r * ones)
    add(G, G, 0, +1, a_r * ones)
    add(G, UX, -1, 0, -c["half_I"])
    add(G, UX, +1, 0, c["half_I"])
    add(G, UY, 0, -1, -c["half_I"])
    add(G, UY, 0, +1, c["half_I"])

    # Boundary rows: every boundary pixel gets a unit diagonal for each of
    # the three fields; top/bottom rows mirror across i, left/right across
    # j; corners receive both mirror terms (ref :964-1070 row semantics).
    bmask = np.zeros((n_i, n_j), dtype=bool)
    bmask[0, :] = bmask[-1, :] = bmask[:, 0] = bmask[:, -1] = True
    bi, bj = np.nonzero(bmask)
    for q in range(3):
        rows.append(flat_index(bi, bj, q, n_j))
        cols.append(flat_index(bi, bj, q, n_j))
        vals.append(np.ones(bi.shape[0]))

    all_j = np.arange(n_j)
    all_i = np.arange(n_i)
    for q in range(3):
        # top: q(0,j) - q(2,j)
        rows.append(flat_index(np.zeros_like(all_j), all_j, q, n_j))
        cols.append(flat_index(np.full_like(all_j, 2), all_j, q, n_j))
        vals.append(-np.ones(n_j))
        # bottom: q(Ni-1,j) - q(Ni-3,j)
        rows.append(flat_index(np.full_like(all_j, n_i - 1), all_j, q, n_j))
        cols.append(flat_index(np.full_like(all_j, n_i - 3), all_j, q, n_j))
        vals.append(-np.ones(n_j))
        # left: q(i,0) - q(i,2)
        rows.append(flat_index(all_i, np.zeros_like(all_i), q, n_j))
        cols.append(flat_index(all_i, np.full_like(all_i, 2), q, n_j))
        vals.append(-np.ones(n_i))
        # right: q(i,Nj-1) - q(i,Nj-3)
        rows.append(flat_index(all_i, np.full_like(all_i, n_j - 1), q, n_j))
        cols.append(flat_index(all_i, np.full_like(all_i, n_j - 3), q, n_j))
        vals.append(-np.ones(n_i))

    n = 3 * n_i * n_j
    mat = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )
    return mat.tocsr()


def fields_to_flat(u: np.ndarray) -> np.ndarray:
    """(3, Ni, Nj) field stack -> interleaved flat vector."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(u), 0, -1)).ravel()


def flat_to_fields(x: np.ndarray, n_i: int, n_j: int) -> np.ndarray:
    """Interleaved flat vector -> (3, Ni, Nj) field stack."""
    return np.moveaxis(np.asarray(x).reshape(n_i, n_j, 3), -1, 0)


def direct_solve(coeffs: ELCoefficients, rhs: np.ndarray) -> Tuple[np.ndarray, bool]:
    """spsolve the assembled system (small images only — the CPU oracle,
    ref :1147)."""
    import scipy.sparse.linalg

    n_i, n_j = rhs.shape[-2:]
    mat = assemble_el_matrix(coeffs, n_i, n_j)
    b = fields_to_flat(rhs)
    x = scipy.sparse.linalg.spsolve(mat, b)
    return flat_to_fields(x, n_i, n_j), True
