"""Regularisation sweeps.

Equivalent of the reference's ``vary_regularisation``
(/root/reference/source/optical_flow.py:1918-1998), which runs the full
variational solve for every (speed_alpha, remodelling_alpha) grid cell
*serially* — up to 300 solves per sweep (SURVEY.md section 3.4).  Here the
grid is an additional batch axis: alphas are traced operands of the jitted
solve, so the whole grid runs as one vmapped device computation (and can
be sharded over the mesh together with frame pairs) — the workload the
reference runs for hours becomes seconds on a chip.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from opticalflow_tpu.core.types import SolverConfig
from opticalflow_tpu.flow.variational import solve_frame_pair, variational_optical_flow


def vary_regularisation(
    movie,
    speed_alpha_values=np.arange(500, 2000, 500),
    remodelling_alpha_values=np.arange(500, 2000, 500),
    filename: Optional[str] = None,
    batched: bool = True,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Sweep both regularisation parameters; collect mean/variance of
    speed and remodelling, convergence flags and the total functional.

    ``batched=True`` runs the whole grid on-device in one vmapped solve
    (cold-start pairs); ``batched=False`` reproduces the reference's
    serial loop through ``variational_optical_flow`` (kwargs pass through,
    ref :1974-1977).
    """
    speed_alpha_values = np.asarray(speed_alpha_values)
    remodelling_alpha_values = np.asarray(remodelling_alpha_values)
    shape = (len(speed_alpha_values), len(remodelling_alpha_values))

    if batched:
        stats = _batched_sweep(movie, speed_alpha_values, remodelling_alpha_values, **kwargs)
    else:
        stats = {
            "speed_means": np.zeros(shape),
            "speed_variances": np.zeros(shape),
            "remodelling_means": np.zeros(shape),
            "remodelling_variances": np.zeros(shape),
            "converged": np.zeros(shape, dtype=bool),
            "functional": np.zeros(shape),
        }
        for i, a_s in enumerate(speed_alpha_values):
            for j, a_r in enumerate(remodelling_alpha_values):
                result = variational_optical_flow(
                    movie, speed_alpha=float(a_s), remodelling_alpha=float(a_r), **kwargs
                )
                stats["speed_means"][i, j] = np.mean(result["speed"])
                stats["speed_variances"][i, j] = np.var(result["speed"])
                stats["remodelling_means"][i, j] = np.mean(result["remodelling"])
                stats["remodelling_variances"][i, j] = np.var(result["remodelling"])
                stats["converged"][i, j] = result["converged"]
                stats["functional"][i, j] = (
                    result["L1_functional"]
                    + result["speed_functional"]
                    + result["remodelling_functional"]
                )

    result_dict = {
        "speed_alpha_values": speed_alpha_values,
        "remodelling_alpha_values": remodelling_alpha_values,
        **stats,
    }
    if filename is not None:
        np.save(filename, result_dict)
    return result_dict


@functools.partial(
    jax.jit,
    static_argnames=("dy_mode", "method", "preconditioner", "max_iterations",
                     "n_pairs"),
)
def _sweep_kernel(movie, alpha_pairs, delta_x, delta_t, rtol, dy_mode, method,
                  preconditioner, max_iterations, n_pairs):
    prev = movie[:-1]
    cur = movie[1:]
    u_init = jnp.zeros((3,) + movie.shape[1:], dtype=movie.dtype)
    n_cells = alpha_pairs.shape[0]

    # The (grid cell, frame pair) product is flattened into ONE vmap axis,
    # so each chunk is a single batch of independent solves.  The frames
    # are broadcast per cell.
    prev_f = jnp.tile(prev, (n_cells, 1, 1))
    cur_f = jnp.tile(cur, (n_cells, 1, 1))
    alphas_f = jnp.repeat(alpha_pairs, n_pairs, axis=0)

    def solve_one(p, c, alphas):
        return solve_frame_pair(
            p, c, u_init, alphas[0], alphas[1], dy_mode=dy_mode, method=method,
            preconditioner=preconditioner, rtol=rtol,
            max_iterations=max_iterations,
        )

    all_u, infos = jax.vmap(solve_one)(prev_f, cur_f, alphas_f)
    all_u = all_u.reshape((n_cells, n_pairs) + all_u.shape[1:])
    infos = jax.tree.map(
        lambda x: x.reshape((n_cells, n_pairs) + x.shape[1:]), infos
    )
    scale = delta_x / delta_t
    v = all_u[:, :, :2] * scale
    speed = jnp.sqrt(v[:, :, 0] ** 2 + v[:, :, 1] ** 2)
    remodelling = all_u[:, :, 2]
    cell_axes = (1, 2, 3)
    return {
        "speed_mean": jnp.mean(speed, axis=cell_axes),
        "speed_var": jnp.var(speed, axis=cell_axes),
        "remodelling_mean": jnp.mean(remodelling, axis=cell_axes),
        "remodelling_var": jnp.var(remodelling, axis=cell_axes),
        "converged": jnp.all(infos["converged"], axis=1),
        # total functional = L1 + speed + remodelling (note: in compat
        # mode the reference's tuning objective double-counts the
        # remodelling functional instead of speed, ref :1205; we keep
        # the *correct* objective here and expose both pieces)
        "functional": jnp.sum(
            infos["L1_functional"]
            + infos["speed_functional"]
            + infos["remodelling_functional"],
            axis=1,
        ),
        "functional_ref_compat": jnp.sum(
            infos["L1_functional"] + 2.0 * infos["remodelling_functional"],
            axis=1,
        ),
    }


def _batched_sweep(movie, speed_alphas, remodelling_alphas, delta_x=1.0, delta_t=1.0,
                   smoothing_sigma=None, dy_mode="compat", solver=None, dtype=None,
                   batch_chunk=48, **unsupported):
    if unsupported:
        raise TypeError(
            f"batched sweep does not support {sorted(unsupported)}; grid cells "
            "are cold-start vmapped solves (pass batched=False for the serial "
            "variational_optical_flow path, which accepts all of its kwargs)"
        )
    from opticalflow_tpu.ops.blur import blur_movie

    solver = solver or SolverConfig()
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    movie = jnp.asarray(movie, dtype=dtype)
    if smoothing_sigma is not None:
        movie = blur_movie(movie, smoothing_sigma=smoothing_sigma)

    grid = np.array(
        [[a_s, a_r] for a_s in speed_alphas for a_r in remodelling_alphas]
    )
    # The grid runs in CHUNKS of <= batch_chunk solves (flattened cells x
    # pairs), which bounds device memory per call; 48 was set below a
    # device fault seen at batch >= 64 on the accelerator this engine was
    # first built for (whether the GPU needs a cap at all is an open
    # question).  Every chunk reuses ONE compiled executable (the last
    # chunk is padded by repeating its final row, results trimmed).
    n_pairs = movie.shape[0] - 1
    cells_per_chunk = max(1, int(batch_chunk) // max(n_pairs, 1))
    n_cells = grid.shape[0]
    chunk_outs = []
    for lo in range(0, n_cells, cells_per_chunk):
        chunk = grid[lo : lo + cells_per_chunk]
        pad = cells_per_chunk - chunk.shape[0]
        if pad and n_cells > cells_per_chunk:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        out_c = _sweep_kernel(
            movie,
            jnp.asarray(chunk, dtype=dtype),
            jnp.asarray(delta_x, dtype=dtype),
            jnp.asarray(delta_t, dtype=dtype),
            solver.rtol,
            dy_mode,
            solver.method,
            solver.preconditioner,
            solver.max_iterations,
            n_pairs,
        )
        if pad and n_cells > cells_per_chunk:
            out_c = {k: v[: cells_per_chunk - pad] for k, v in out_c.items()}
        chunk_outs.append(jax.tree.map(np.asarray, out_c))
    out = {
        k: np.concatenate([c[k] for c in chunk_outs], axis=0)
        for k in chunk_outs[0]
    }
    shape = (len(speed_alphas), len(remodelling_alphas))
    return {
        "speed_means": np.asarray(out["speed_mean"]).reshape(shape),
        "speed_variances": np.asarray(out["speed_var"]).reshape(shape),
        "remodelling_means": np.asarray(out["remodelling_mean"]).reshape(shape),
        "remodelling_variances": np.asarray(out["remodelling_var"]).reshape(shape),
        "converged": np.asarray(out["converged"]).reshape(shape),
        "functional": np.asarray(out["functional"]).reshape(shape),
        "functional_ref_compat": np.asarray(out["functional_ref_compat"]).reshape(shape),
    }
