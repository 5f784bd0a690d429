"""Typed data contracts for the engine.

The reference's universal data contract is the *flow-result dict* with keys
``v_x, v_y, speed, original_data, blurred_data, delta_x, delta_t`` plus
optionally ``remodelling, converged, L1_functional, remodelling_functional,
speed_functional`` (/root/reference/source/optical_flow.py:206-217,
1193-1205).  :class:`FlowResult` keeps that contract — it is a mapping, so
every reference-style driver/plot call site (``result['v_x']``) keeps
working — while also being a well-typed object with save/load helpers.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional

import numpy as np


class FlowResult(Mapping):
    """Result of an optical-flow computation.

    Behaves like the reference result dict (mapping access, ``.keys()``,
    ``np.save``-able via :meth:`to_dict`) with typed attribute access for
    the standard fields.  Velocity arrays have shape ``(frames-1, X, Y)``
    and physical units (delta_x/delta_t applied), matching the reference.
    """

    _STANDARD = (
        "v_x",
        "v_y",
        "speed",
        "remodelling",
        "original_data",
        "blurred_data",
        "delta_x",
        "delta_t",
        "converged",
        "L1_functional",
        "remodelling_functional",
        "speed_functional",
    )

    def __init__(self, **entries: Any):
        self._data: Dict[str, Any] = {k: v for k, v in entries.items() if v is not None}

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- typed accessors --------------------------------------------------
    @property
    def v_x(self) -> np.ndarray:
        return self._data["v_x"]

    @property
    def v_y(self) -> np.ndarray:
        return self._data["v_y"]

    @property
    def speed(self) -> np.ndarray:
        return self._data["speed"]

    @property
    def remodelling(self) -> Optional[np.ndarray]:
        return self._data.get("remodelling")

    @property
    def delta_x(self) -> float:
        return float(self._data["delta_x"])

    @property
    def delta_t(self) -> float:
        return float(self._data["delta_t"])

    @property
    def converged(self) -> Optional[bool]:
        value = self._data.get("converged")
        return None if value is None else bool(value)

    # -- conversion / persistence ----------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain dict with host numpy arrays (reference-compatible)."""
        out = {}
        for key, value in self._data.items():
            if hasattr(value, "device_buffer") or type(value).__module__.startswith("jax"):
                out[key] = np.asarray(value)
            else:
                out[key] = value
        return out

    def save(self, path: str) -> None:
        """Persist as the reference does: ``np.save(..., allow_pickle)`` of
        the result dict (ref analysis/compare_rho_and_actin.py:627)."""
        np.save(path, self.to_dict(), allow_pickle=True)

    @classmethod
    def load(cls, path: str) -> "FlowResult":
        data = np.load(path, allow_pickle=True).item()
        return cls(**data)

    def __repr__(self) -> str:
        shapes = {
            k: (tuple(v.shape) if hasattr(v, "shape") else v) for k, v in self._data.items()
        }
        return f"FlowResult({shapes})"


_MATVECS = ("auto", "xla", "gspmd")
_REMOVED_MATVECS = ("pallas", "hybrid")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver configuration (the on-device analogue of the PETSc
    option strings at ref optical_flow.py:1080-1093, 1117-1126)."""

    # 'auto' picks BiCGStab below 500 interior points on the longest axis
    # and flexible GMRES(restart)+MG at/above it — where the f32 BiCGStab
    # recurrences are measured to collapse (see solve.krylov.fgmres and
    # flow.variational.resolve_method).  'bicgstab' matches the
    # reference's KSP choice exactly; 'gmres' is the monotone,
    # breakdown-free large-grid solver.
    method: str = "auto"  # 'auto' | 'bicgstab' | 'gmres' | 'cg'
    rtol: float = 1e-6  # relative tolerance on the unpreconditioned residual
    atol: float = 0.0
    max_iterations: int = 1000
    preconditioner: str = "multigrid"  # 'none' | 'block_jacobi' | 'multigrid'
    # Dot products / norms are accumulated in f64 when x64 is enabled, even
    # when the fields are f32 ("compensated" reductions, scalar work beside
    # the memory-bound matvecs); this stabilises BiCGStab.  Without x64
    # they run in the field dtype.
    high_precision_reductions: bool = True
    # The convergence test floors the tolerance at ``dtype_tol_floor *
    # eps(dtype) * ||b||`` — the attainable accuracy of f32 BiCGStab on
    # these systems — so f32 runs report convergence at working precision
    # instead of chasing an unreachable f64 tolerance.  300 was calibrated
    # on the 256^2 bench workload against the f64 direct solve: much higher
    # floors stop above the <1e-3 px BASELINE EPE target, and *lower*
    # floors make the solution worse again (post-stall BiCGStab steps add
    # recurrence noise; the solver's stagnation guard returns the best
    # iterate instead of looping to max_iterations when a workload cannot
    # reach the floor).  chip_smoke.py re-checks the target on the GPU.
    dtype_tol_floor: float = 300.0
    # Maximum iterative-refinement steps after the main solve: each
    # recomputes the true residual in double-float compensated arithmetic
    # (ops.df32 — f64-quality residual from f32 elementwise work; plain f32
    # evaluation noise floors the attainable residual far above that) and
    # solves a correction system to `refinement_rtol` with the same
    # preconditioned matvec.  The loop is adaptive: it exits as soon as the df32 true
    # residual meets the floored tolerance (typically 1-2 steps; stalled /
    # breakdown pairs take more — each step doubles as a BiCGStab
    # restart).  See flow.variational for the rationale.
    refinement_restarts: int = 8
    refinement_rtol: float = 0.2
    # The refinement loop exits when the df32 true residual reaches
    # ``refinement_exit_factor * tol`` — refining *past* the reported
    # tolerance so the flow EPE keeps margin under the <1e-3 px BASELINE
    # target instead of landing on the tolerance boundary.  On the 12-pair
    # 256^2 batch a looser 0.25 left pair EPEs above target while 0.1 met
    # it at no extra wall time, because the batch's slowest pair already
    # sets the adaptive loop's trip count.
    # ``None`` resolves by grid size (flow.variational): 0.1 below 500
    # interior points on the longest axis, 0.03 at/above — at 1024^2 the
    # worse conditioning turns exit 0.1's residual slack into EPE above
    # target vs an f64 FGMRES oracle, which 0.03 meets
    # (tests/test_accuracy_1024.py).
    refinement_exit_factor: Optional[float] = None
    # FGMRES restart length (memory: ~2*restart solution-size vectors per
    # concurrently solved pair — lower it for large batched stacks).
    gmres_restart: int = 32
    # Matvec partitioning in the sharded paths (parallel.batch): 'auto' /
    # 'xla' run the one-exchange-per-application shard_map stencil
    # (parallel.halo) when the interior divides the mesh, 'gspmd' the
    # fully automatic partitioning.  On one device every value runs the
    # XLA-fused stencil.
    matvec: str = "auto"  # 'auto' | 'xla' | 'gspmd'

    def __post_init__(self):
        if self.matvec in _REMOVED_MATVECS:
            raise ValueError(
                f"matvec={self.matvec!r} was removed together with its "
                "Pallas kernels; use 'auto' (the XLA-fused stencil)"
            )
        if self.matvec not in _MATVECS:
            raise ValueError(
                f"unknown matvec {self.matvec!r}; expected one of {_MATVECS}"
            )


@dataclasses.dataclass(frozen=True)
class VariationalConfig:
    """Reusable experiment preset for the flagship variational flow solve
    (mirrors the kwargs of ref ``variational_optical_flow``, :715-724).
    ``config.run(movie)`` executes the solve with these settings."""

    delta_x: float = 1.0
    delta_t: float = 1.0
    speed_alpha: float = 1.0
    remodelling_alpha: float = 1000.0
    smoothing_sigma: Optional[float] = None
    initial_v_x: float = 0.0
    initial_v_y: float = 0.0
    initial_remodelling: float = 0.0
    # 'sequential' reproduces the reference's warm-start chain across frame
    # pairs (ref :799-806); 'cold' drops it so frame pairs become
    # embarrassingly parallel (batched/sharded execution); 'two-pass'
    # solves pair 0 first and batches the rest from its solution — most of
    # the warm-start savings at full batch parallelism.
    warm_start: str = "sequential"
    # 'compat' replicates the reference's dy-rule defect (see core.stencils).
    dy_mode: str = "compat"
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    dtype: Any = None  # None -> float32, or float64 if x64 is enabled

    def run(self, movie) -> "FlowResult":
        """Run the variational solve on ``movie`` with this preset."""
        from opticalflow_tpu.flow.variational import variational_optical_flow

        return variational_optical_flow(
            movie,
            delta_x=self.delta_x,
            delta_t=self.delta_t,
            speed_alpha=self.speed_alpha,
            remodelling_alpha=self.remodelling_alpha,
            smoothing_sigma=self.smoothing_sigma,
            initial_v_x=self.initial_v_x,
            initial_v_y=self.initial_v_y,
            initial_remodelling=self.initial_remodelling,
            dy_mode=self.dy_mode,
            warm_start=self.warm_start,
            solver=self.solver,
            dtype=self.dtype,
        )


@dataclasses.dataclass(frozen=True)
class BoxFlowConfig:
    """Reusable experiment preset for the box-method (Vig et al. 2016)
    flow (mirrors ref ``conduct_optical_flow``, :159).
    ``config.run(movie)`` executes the flow with these settings."""

    boxsize: int = 15
    delta_x: float = 1.0
    delta_t: float = 1.0
    smoothing_sigma: Optional[float] = None
    background: Optional[float] = None
    include_remodelling: bool = False

    def run(self, movie) -> "FlowResult":
        """Run the box-method flow on ``movie`` with this preset."""
        from opticalflow_tpu.flow.boxflow import conduct_optical_flow

        return conduct_optical_flow(
            movie,
            boxsize=self.boxsize,
            delta_x=self.delta_x,
            delta_t=self.delta_t,
            smoothing_sigma=self.smoothing_sigma,
            background=self.background,
            include_remodelling=self.include_remodelling,
        )
