"""opticalflow_tpu — an on-device variational optical flow engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
kursawe/OpticalFlow reference pipeline (variational optical flow with net
remodelling for actin/myosin/Rho fluorescence movies):

- ``flow.boxflow``      box-method (Vig et al. 2016) optical flow
- ``flow.variational``  flagship coupled Euler-Lagrange variational solve
                        (matrix-free stencil operator + Krylov solver)
- ``flow.liushen``      Liu-Shen Jacobi iteration (legacy/deprecated path)
- ``flow.farneback``    OpenCV Farneback interop (optional, CPU)
- ``ops``               preprocessing (gaussian blur, CLAHE, adaptive
                        threshold, area resize) on device
- ``solve``             BiCGStab/CG Krylov solvers, block-Jacobi and
                        multigrid preconditioners, CPU direct-solve oracle
- ``parallel``          device meshes, halo exchange, frame-pair sharding
- ``analysis``          regularisation sweeps, hyperparameter tuning
- ``viz``               overlay movies, convergence plots, sweep heatmaps
- ``io``                image-sequence readers, result save/load, PIV interop

The universal data contract is :class:`opticalflow_tpu.core.types.FlowResult`
(mirrors the reference flow-result dict, /root/reference/source/optical_flow.py:206-217).
"""

__version__ = "0.1.0"

from opticalflow_tpu.core.types import BoxFlowConfig, FlowResult, SolverConfig, VariationalConfig
from opticalflow_tpu.flow.boxflow import conduct_optical_flow
from opticalflow_tpu.flow.variational import variational_optical_flow
from opticalflow_tpu.ops.blur import blur_movie

__all__ = [
    "BoxFlowConfig",
    "FlowResult",
    "VariationalConfig",
    "SolverConfig",
    "conduct_optical_flow",
    "variational_optical_flow",
    "blur_movie",
]
