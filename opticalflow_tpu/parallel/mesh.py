"""Device meshes for distributed optical flow.

The reference is strictly serial (SURVEY.md section 2.4: sequential PETSc,
no MPI/NCCL anywhere).  The engine's parallel axes are defined by the
workload's own structure, not by how the devices are wired (every device
of a host reaches every other at the same rate):

* ``frames`` — frame-pair data parallelism (the reference's outer Python
  loops, ref optical_flow.py:83,791, become a sharded batch axis; across
  hosts this is the axis that crosses the network);
* ``tx``, ``ty`` — 2-D spatial tiling of each image across devices.
  All stencils need <= 2-pixel halos; the tiled matvec exchanges them
  explicitly (parallel.halo), and the Krylov dot products become
  cross-device psums.

Pipeline/expert parallelism have no analogue in this workload (no layered
model, no experts) — spatial tiling + frame sharding are its "tensor
parallel" and "data parallel" equivalents; this is deliberate, not an
omission (SURVEY.md section 2.4).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXES = ("frames", "tx", "ty")


def _factor(n: int) -> Tuple[int, int, int]:
    """Split n devices into (frames, tx, ty), preferring frame-pair
    parallelism first (it needs no halo traffic), then near-square tiles."""
    best = (n, 1, 1)
    # prefer a modest frames axis and square-ish tiling when n is large
    frames = n
    tx = ty = 1
    # peel factors of 2 into the tile axes once frames exceeds 4
    while frames % 2 == 0 and frames > 4:
        if tx <= ty:
            tx *= 2
        else:
            ty *= 2
        frames //= 2
    best = (frames, tx, ty)
    return best


def _near_square(n: int) -> Tuple[int, int]:
    """(tx, ty) with tx * ty == n, as square as n's divisors allow
    (tx >= ty, so the longer axis tiles image rows)."""
    ty = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            ty = d
            break
    return n // ty, ty


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    frames: Optional[int] = None,
    tx: Optional[int] = None,
    ty: Optional[int] = None,
    workload: str = "movie",
) -> Mesh:
    """Build a ('frames', 'tx', 'ty') mesh over the given devices.

    Unspecified axis sizes are inferred (partially specified axes are
    honoured, and a single-huge-image workload has its own default):

    * all three unspecified — ``workload`` decides: ``'movie'`` (default)
      prefers frame-pair parallelism (no halo traffic) with modest tiling
      beyond 4 devices; ``'single_pair'`` (BASELINE config-4 shape: one
      native-resolution pair, nothing to batch) pins ``frames=1`` and
      tiles the image near-square;
    * some specified — the remaining device count goes to the
      unspecified axes: a lone unspecified axis takes it all, and an
      unspecified (tx, ty) pair splits it near-square.  So
      ``make_mesh(devices, frames=1)`` on 8 devices now yields
      ``(1, 4, 2)``.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    spec = {"frames": frames, "tx": tx, "ty": ty}
    unspec = [k for k, v in spec.items() if v is None]
    if len(unspec) == 3:
        if workload == "single_pair":
            spec["frames"] = 1
            spec["tx"], spec["ty"] = _near_square(n)
        elif workload == "movie":
            spec["frames"], spec["tx"], spec["ty"] = _factor(n)
        else:
            raise ValueError(f"unknown workload {workload!r}")
    elif unspec:
        known = int(np.prod([v for v in spec.values() if v is not None]))
        if known <= 0 or n % known:
            raise ValueError(
                f"specified axes {spec} do not divide {n} devices"
            )
        rem = n // known
        if len(unspec) == 1:
            spec[unspec[0]] = rem
        elif set(unspec) == {"tx", "ty"}:
            spec["tx"], spec["ty"] = _near_square(rem)
        else:
            # frames + one tile axis free: frames-first (no halo traffic)
            spec[unspec[0] if unspec[0] == "frames" else unspec[1]] = rem
            for k in unspec:
                if spec[k] is None:
                    spec[k] = 1
    frames, tx, ty = spec["frames"], spec["tx"], spec["ty"]
    if frames * tx * ty != n:
        raise ValueError(f"mesh {frames}x{tx}x{ty} != {n} devices")
    dev_array = np.asarray(devices).reshape(frames, tx, ty)
    return Mesh(dev_array, AXES)


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-frame-pair image stacks (pairs, X, Y)."""
    return NamedSharding(mesh, PartitionSpec("frames", "tx", "ty"))


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-pair field stacks (pairs, 3, X, Y)."""
    return NamedSharding(mesh, PartitionSpec("frames", None, "tx", "ty"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
