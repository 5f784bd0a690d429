"""Where entry points keep JAX's persistent compilation cache.

The library itself sets no cache; the command-line entry points
(``chip_smoke.py``, ``bench.py``, and the drivers CLI
``opticalflow_tpu.analysis.drivers.cli``) call :func:`enable` once at
start-up.
A cache directory set in ``JAX_COMPILATION_CACHE_DIR`` wins (JAX reads the
variable itself); otherwise the cache lives at a fixed path inside the
checkout, ``<checkout>/.jax_cache``, whatever the working directory —
the path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
