"""utils: observability spans, result cache, drivers CLI smoke."""

import numpy as np

from opticalflow_tpu.core.types import FlowResult
from opticalflow_tpu.utils.cache import ResultCache, config_hash
from opticalflow_tpu.utils.observability import (
    Timer,
    format_elapsed_time,
    reset_spans,
    span,
    span_statistics,
)


def test_format_elapsed_time_matches_reference_semantics():
    assert format_elapsed_time(125.25) == (2, 5, 250)
    assert format_elapsed_time(0.001) == (0, 0, 1)


def test_spans_registry():
    reset_spans()
    with span("phase_a"):
        pass
    with span("phase_a"):
        pass
    with Timer("phase_b") as t:
        pass
    stats = span_statistics()
    assert stats["phase_a"]["count"] == 2
    assert "phase_b" in stats
    assert "minutes" in t.report()


def test_result_cache_roundtrip(tmp_path):
    movie = np.arange(24.0).reshape(2, 3, 4)
    cache = ResultCache(str(tmp_path))
    calls = []

    def compute():
        calls.append(1)
        return FlowResult(v_x=np.ones((1, 3, 4)), v_y=np.zeros((1, 3, 4)),
                          speed=np.ones((1, 3, 4)), delta_x=1.0, delta_t=1.0)

    r1 = cache.get_or_compute(movie, compute, alpha=2.0)
    r2 = cache.get_or_compute(movie, compute, alpha=2.0)
    assert len(calls) == 1
    np.testing.assert_array_equal(r1["v_x"], r2["v_x"])
    # different config -> different key -> recompute
    cache.get_or_compute(movie, compute, alpha=3.0)
    assert len(calls) == 2
    assert config_hash(movie, alpha=2.0) != config_hash(movie, alpha=3.0)


def test_drivers_cli_synthetic(tmp_path):
    from opticalflow_tpu.analysis.drivers import main

    result, stats = main([
        "synthetic-box-error", "--output-dir", str(tmp_path), "--dimension", "128",
    ])
    assert (tmp_path / "fake_flow_result_without_noise.npy").exists()
    assert abs(stats["median_v_x"] - 0.1) < 0.05


def test_drivers_cli_file_experiment(tmp_path):
    """Drive the file-based variational experiment end to end via the CLI
    using a synthetic movie saved as an image sequence."""
    from PIL import Image

    from opticalflow_tpu.analysis.drivers import main
    from opticalflow_tpu.core.synth import make_translating_blob_movie

    movie, _ = make_translating_blob_movie(n_frames=3, dimension=24, width=10.0,
                                           sigma=2.5, v_x=0.2, v_y=0.1)
    movie = (np.asarray(movie) * 255).astype(np.uint8)
    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    for k, frame in enumerate(movie):
        Image.fromarray(frame).save(seq_dir / f"frame{k}.png")

    out_dir = tmp_path / "out"
    main([
        "variational", str(seq_dir), "--output-dir", str(out_dir),
        "--speed-alpha", "500", "--remodelling-alpha", "500",
    ])
    assert (out_dir / "variational_result.npy").exists()


def test_profile_solve_phases_smoke():
    """Per-phase solver profile: phases present, positive, and recorded
    into the span registry."""
    from opticalflow_tpu.core.synth import make_translating_blob_movie
    from opticalflow_tpu.flow.variational import profile_solve_phases

    reset_spans()
    movie, _ = make_translating_blob_movie(
        n_frames=2, dimension=32, width=8.0, sigma=2.0, v_x=0.1, v_y=0.05,
        dtype=np.float32,
    )
    movie = np.asarray(movie, np.float32) * 100.0
    phases = profile_solve_phases(movie[0], movie[1], 1000.0, 1000.0, reps=1)
    for key in ("pair_data", "mg_setup", "krylov_main", "refinement",
                "host_transfer", "total"):
        assert key in phases and phases[key] >= 0.0
    assert phases["total"] > 0.0
    stats = span_statistics()
    assert stats["solve/krylov_main"]["count"] == 1


def _run_in(cwd, script, env_dir=None):
    """Run ``script`` in a fresh interpreter from ``cwd`` with the repo
    importable and ``JAX_COMPILATION_CACHE_DIR`` set only to ``env_dir``."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = repo
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


_CACHE_SCRIPT = """
import jax
from opticalflow_tpu.utils import compile_cache
d = compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2.0 + 1.0)(1.0).block_until_ready()
print(d, jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A directory set in JAX_COMPILATION_CACHE_DIR wins, and compiled
    programs are stored there."""
    cache = tmp_path / "cache"
    enabled, configured = _run_in(tmp_path, _CACHE_SCRIPT, env_dir=cache)
    assert enabled == configured == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_defaults_to_checkout_from_any_cwd(tmp_path):
    """Without the variable the cache is the checkout's .jax_cache, whatever
    the working directory."""
    import os

    script = (
        "import jax\n"
        "from opticalflow_tpu.utils import compile_cache\n"
        "print(compile_cache.enable(), jax.config.jax_compilation_cache_dir)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    enabled, configured = _run_in(tmp_path, script)
    assert enabled == configured == os.path.join(repo, ".jax_cache")
