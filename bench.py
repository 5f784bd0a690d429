"""Benchmark harness — prints ONE JSON line for the driver.

North-star metric (BASELINE.json): frame-pairs/sec on the flagship
variational solve, plus flow EPE vs the f64 reference solution.

Design — the headline can never be lost:

* **Earliest-value-first.**  ``RESULT["value"]`` is set after the FIRST
  successful timed stage — a single-pair 256^2 solve — and then
  *refined* by the batched 12-pair stage.
* **Stage timestamps.**  Every stage boundary writes
  ``RESULT["stages"][name] = seconds`` as it happens and mirrors the
  whole RESULT to ``BENCH_PROGRESS.json`` on disk, so an interrupted run
  is diagnosable from the JSON alone.
* **Host work is concurrent.**  The f64 spsolve oracles (pairs 0, 1, 6,
  11) and the CPU reference baseline run in a background thread from
  t=0, while the main thread waits on device compiles and executions.
* **Budgeted + un-killable.**  Sections start only while wall-clock
  budget (``BENCH_BUDGET_S``, default 500 s) remains; SIGTERM/SIGALRM
  print the JSON assembled so far (alarm at budget+90 s).
* **EPE over sampled batched pairs**: headline ``epe_px_vs_f64_direct``
  is the max over batched pairs {1, 6, 11}, each vs its own f64
  assembled spsolve oracle; a non-converged pair sets
  ``converged_ok: false`` loudly.
* **Compile-cache accounting.**  Cache entry counts before / after plus
  per-stage compile seconds distinguish cache hit vs miss.

The run requires a GPU; on any other backend ``main`` exits non-zero.

Workload: config-3 analogue — a 12-pair batch of a 256^2 synthetic movie
(the repo ships no data; BASELINE.md: the CPU baseline must be measured,
not quoted), full variational solve at practice-scale regularisation,
compat dy mode, production defaults (warm_start='two-pass';
refinement_exit_factor resolves scale-aware — 0.1 at 256^2, 0.03 at >=500^2, set by the
f64-oracle comparison in tests/test_accuracy_1024.py).

The CPU baseline is a faithful re-run harness of the reference pipeline
(/root/reference/source/optical_flow.py:829-1157): per frame pair,
vectorized assembly of the same 3N^2 sparse system in float64 solved with
SuperLU spsolve — the reference's own ``use_direct_solver`` path (ref
:1147; scipy ILU hits structurally zero pivots on these systems, and
numba/petsc4py are not installed in this image).  The vectorized assembly
is *faster* than the reference's lil-matrix writes, so the reported
speedup is conservative.
"""

import json
import os
import signal
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

DIM = 256
N_PAIRS = 12
ALPHA_S = 1000.0
ALPHA_R = 1000.0
RTOL = 1e-6
EXIT_FACTOR = None  # refinement exit: scale-aware default (see SolverConfig)
EPE_PAIRS = (1, 6, 11)  # batched pairs sampled for the headline EPE

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "500"))
_T0 = time.time()
_HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks per ``device_kind`` (NVIDIA H100 SXM data sheet: dense
# rates at the full 700 W power limit).  A device missing here is an
# error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}


def device_peaks(device_kind):
    """Peak table entry for ``device_kind``; raises for an unknown device."""
    if device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        )
    return PEAKS[device_kind]


RESULT = {
    "metric": f"variational_flow_{DIM}x{DIM}_frame_pairs_per_sec",
    "value": None,
    "unit": "frame-pairs/s",
    "vs_baseline": None,
    "value_stage": None,
    "stages": {},
}


def _remaining():
    return BUDGET_S - (time.time() - _T0)


def _stamp(name):
    """Record a stage boundary in RESULT and mirror to disk (diagnosable
    even under SIGKILL, which no handler can catch)."""
    RESULT["stages"][name] = round(time.time() - _T0, 1)
    try:
        with open(os.path.join(_HERE, "BENCH_PROGRESS.json"), "w") as fh:
            json.dump(RESULT, fh)
    except OSError:
        pass
    _log(f"stage {name}")


def _emit_and_exit(signum, frame):
    RESULT["interrupted_at_s"] = round(time.time() - _T0, 1)
    print(json.dumps(RESULT), flush=True)
    os._exit(0)


def _install_safety():
    signal.signal(signal.SIGTERM, _emit_and_exit)
    signal.signal(signal.SIGALRM, _emit_and_exit)
    signal.alarm(int(BUDGET_S) + 90)


def _log(msg):
    print(f"# [{time.time() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def make_movie(n_frames, dim, dtype):
    from opticalflow_tpu.core.synth import make_translating_blob_movie

    # Blob width scales with the grid (20 px at <= 256^2 — the headline
    # workload is unchanged) so signal coverage stays representative of
    # real microscopy at every size: a fixed-width blob on a 1024^2
    # otherwise-zero frame degenerates the velocity equations to a pure
    # Laplacian over most of the image (no data term), which is a
    # condition-number corner case rather than BASELINE config 2's
    # "native-resolution actin pair" (real frames have structure across
    # the field).  At 1024^2 the width-scaled pair's df32 refinement
    # contracts at the target rate, while a fixed-20px pair's correction
    # solves stall above tol.  Below 256^2 the width stays 20 px —
    # shrinking it further enters the same low-coverage corner from the
    # other side (at width 10 on 128^2 some pairs become f32-unsolvable
    # and report converged=False).
    movie, delta_x = make_translating_blob_movie(
        n_frames=n_frames, dimension=dim, width=20.0 * max(dim, 256) / 256,
        sigma=3.0, v_x=0.15, v_y=0.1, dtype=dtype,
    )
    # Round the frames through f32 so the f64 oracle and the f32 engine see
    # the *same* data — real microscopy frames are integer-valued (uint16)
    # and exactly representable in f32, so this matches production; the EPE
    # then measures pure solver error, not synthetic-data rounding.
    movie = np.asarray(np.asarray(movie, np.float64) * 100.0, np.float32)
    return movie.astype(np.float64), delta_x


def numpy_pair_data(prev, cur, a_s, a_r):
    """Pure-numpy coefficient planes + RHS (f64) — avoids touching the JAX
    backend config for host-side baseline/oracle work."""
    from opticalflow_tpu.ops.elop import ELCoefficients

    prev = np.asarray(prev, np.float64)
    cur = np.asarray(cur, np.float64)
    I = prev[1:-1, 1:-1]
    dIdx = (prev[2:, 1:-1] - prev[:-2, 1:-1]) / 2
    dIdy = dIdx  # compat mode: the reference's dy rule duplicates dx
    dIdxx = prev[2:, 1:-1] + prev[:-2, 1:-1] - 2 * I
    dIdyy = prev[1:-1, 2:] + prev[1:-1, :-2] - 2 * I
    dIdxy = (prev[2:, 2:] - prev[2:, :-2] - prev[:-2, 2:] + prev[:-2, :-2]) / 4
    dIdx_t = (cur[2:, 1:-1] - cur[:-2, 1:-1] - prev[2:, 1:-1] + prev[:-2, 1:-1]) / 2
    dIdy_t = (cur[1:-1, 2:] - cur[1:-1, :-2] - prev[1:-1, 2:] + prev[1:-1, :-2]) / 2
    dIdt = (cur - prev)[1:-1, 1:-1]
    coeffs = ELCoefficients(
        diag_x=I * (dIdxx - 2 * I) - 4 * a_s,
        diag_y=I * (dIdyy - 2 * I) - 4 * a_s,
        cross=I * dIdxy,
        adv_xm=I * (-dIdx + I) + a_s,
        adv_xp=I * (dIdx + I) + a_s,
        adv_ym=I * (-dIdy + I) + a_s,
        adv_yp=I * (dIdy + I) + a_s,
        gx=I * dIdx / 2,
        gy=I * dIdy / 2,
        quart=I * I / 4,
        half_I=I / 2,
        dIdx=dIdx,
        dIdy=dIdy,
        speed_alpha=np.float64(a_s),
        remodelling_alpha=np.float64(a_r),
    )
    rhs = np.zeros((3,) + prev.shape)
    rhs[0, 1:-1, 1:-1] = -I * dIdx_t
    rhs[1, 1:-1, 1:-1] = -I * dIdy_t
    rhs[2, 1:-1, 1:-1] = -dIdt
    return coeffs, rhs


def _direct_f64_fields(movie, k=0):
    """f64 assembled spsolve oracle fields for pair k of ``movie``."""
    import scipy.sparse.linalg as spla

    from opticalflow_tpu.solve.direct import assemble_el_matrix, fields_to_flat, flat_to_fields

    coeffs, rhs = numpy_pair_data(movie[k], movie[k + 1], ALPHA_S, ALPHA_R)
    mat = assemble_el_matrix(coeffs, movie.shape[1], movie.shape[2]).tocsr()
    x = spla.spsolve(mat, fields_to_flat(rhs))
    return flat_to_fields(x, movie.shape[1], movie.shape[2])


class HostWorker(threading.Thread):
    """Background host-CPU worker: f64 spsolve oracles for the sampled
    pairs + the reference-pipeline CPU baseline.  Runs concurrently with
    device compiles/executions."""

    def __init__(self, movie):
        super().__init__(daemon=True)
        self.movie = movie
        self.oracles = {}
        self.cpu_pair_seconds = None
        self.error = None

    def run(self):
        try:
            t0 = time.perf_counter()
            self.oracles[0] = _direct_f64_fields(self.movie, 0)
            # the pair-0 oracle doubles as the CPU reference baseline
            # measurement: same vectorized assembly + SuperLU spsolve the
            # baseline harness would run (module docstring)
            self.cpu_pair_seconds = time.perf_counter() - t0
            _stamp("host_baseline_done")
            for k in EPE_PAIRS:
                self.oracles[k] = _direct_f64_fields(self.movie, k)
            _stamp("host_oracles_done")
        except Exception as err:  # noqa: BLE001 — worker must never kill the bench
            self.error = repr(err)
            _log(f"host worker ERROR: {err!r}")


# ---------------------------------------------------------------------------
# Core stages
# ---------------------------------------------------------------------------


def _movie_runner(warm_start, gmres_restart=32):
    import jax.numpy as jnp
    from opticalflow_tpu.flow.variational import _solve_movie

    def run(mov, u0):
        all_u, infos = _solve_movie(
            mov, u0, jnp.float32(ALPHA_S), jnp.float32(ALPHA_R),
            "compat", "auto", "multigrid", RTOL, 1000, True, warm_start,
            8, 300.0, 0.2, gmres_restart, EXIT_FACTOR,
        )
        return all_u, infos

    return run


def single_pair_stage(movie):
    """Cheapest path to a non-null headline: one 256^2 pair, cold start —
    lands a value before anything else."""
    import jax
    import jax.numpy as jnp
    from opticalflow_tpu.flow.variational import solve_frame_pair

    prev = jax.device_put(jnp.asarray(movie[0], jnp.float32))
    cur = jax.device_put(jnp.asarray(movie[1], jnp.float32))
    u0 = jnp.zeros((3, DIM, DIM), jnp.float32)

    @jax.jit
    def solve(p, c):
        return solve_frame_pair(
            p, c, u0, jnp.float32(ALPHA_S), jnp.float32(ALPHA_R),
            method="auto", refinement_exit_factor=EXIT_FACTOR,
        )

    t0 = time.perf_counter()
    u, info = solve(prev, cur)
    jax.block_until_ready(u)
    RESULT["single_pair_compile_s"] = round(time.perf_counter() - t0, 1)
    _stamp("single_compile_done")

    best = float("inf")
    for eps in (1e-4, 2e-4):
        t0 = time.perf_counter()
        u, info = solve(prev + jnp.float32(eps), cur)
        jax.block_until_ready(u)
        best = min(best, time.perf_counter() - t0)
    RESULT["value"] = round(1.0 / best, 3)
    RESULT["value_stage"] = "single_pair"
    RESULT["single_pair_iterations"] = int(info["iterations"])
    RESULT["single_pair_converged"] = bool(info["converged"])
    _stamp("single_value_set")
    _log(f"single-pair: {RESULT['value']} pairs/s, iters={int(info['iterations'])}")
    return u


def batched_stage(movie):
    """The headline workload: 12-pair batch, two-pass warm start,
    3 device-resident reps + 1 end-to-end rep."""
    import jax
    import jax.numpy as jnp

    run = _movie_runner("two-pass")
    u0 = jnp.zeros((3, movie.shape[1], movie.shape[2]), jnp.float32)

    # device-resident inputs, perturbed per-variant so no layer can dedupe
    # repeated identical computations
    rng = np.random.default_rng(0)
    movs = [jax.device_put(jnp.asarray(movie, jnp.float32))]
    for _ in range(3):
        movs.append(jax.device_put(
            jnp.asarray(movie + rng.normal(0, 1e-4, movie.shape), jnp.float32)))

    t0 = time.perf_counter()
    all_u, infos = run(movs[0], u0)
    jax.block_until_ready(all_u)
    RESULT["batch_compile_s"] = round(time.perf_counter() - t0, 1)
    _stamp("batch_compile_done")

    n_pairs = movie.shape[0] - 1
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        all_u, _ = run(movs[1 + rep], u0)
        jax.block_until_ready(all_u)
        times.append(time.perf_counter() - t0)
        # first rep already beats the single-pair value — record it NOW
        RESULT["value"] = round(n_pairs / min(times), 3)
        RESULT["value_stage"] = "batched_12_rep%d" % (rep + 1)
        _stamp(f"batch_rep{rep + 1}")
    RESULT["value"] = round(n_pairs / float(np.median(times)), 3)
    RESULT["device_pairs_per_sec_best"] = round(n_pairs / float(np.min(times)), 3)
    RESULT["value_stage"] = "batched_12_median3"

    # end-to-end: host f64 array in (f32 convert + upload + solve)
    mov_host = movie + rng.normal(0, 1e-4, movie.shape)
    t0 = time.perf_counter()
    all_u, _ = run(jnp.asarray(mov_host, jnp.float32), u0)
    jax.block_until_ready(all_u)
    RESULT["end_to_end_pairs_per_sec"] = round(n_pairs / (time.perf_counter() - t0), 3)

    all_u, infos = run(movs[0], u0)
    iters = np.asarray(infos["iterations"])
    conv = np.asarray(infos["converged"])
    RESULT["warm_start"] = "two-pass"
    RESULT["iterations"] = [int(v) for v in iters]
    RESULT["converged_pairs"] = f"{int(conv.sum())}/{conv.size}"
    RESULT["converged_ok"] = bool(conv.all())  # loud failure
    _stamp("batch_value_set")
    _log(f"batched: {RESULT['value']} pairs/s device (best "
         f"{RESULT['device_pairs_per_sec_best']}), "
         f"{RESULT['end_to_end_pairs_per_sec']} end-to-end, iters={RESULT['iterations']}")
    return all_u


def epe_stage(worker, u_single, all_u):
    """Headline EPE: max over sampled batched pairs {1,6,11}, each vs its
    own f64 assembled spsolve oracle, computed on device."""
    import jax
    import jax.numpy as jnp

    deadline = time.time() + max(min(_remaining() - 60, 120), 5)
    while worker.is_alive() and time.time() < deadline and len(worker.oracles) < 1 + len(EPE_PAIRS):
        time.sleep(0.5)

    @jax.jit
    def epe_dev(u, ref):
        d = u - ref
        return jnp.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max()

    per_pair = {}
    if 0 in worker.oracles and u_single is not None:
        ref0 = jax.device_put(jnp.asarray(worker.oracles[0], jnp.float32))
        per_pair["single_pair0"] = float(epe_dev(u_single, ref0))
    if all_u is not None:
        for k in EPE_PAIRS:
            if k in worker.oracles:
                refk = jax.device_put(jnp.asarray(worker.oracles[k], jnp.float32))
                per_pair[f"batched_pair{k}"] = float(epe_dev(all_u[k], refk))
    if per_pair:
        batched = [v for key, v in per_pair.items() if key.startswith("batched")]
        RESULT["epe_px_vs_f64_direct"] = max(batched) if batched else per_pair["single_pair0"]
        RESULT["epe_pairs"] = {k: round(v, 8) for k, v in per_pair.items()}
        RESULT["epe_ok"] = RESULT["epe_px_vs_f64_direct"] < 1e-3
        _log(f"EPE max over sampled pairs vs f64 direct: "
             f"{RESULT['epe_px_vs_f64_direct']:.2e} px ({per_pair})")
    elif worker.error:
        RESULT["epe_px_vs_f64_direct"] = f"oracle failed: {worker.error}"
    else:
        RESULT["epe_px_vs_f64_direct"] = "oracle not ready before deadline"
    _stamp("epe_done")


def baseline_stage(worker, movie):
    deadline = time.time() + max(min(_remaining() - 30, 60), 5)
    while worker.is_alive() and worker.cpu_pair_seconds is None and time.time() < deadline:
        time.sleep(0.5)
    cpu_fps = None
    if worker.cpu_pair_seconds is not None:
        cpu_fps = 1.0 / worker.cpu_pair_seconds
        RESULT["cpu_baseline_pairs_per_sec_concurrent"] = round(cpu_fps, 4)
    # the concurrent measurement contends with host-side jax tracing and
    # understates the baseline (flattering us) —
    # re-measure uncontended (device idle now) and use the FASTER
    # baseline for vs_baseline, which is the conservative choice
    if _remaining() > 90:
        t0 = time.perf_counter()
        _direct_f64_fields(movie, 2)
        serial_fps = 1.0 / (time.perf_counter() - t0)
        cpu_fps = max(cpu_fps or 0.0, serial_fps)
    if cpu_fps:
        RESULT["cpu_baseline_pairs_per_sec"] = round(cpu_fps, 4)
        if RESULT["value"]:
            RESULT["vs_baseline"] = round(RESULT["value"] / cpu_fps, 2)
        _log(f"cpu reference harness: {cpu_fps:.3f} pairs/s -> "
             f"vs_baseline {RESULT['vs_baseline']}x")
    _stamp("baseline_done")


# ---------------------------------------------------------------------------
# Extended sections (budget-gated, skipped-and-recorded if they don't fit)
# ---------------------------------------------------------------------------


def stencil_bandwidth_section(movie, peak_gbps):
    """Speed-of-light check of the hot stencil matvec.

    Method: chain ``x <- 1e-3 * A(A(x))`` inside one jitted scan at two
    lengths (100 / 500) and DIFFERENCE the wall times, which cancels the
    fixed per-call dispatch cost.  The XLA fused stencil's traffic model
    is ~19 planes/application (13 precomputed coefficient planes + 3 in +
    3 out); ``stencil_bandwidth_utilization`` is its achieved fraction of
    the device's peak memory bandwidth on that traffic."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from opticalflow_tpu.ops import elop

    batch = movie.shape[0] - 1
    rng = np.random.default_rng(7)
    prevs = [
        jax.device_put(jnp.asarray(
            movie[:-1] + rng.normal(0, 1e-4, (batch,) + movie.shape[1:]),
            jnp.float32))
        for _ in range(3)
    ]

    def chain_fn(n_inner):
        @jax.jit
        def chain(prev):
            def per_pair(p):
                s = jnp.max(jnp.abs(p))
                a_sn = jnp.float32(ALPHA_S) / s**2
                pair = elop.compute_frame_pair_data(
                    p / s, p / s, a_sn, jnp.float32(ALPHA_R), "compat")
                x0 = jnp.ones((3, DIM - 2, DIM - 2), jnp.float32)

                def body(x, _):
                    mv = elop.el_matvec_reduced
                    return 1e-3 * mv(pair.coeffs, mv(pair.coeffs, x)), None

                x, _ = lax.scan(body, x0, None, length=n_inner)
                return x

            return jax.vmap(per_pair)(prev)

        return chain

    plane = DIM * DIM * 4
    planes = 19
    times = {}
    for n_inner in (100, 500):
        ch = chain_fn(n_inner)
        jax.block_until_ready(ch(prevs[0]))
        best = float("inf")
        for k in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(ch(prevs[1 + k]))
            best = min(best, time.perf_counter() - t0)
        times[n_inner] = best
    per_app = (times[500] - times[100]) / (400 * 2)
    gbps = batch * planes * plane / per_app / 1e9
    rec = {
        "peak_gbps": peak_gbps,
        "method": "differenced 100/500-application chains",
        "us_per_batched_application": round(per_app * 1e6, 1),
        "traffic_model_planes": planes,
        "achieved_gbps": round(gbps, 1),
        "fraction_of_peak": round(gbps / peak_gbps, 3),
    }
    _log(f"stencil: {per_app*1e6:.1f} us/app -> {gbps:.0f} GB/s "
         f"= {100*gbps/peak_gbps:.0f}% of peak ({planes}-plane model)")
    RESULT["stencil_kernel"] = rec
    RESULT["stencil_bandwidth_utilization"] = rec["fraction_of_peak"]


def embryo_1024_section():
    """BASELINE config-2 scale anchor: one 1024^2 pair (3.1M unknowns,
    /root/reference/analysis/analyse_variational_optical_flow.py:203-205),
    method='auto' -> FGMRES+MG (the large-grid solver)."""
    import jax
    import jax.numpy as jnp
    from opticalflow_tpu.flow.variational import resolve_method, solve_frame_pair

    movie, _ = make_movie(2, 1024, np.float64)
    prev = jax.device_put(jnp.asarray(movie[0], jnp.float32))
    cur = jax.device_put(jnp.asarray(movie[1], jnp.float32))
    u0 = jnp.zeros((3, 1024, 1024), jnp.float32)

    @jax.jit
    def solve(p, c):
        return solve_frame_pair(
            p, c, u0, jnp.float32(ALPHA_S), jnp.float32(ALPHA_R),
            method="auto", refinement_exit_factor=EXIT_FACTOR,
        )

    t0 = time.perf_counter()
    u, info = solve(prev, cur)
    jax.block_until_ready(u)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, info = solve(prev + 1e-4, cur)
    jax.block_until_ready(u)
    solve_s = time.perf_counter() - t0
    rec = {
        "method": resolve_method("auto", 1022, 1022),
        "pairs_per_sec": round(1.0 / solve_s, 3),
        "iterations": int(info["iterations"]),
        "converged": bool(info["converged"]),
        "residual_rel": float(info["residual_norm"]),
        "compile_s": round(compile_s, 1),
    }
    # f64 spsolve at 3.1M unknowns can exhaust memory or run for hours —
    # only attempted when explicitly requested;
    # convergence is judged on the df32 true residual instead, plus the
    # independent f64-FGMRES-oracle slow test (tests/test_accuracy_1024.py).
    if os.environ.get("BENCH_EPE_1024", "0") == "1":
        try:
            u_ref = _direct_f64_fields(movie, 0)
            d = np.asarray(u) - u_ref
            rec["epe_px_vs_f64_direct"] = float(
                np.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max())
        except Exception as err:  # noqa: BLE001 — host oracle is best-effort here
            rec["epe_px_vs_f64_direct"] = f"oracle failed: {type(err).__name__}"
    RESULT.setdefault("reference_scale", {})["embryo_1024x1024_single_pair"] = rec
    _log(f"1024^2: {rec}")


def stack_512_section():
    """BASELINE config-3 at reference scale: 50-pair 512^2 stack batched
    on one chip (method='auto' -> FGMRES at this size)."""
    import jax
    import jax.numpy as jnp

    movie, _ = make_movie(51, 512, np.float64)
    # restart 12: FGMRES keeps ~2*restart solution-size vectors per
    # concurrently solved pair — restart 32 needs ~10 GB of device memory
    # for the 50-pair 512^2 batch (the SolverConfig.gmres_restart guidance)
    run = _movie_runner("two-pass", gmres_restart=12)
    u0 = jnp.zeros((3, 512, 512), jnp.float32)
    mov = jax.device_put(jnp.asarray(movie, jnp.float32))

    t0 = time.perf_counter()
    all_u, infos = run(mov, u0)
    jax.block_until_ready(all_u)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    all_u, infos = run(mov + 1e-4, u0)
    jax.block_until_ready(all_u)
    solve_s = time.perf_counter() - t0
    iters = np.asarray(infos["iterations"])
    conv = np.asarray(infos["converged"])
    rec = {
        "pairs_per_sec": round(50 / solve_s, 3),
        "iterations_median": int(np.median(iters)),
        "iterations_max": int(iters.max()),
        "converged_pairs": f"{int(conv.sum())}/{conv.size}",
        "compile_s": round(compile_s, 1),
    }
    if _remaining() > 240:
        try:
            u_ref = _direct_f64_fields(movie, 1)
            ref1 = jax.device_put(jnp.asarray(u_ref, jnp.float32))
            d = all_u[1] - ref1
            rec["epe_px_vs_f64_direct_pair1"] = float(
                jnp.sqrt(d[0] ** 2 + d[1] ** 2)[1:-1, 1:-1].max())
        except Exception as err:  # noqa: BLE001
            rec["epe_px_vs_f64_direct_pair1"] = f"oracle failed: {type(err).__name__}"
    RESULT.setdefault("reference_scale", {})["stack_50pairs_512x512"] = rec
    _log(f"50x512^2: {rec}")


def sweep_section():
    """BASELINE config-5 analogue: a 300-solve regularisation sweep as one
    batched on-device computation (ref
    analyse_variational_optical_flow.py:292-296)."""
    from opticalflow_tpu.analysis.sweeps import vary_regularisation
    from opticalflow_tpu.core.types import SolverConfig

    movie, _ = make_movie(2, 128, np.float64)
    movie32 = np.asarray(movie, np.float32)
    a_s = np.logspace(1, 5, 15)
    a_r = np.logspace(1, 5, 20)
    cfg = SolverConfig(rtol=RTOL)
    vary_regularisation(movie32, a_s, a_r, batched=True, solver=cfg)  # compile
    t0 = time.perf_counter()
    res = vary_regularisation(movie32 + 1e-4, a_s, a_r, batched=True, solver=cfg)
    dt = time.perf_counter() - t0
    n_solves = len(a_s) * len(a_r)
    rec = {
        "n_solves": n_solves,
        "grid": f"{len(a_s)}x{len(a_r)} alphas, 128^2, 1 pair",
        "solves_per_sec": round(n_solves / dt, 2),
        "converged_cells": f"{int(np.sum(res['converged']))}/{n_solves}",
    }
    RESULT.setdefault("reference_scale", {})["sweep_300_solves_128x128"] = rec
    _log(f"sweep: {rec}")


def main():
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {device.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    peak_gbps = device_peaks(device.device_kind)["hbm_gbps"]

    from opticalflow_tpu.utils import compile_cache

    _install_safety()
    _stamp("start")
    cache_dir = compile_cache.enable()
    try:
        RESULT["cache_entries_before"] = len(os.listdir(cache_dir))
    except OSError:
        RESULT["cache_entries_before"] = 0
    RESULT["platform"] = device.platform
    RESULT["device_kind"] = device.device_kind
    _stamp("backend_ready")

    movie, _ = make_movie(N_PAIRS + 1, DIM, np.float64)
    worker = HostWorker(movie)
    worker.start()
    _stamp("movie_ready")

    u_single, all_u = None, None
    try:
        u_single = single_pair_stage(movie)
    except Exception as err:  # noqa: BLE001 — keep going; batch can still land
        RESULT.setdefault("section_errors", {})["single_pair"] = repr(err)
        _log(f"ERROR in single_pair: {err!r}")

    try:
        all_u = batched_stage(movie)
    except Exception as err:  # noqa: BLE001
        RESULT.setdefault("section_errors", {})["batched"] = repr(err)
        _log(f"ERROR in batched: {err!r}")

    epe_stage(worker, u_single, all_u)
    baseline_stage(worker, movie)

    # extended sections in priority order; each starts only while budget
    # remains (their cost on the GPU is not measured yet, so there are no
    # per-section estimates), and the alarm emits the JSON if one overruns
    skipped = []
    for name, fn in (
        ("stencil_kernel", lambda: stencil_bandwidth_section(movie, peak_gbps)),
        ("embryo_1024", embryo_1024_section),
        ("sweep_300", sweep_section),
        ("stack_512", stack_512_section),
    ):
        if _remaining() <= 0:
            skipped.append(name)
            _log(f"SKIP {name}: budget spent")
            continue
        try:
            fn()
        except Exception as err:  # noqa: BLE001 — never lose the core metric
            RESULT.setdefault("section_errors", {})[name] = repr(err)
            _log(f"ERROR in {name}: {err!r}")
        # drop cached executables + live buffers between sections — the
        # 1024^2 and 50x512^2 sections each pin multi-GB Krylov bases
        jax.clear_caches()
        _stamp(f"section_{name}_done")
    if skipped:
        RESULT["skipped_budget"] = skipped

    try:
        RESULT["cache_entries_after"] = len(os.listdir(cache_dir))
    except OSError:
        pass
    RESULT["elapsed_s"] = round(time.time() - _T0, 1)
    _stamp("end")
    print(json.dumps(RESULT), flush=True)


def _selfcheck():
    """Harness self-check (no device, no jax): exercises the stage-stamp,
    budget, and signal-safety machinery end to end so the un-killable
    contract is testable in the suite.

    With ``BENCH_SELFCHECK_SLEEP`` set, sleeps after the stub value is
    recorded — the test sends SIGTERM mid-sleep and asserts the emitted
    JSON carries the value, the stages, and ``interrupted_at_s``.
    """
    _install_safety()
    _stamp("start")
    RESULT["value"] = 1.0
    RESULT["value_stage"] = "selfcheck_stub"
    _stamp("stub_value_set")
    time.sleep(float(os.environ.get("BENCH_SELFCHECK_SLEEP", "0")))
    skipped = []
    for name, est in (("cheap", 1), ("too_expensive", 10 ** 9)):
        if _remaining() < est:
            skipped.append(name)
            continue
        _stamp(f"section_{name}_done")
    RESULT["skipped_budget"] = skipped
    RESULT["elapsed_s"] = round(time.time() - _T0, 1)
    _stamp("end")
    print(json.dumps(RESULT), flush=True)


if __name__ == "__main__":
    if "--selfcheck" in sys.argv:
        _selfcheck()
    else:
        main()
