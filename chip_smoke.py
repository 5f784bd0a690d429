"""Proof that the engine's main path runs on an NVIDIA GPU.

Drives the public API end to end in ONE process, on one card, and checks
every result against an oracle:

* ``embryo_1024``  — a 3-frame 1024^2 movie through ``variational_optical_flow``
  with the public defaults (f32, x64 off), against the engine's own f64
  FGMRES solve (rtol 1e-10) run on the card;
* ``batch_256``    — the bench's 12-pair 256^2 two-pass batch, against
  per-pair f64 direct solves (scipy, host) of pairs 1, 6 and 11;
* ``box_and_blur`` — box-method flow recovers a known translation, and the
  f32 Gaussian blur matches scipy's f64 filter;
* ``sweep``        — the 15x20 regularisation sweep at 128^2, three cells
  against serial ``batched=False`` solves;
* ``df32``         — the error-free transforms stay exact as the GPU
  compiles them, and the double-float residual beats plain f32;
* ``matvec``       — the XLA-compiled stencil's time per application.

The first call of every solve runs in its own thread, so that their XLA
compiles overlap (compilation releases the GIL) and the run fits its time
limit; the f64 oracles run beside them with x64 switched on for their
thread only.  The timed second calls then run one at a time.  Every phase
prints one JSON line of numbers: the card's name and power limit, the
first call's seconds (tracing, compilation and one execution, overlapped
with the other first calls) apart from the second call's, and the
device's peak bytes in use so far.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed check raises, so the process exits non-zero without it.  On any
backend other than a GPU it exits non-zero before the first phase.

    python3 chip_smoke.py               # the phases above, one card
    python3 chip_smoke.py --four-cards  # only the sharded solves, 4 cards

Run it alone on the card: a second JAX process there fails for want of
device memory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import bench
from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.utils import compile_cache

EPE_TARGET_PX = 1e-3  # BASELINE.md config 2
ALPHA = 1000.0  # speed and remodelling alpha (ref analyse_variational_optical_flow.py)
EMBRYO_DX, EMBRYO_DT = 105.0 / 1024.0, 10.0  # ref analyse_variational_optical_flow.py:203-205
BATCH_ORACLE_PAIRS = (1, 6, 11)
BLUR_SIGMA = 3.0
BLUR_RTOL = 1e-5  # f32 sums of ~25 taps; TF32 (~1e-3) would fail it
BOX_TRUTH, BOX_TOL = (0.15, 0.10), 3e-3  # median recovery of a blob's translation


class Reporter:
    """Prints one JSON line per phase, each naming the card."""

    def __init__(self, card, devices):
        self.card = card
        self.devices = devices

    def peak_bytes(self):
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in self.devices]
        return peaks[0] if len(peaks) == 1 else peaks

    def __call__(self, phase, **numbers):
        line = {"phase": phase, "card": self.card, **numbers,
                "peak_bytes_in_use": self.peak_bytes()}
        print(json.dumps(line), flush=True)


def check(ok, message):
    if not ok:
        raise AssertionError(message)


def require_gpu(devices):
    """The card the run measures; exits non-zero on any other backend."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "no device"
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {kind!r}")
    return devices[0]


def result_line(devices):
    """The contract's last line, with the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def card_info():
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    check(lines, "nvidia-smi reported no card")
    return lines


def timed(fn):
    """(result, seconds) of one call, waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def first_calls(calls):
    """Run every call once, each in its own thread, and return
    ``{name: (result, seconds)}``; a failed call re-raises here."""
    with ThreadPoolExecutor(max_workers=len(calls)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in calls.items()}
        return {name: f.result() for name, f in futures.items()}


def max_epe(u, u_ref):
    """Largest interior endpoint error (px) of (..., 3|2, X, Y) fields."""
    u = np.asarray(u, np.float64)[..., :2, 1:-1, 1:-1]
    u_ref = np.asarray(u_ref, np.float64)[..., :2, 1:-1, 1:-1]
    return float(np.sqrt(np.sum((u - u_ref) ** 2, axis=-3)).max())


def pixel_flow(res, delta_x, delta_t):
    """(pairs, 2, X, Y) velocities of a FlowResult in pixels per frame."""
    return np.stack([res["v_x"], res["v_y"]], axis=1) * (delta_t / delta_x)


# ---------------------------------------------------------------------------
# The calls users make (f32, x64 off) and the oracles they are held to.
# ---------------------------------------------------------------------------


def embryo_call(movie):
    from opticalflow_tpu import variational_optical_flow

    return lambda: variational_optical_flow(
        movie, delta_x=EMBRYO_DX, delta_t=EMBRYO_DT, speed_alpha=ALPHA,
        remodelling_alpha=ALPHA, dtype=np.float32)


def batch_call(movie):
    from opticalflow_tpu import variational_optical_flow

    return lambda: variational_optical_flow(
        movie, speed_alpha=ALPHA, remodelling_alpha=ALPHA,
        warm_start="two-pass", dtype=np.float32)


def box_movie(dim):
    movie, delta_x = make_translating_blob_movie(
        n_frames=4, dimension=dim, width=20.0, sigma=3.0, v_x=BOX_TRUTH[0],
        v_y=BOX_TRUTH[1], dtype=np.float32)
    return np.asarray(movie * 100.0, np.float32), delta_x


def sweep_grid(n_s, n_r):
    return np.logspace(1, 5, n_s), np.logspace(1, 5, n_r)


def sweep_calls(movie, a_s, a_r):
    from opticalflow_tpu.analysis.sweeps import vary_regularisation

    return {
        "sweep": lambda: vary_regularisation(movie, a_s, a_r, batched=True),
        "sweep_serial": lambda: vary_regularisation(
            movie, a_s[:1], a_r[:1], batched=False),
    }


def f64_oracle(movie):
    """The engine's own f64 FGMRES (rtol 1e-10, no refinement) per pair, in
    this thread only with x64 on; returns ``(fields, converged, seconds)``."""
    import jax
    import jax.numpy as jnp

    from opticalflow_tpu.flow.variational import solve_frame_pair

    t0 = time.perf_counter()
    with jax.enable_x64(True):
        solve = jax.jit(lambda p, c, u0: solve_frame_pair(
            p, c, u0, ALPHA, ALPHA, method="gmres", rtol=1e-10,
            refinement_restarts=0))
        u0 = jnp.zeros((3,) + movie.shape[1:], jnp.float64)
        refs, ok = [], []
        for k in range(movie.shape[0] - 1):
            u_ref, info = solve(jnp.asarray(movie[k]), jnp.asarray(movie[k + 1]), u0)
            refs.append(np.asarray(u_ref))
            ok.append(bool(info["converged"]))
    return refs, ok, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Single-card phases: each takes its first call's (result, seconds), makes
# the timed second call, reports and checks.
# ---------------------------------------------------------------------------


def embryo_1024(report, movie, call, first, oracle):
    res, run_s = timed(call)
    flow = pixel_flow(res, EMBRYO_DX, EMBRYO_DT)
    iterations = [int(k) for k in res["iterations"]]
    converged = [bool(c) for c in res["converged_all"]]
    refs, oracle_ok, oracle_s = oracle
    epes = [max_epe(flow[k], refs[k]) for k in range(len(refs))]
    report("embryo_1024", frames="x".join(map(str, movie.shape)),
           compile_s=first[1], run_s=run_s, iterations=iterations,
           converged=converged,
           us_per_krylov_iteration=1e6 * run_s / sum(iterations),
           epe_px=epes, oracle_converged=oracle_ok, oracle_s=oracle_s)
    check(all(oracle_ok), "f64 oracle did not converge")
    check(all(converged), f"pairs not converged: {converged}")
    check(max(epes) < EPE_TARGET_PX, f"EPE {epes} px >= {EPE_TARGET_PX}")


def batch_256(report, movie, call, first, oracles):
    res, run_s = timed(call)
    flow = pixel_flow(res, 1.0, 1.0)
    converged = np.asarray(res["converged_all"])
    epes = {k: max_epe(flow[k], oracles[k].result()) for k in oracles}
    n_pairs = movie.shape[0] - 1
    report("batch_256", frames="x".join(map(str, movie.shape)),
           warm_start="two-pass", compile_s=first[1], run_s=run_s,
           pairs_per_s=n_pairs / run_s,
           iterations=[int(k) for k in res["iterations"]],
           converged=f"{int(converged.sum())}/{converged.size}",
           epe_px={str(k): v for k, v in epes.items()})
    check(converged.all(), f"converged {converged}")
    check(max(epes.values()) < EPE_TARGET_PX, f"EPE {epes} px")


def box_and_blur(report, movie, box, blur, firsts):
    import scipy.ndimage

    res, box_run_s = timed(box)
    support = movie[1:] > 5.0  # where the blob has signal (5% of its peak)
    v_med = (float(np.median(res["v_x"][support])),
             float(np.median(res["v_y"][support])))
    blurred, blur_run_s = timed(blur)
    want = scipy.ndimage.gaussian_filter(
        movie.astype(np.float64), sigma=(0, BLUR_SIGMA, BLUR_SIGMA),
        mode="nearest", truncate=4.0)
    blur_err = float(np.abs(np.asarray(blurred, np.float64) - want).max()
                     / np.abs(want).max())
    report("box_and_blur", frames="x".join(map(str, movie.shape)),
           box_compile_s=firsts["box"][1], box_run_s=box_run_s,
           median_v=v_med, truth_v=BOX_TRUTH,
           blur_compile_s=firsts["blur"][1], blur_run_s=blur_run_s,
           blur_max_rel_err=blur_err, blur_rtol=BLUR_RTOL)
    check(all(abs(v - t) < BOX_TOL for v, t in zip(v_med, BOX_TRUTH)),
          f"box flow median {v_med} vs {BOX_TRUTH}")
    check(blur_err < BLUR_RTOL, f"blur error {blur_err:.2e} vs scipy")


def sweep(report, movie, a_s, a_r, calls, firsts):
    from opticalflow_tpu.analysis.sweeps import vary_regularisation

    res, run_s = timed(calls["sweep"])
    conv = np.asarray(res["converged"])
    picked = np.flatnonzero(conv.ravel())
    picked = picked[[0, len(picked) // 2, -1]] if len(picked) else picked
    cells = []
    for flat in picked:
        i, j = np.unravel_index(flat, conv.shape)
        serial = vary_regularisation(movie, a_s[i:i + 1], a_r[j:j + 1], batched=False)
        cells.append({
            "cell": [int(i), int(j)],
            "serial_converged": bool(serial["converged"][0, 0]),
            # speed in px/frame (delta_x = delta_t = 1): a mean moves by at
            # most the max EPE, so the EPE target bounds the difference
            "speed_mean_diff_px": float(abs(serial["speed_means"][0, 0]
                                            - res["speed_means"][i, j])),
            "remodelling_mean_diff": float(abs(serial["remodelling_means"][0, 0]
                                               - res["remodelling_means"][i, j])),
        })
    report("sweep", grid=f"{len(a_s)}x{len(a_r)}", frames="x".join(map(str, movie.shape)),
           compile_s=firsts["sweep"][1], run_s=run_s,
           solves_per_s=len(a_s) * len(a_r) / run_s,
           converged_cells=f"{int(conv.sum())}/{conv.size}", compared=cells)
    check(len(cells) == 3, "fewer than 3 converged cells to compare")
    for c in cells:
        check(c["serial_converged"], f"serial solve not converged: {c}")
        check(c["speed_mean_diff_px"] < EPE_TARGET_PX, f"batched vs serial: {c}")


def df32_phase(report, movie, u_ref):
    """At a near-solution iterate (the f64 oracle's, rounded to f32) the
    residual is a cancellation plain f32 cannot resolve; the df32 residual
    must land at least 100x closer to the f64 one.  Also checks on the card
    that two_sum / two_prod stay exact as the GPU compiles them."""
    import jax
    import jax.numpy as jnp

    from opticalflow_tpu.ops import df32, elop

    rng = np.random.default_rng(0)
    n = 1 << 20
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    s, e = jax.jit(df32.two_sum)(jnp.asarray(a), jnp.asarray(b))
    p, f = jax.jit(df32.two_prod)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    inexact_sum = int(np.sum(np.asarray(s, np.float64) + np.asarray(e) != a64 + b64))
    inexact_prod = int(np.sum(np.asarray(p, np.float64) + np.asarray(f) != a64 * b64))

    prev32, cur32 = (jnp.asarray(movie[k], jnp.float32) for k in (0, 1))
    s32 = jnp.max(jnp.abs(prev32))
    scale = float(s32)
    x_norm = np.concatenate([u_ref[:2], u_ref[2:] / scale])[:, 1:-1, 1:-1]
    x_hi = jnp.asarray(x_norm, jnp.float32)

    @jax.jit
    def residuals(prev, cur, x):
        dfd = elop.compute_frame_pair_data_df(
            prev, cur, jnp.float32(ALPHA), ALPHA, "compat", s32)
        r_df = elop.el_residual_df(dfd, x, jnp.zeros_like(x))
        pair = elop.compute_frame_pair_data(
            prev / s32, cur / s32, jnp.float32(ALPHA) / s32**2, ALPHA, "compat")
        r32 = pair.rhs[:, 1:-1, 1:-1] - elop.el_matvec_reduced(pair.coeffs, x)
        return r_df, r32

    r_df, r32 = residuals(prev32, cur32, x_hi)
    check(r_df.dtype == jnp.float32 and r32.dtype == jnp.float32, "residuals left f32")
    with jax.enable_x64(True):
        pair64 = elop.compute_frame_pair_data(
            jnp.asarray(movie[0]) / scale, jnp.asarray(movie[1]) / scale,
            ALPHA / scale**2, ALPHA, "compat")
        x64 = jnp.asarray(np.asarray(x_hi, np.float64))
        r64 = np.asarray(pair64.rhs[:, 1:-1, 1:-1] - elop.el_matvec_reduced(
            pair64.coeffs, x64))
    err_df = float(np.linalg.norm(np.asarray(r_df, np.float64) - r64))
    err_32 = float(np.linalg.norm(np.asarray(r32, np.float64) - r64))
    report("df32", size=f"{movie.shape[1]}x{movie.shape[2]}",
           residual_norm_f64=float(np.linalg.norm(r64)),
           err_df32=err_df, err_plain_f32=err_32, improvement=err_32 / err_df,
           two_sum_inexact=inexact_sum, two_prod_inexact=inexact_prod, samples=n)
    check(inexact_sum == 0 and inexact_prod == 0,
          f"error-free transforms inexact: {inexact_sum} sums, {inexact_prod} products")
    check(err_df * 100.0 <= err_32, f"df32 {err_df:.3e} vs f32 {err_32:.3e}")


def matvec(report, peak_gbps, shapes=((256, 12), (1024, 4)), reps=3):
    """us per application of the XLA-compiled stencil, chained in one
    jitted scan, and its bytes/s on the 19-plane traffic model (13
    coefficient planes + 3 in + 3 out)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from opticalflow_tpu.ops import elop

    readings = []
    for dim, batch in shapes:
        movie, _ = bench.make_movie(batch + 1, dim, np.float64)
        frames = jnp.asarray(movie, jnp.float32)

        def coeffs_of(prev, cur):
            s = jnp.max(jnp.abs(prev))
            return elop.compute_frame_pair_data(
                prev / s, cur / s, ALPHA / s**2, ALPHA, "compat").coeffs

        coeffs = jax.jit(jax.vmap(coeffs_of))(frames[:-1], frames[1:])
        x0 = jnp.ones((batch, 3, dim - 2, dim - 2), jnp.float32)
        n_apps = 500 if dim <= 256 else 100

        @jax.jit
        def chain(c, x):
            apply = jax.vmap(elop.el_matvec_reduced)

            def body(x, _):
                return 0.1 * apply(c, x), None

            return lax.scan(body, x, None, length=n_apps)[0]

        jax.block_until_ready(chain(coeffs, x0))
        best = min(timed(lambda: chain(coeffs, x0))[1] for _ in range(reps))
        per_app = best / n_apps
        gbytes = batch * 19 * (dim - 2) ** 2 * 4 / 1e9
        readings.append({"shape": f"{batch}x{dim}x{dim}", "applications": n_apps,
                         "us_per_application": per_app * 1e6,
                         "gbps_19_plane_model": gbytes / per_app,
                         "fraction_of_peak": gbytes / per_app / peak_gbps})
    report("matvec", peak_gbps=peak_gbps, readings=readings)


def single_card(report, peak_gbps, embryo_dim=1024, batch_dim=256, n_pairs=12,
                box_dim=256, sweep_dim=128, grid=(15, 20),
                matvec_shapes=((256, 12), (1024, 4))):
    embryo = bench.make_movie(3, embryo_dim, np.float64)[0]
    batch = bench.make_movie(n_pairs + 1, batch_dim, np.float64)[0]
    box, box_dx = box_movie(box_dim)
    sweep_movie = bench.make_movie(2, sweep_dim, np.float64)[0].astype(np.float32)
    a_s, a_r = sweep_grid(*grid)

    from opticalflow_tpu import conduct_optical_flow
    from opticalflow_tpu.ops.blur import blur_movie

    calls = {
        "embryo_1024": embryo_call(embryo),
        "batch_256": batch_call(batch),
        "box": lambda: conduct_optical_flow(box, boxsize=15, delta_x=box_dx),
        "blur": lambda: blur_movie(box, smoothing_sigma=BLUR_SIGMA),
        **sweep_calls(sweep_movie, a_s, a_r),
    }
    with ThreadPoolExecutor(max_workers=2) as oracles:
        # f64 oracles beside the first calls: host direct solves, and the
        # engine's f64 mode on the card with x64 on in its thread only
        embryo_oracle = oracles.submit(f64_oracle, embryo)
        batch_oracles = {k: oracles.submit(bench._direct_f64_fields, batch, k)
                         for k in BATCH_ORACLE_PAIRS}
        firsts = first_calls(calls)
        embryo_ref = embryo_oracle.result()

    embryo_1024(report, embryo, calls["embryo_1024"], firsts["embryo_1024"], embryo_ref)
    batch_256(report, batch, calls["batch_256"], firsts["batch_256"], batch_oracles)
    box_and_blur(report, box, calls["box"], calls["blur"], firsts)
    sweep(report, sweep_movie, a_s, a_r, calls, firsts)
    df32_phase(report, embryo, embryo_ref[0][0])
    matvec(report, peak_gbps, matvec_shapes)


# ---------------------------------------------------------------------------
# Four cards: only the sharded solves, each against one card's solve.
# ---------------------------------------------------------------------------


def four_cards(report, devices, frames_dim=512, n_pairs=8, tile_dim=1024):
    from opticalflow_tpu.parallel import mesh as mesh_lib
    from opticalflow_tpu.parallel.batch import sharded_variational_solve

    single = mesh_lib.make_mesh(devices[:1], frames=1, tx=1, ty=1)
    cases = {
        "frames": (mesh_lib.make_mesh(devices, frames=4, tx=1, ty=1),
                   bench.make_movie(n_pairs + 1, frames_dim, np.float64)[0]),
        "tiles": (mesh_lib.make_mesh(devices, frames=1, tx=2, ty=2),
                  bench.make_movie(2, tile_dim, np.float64)[0]),
    }

    def solve(mesh, movie):
        return lambda: sharded_variational_solve(
            movie, mesh=mesh, speed_alpha=ALPHA, remodelling_alpha=ALPHA)

    calls = {}
    for name, (mesh, movie) in cases.items():
        calls[(name, "sharded")] = solve(mesh, movie)
        calls[(name, "single")] = solve(single, movie)
    firsts = first_calls(calls)

    failures = []
    for name, (mesh, movie) in cases.items():
        (u_s, info_s), s_run = timed(calls[(name, "sharded")])
        (u_1, info_1), o_run = timed(calls[(name, "single")])
        epe = max_epe(u_s, u_1)
        conv_s = np.asarray(info_s["converged"])
        conv_1 = np.asarray(info_1["converged"])
        report("four_cards", case=name, mesh=dict(mesh.shape),
               frames="x".join(map(str, movie.shape)),
               sharded_compile_s=firsts[(name, "sharded")][1], sharded_run_s=s_run,
               single_compile_s=firsts[(name, "single")][1], single_run_s=o_run,
               epe_px_vs_single_card=epe,
               converged_sharded=f"{int(conv_s.sum())}/{conv_s.size}",
               converged_single=f"{int(conv_1.sum())}/{conv_1.size}")
        if not (conv_s.all() and conv_1.all() and epe < EPE_TARGET_PX):
            failures.append(name)
    check(not failures, f"four-card cases failed: {failures}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded solves, on four cards")
    args = parser.parse_args(argv)

    compile_cache.enable()
    import jax

    device = require_gpu(jax.devices())
    devices = jax.devices()[:4] if args.four_cards else [device]
    check(len(devices) == (4 if args.four_cards else 1),
          f"found {len(jax.devices())} cards")
    cards = card_info()
    for line in cards:
        print(line, flush=True)
    print(f"device_kind: {device.device_kind}", flush=True)
    print(f"jax {jax.__version__}", flush=True)
    report = Reporter("; ".join(cards[: len(devices)]), devices)

    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(report, devices)
    else:
        single_card(report, bench.device_peaks(device.device_kind)["hbm_gbps"])
    print(f"wall_s {time.perf_counter() - t0:.1f}", flush=True)
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
