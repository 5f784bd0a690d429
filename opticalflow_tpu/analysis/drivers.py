"""Analysis drivers — the engine's "CLI" layer.

The reference drives experiments by (un)commenting calls in the
``__main__`` blocks of three scripts
(/root/reference/analysis/analyse_variational_optical_flow.py:729-755,
analyse_short_timeinterval_data.py:819-833, compare_rho_and_actin.py:955-999).
Here each experiment is a parameterised function plus one argparse CLI
(``python -m opticalflow_tpu.analysis.drivers <experiment> ...``).

Experiments mirroring the reference scripts (all registered as CLI
subcommands in :func:`main`):
* ``synthetic-boundary``   — simple_test_with_data_on_boundary (:26-66)
* ``synthetic-big``        — test_big_fake_data (:68-112), size configurable
* ``synthetic-box-error``  — check_error_of_method (compare_rho_and_actin.py:302-375)
* ``variational``          — apply_to_bischoff_data-style run on a TIFF/sequence
* ``box``                  — production box-method run (compare_rho_and_actin.py:616-639)
* ``sweep``                — regularisation sweep + heatmaps (:181-199, 274-303)
* ``tune``                 — shgo regularisation optimization (:617-724)
* ``downsampled``          — apply_to_downsampled_bischoff_data (:526-615)
* ``boxsize-sweep``        — make_boxsize_analysis (compare_rho_and_actin.py:377-483)
* ``blursize-sweep``       — make_OF_blur_analysis (compare_rho_and_actin.py:485-614)
* ``dual-channel``         — joint Rho/actin comparison (compare_rho_and_actin.py:616-767)
* ``piv-compare``          — PIV vs flow comparison (analyse_short_timeinterval_data.py:505-638)
* ``ground-truth``         — hand-clicked displacement validation (:128-239, 640-745)
* ``intensity-histograms`` — raw+blurred intensity histograms w/ thresholds (compare_rho_and_actin.py:98-119, 200-226)
* ``threshold-movies``     — thresholded/CLAHE channel overlay movies (:228-300)
* ``coexpression``         — red/green coexpression movie + speed histograms (:772-849)
* ``vortex-pair``          — figure-producing vortex-pair experiment (analyse_variational_optical_flow.py:114-179)

``variational``, ``piv-compare`` and ``ground-truth`` accept
``--correct-intensity`` to apply the global illumination-change
correction before solving (analyse_short_timeinterval_data.py:395-469).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from opticalflow_tpu.analysis.statistics import ground_truth_error_statistics
from opticalflow_tpu.analysis.sweeps import vary_regularisation
from opticalflow_tpu.analysis.tuning import optimize_regularisation_parameters
from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.core.types import FlowResult
from opticalflow_tpu.flow.boxflow import conduct_optical_flow
from opticalflow_tpu.flow.variational import variational_optical_flow
from opticalflow_tpu.ops.resize import downsample_movie


def _load_movie(path: str, dtype=np.float64) -> np.ndarray:
    from opticalflow_tpu.io.sequences import read_image_sequence_as_movie, read_tiff_movie

    if os.path.isdir(path):
        return read_image_sequence_as_movie(path, dtype=dtype)
    return read_tiff_movie(path, dtype=dtype)


def run_synthetic_boundary(output_dir: str, dimension: int = 100,
                           speed_alpha: float = 1e4, remodelling_alpha: float = 1e4):
    """Blob translating through the domain (data touching the boundary),
    variational solve + overlay movie (ref analyse_variational_optical_flow.py:26-66)."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=dimension, width=20.0, sigma=5.0, v_x=0.2, v_y=0.0,
        start=(2.0, 10.0),
    )
    movie = np.asarray(movie) * 255.0
    result = variational_optical_flow(
        movie, delta_x=delta_x, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha,
    )
    os.makedirs(output_dir, exist_ok=True)
    result.save(os.path.join(output_dir, "synthetic_boundary_result.npy"))
    from opticalflow_tpu.viz.plots import make_joint_overlay_movie

    make_joint_overlay_movie(
        result, os.path.join(output_dir, "synthetic_boundary.mp4"),
        autoscale=True, arrow_boxsize=max(4, dimension // 25), dpi=150,
    )
    return result


def run_synthetic_box_error(output_dir: str, include_noise: bool = False,
                            dimension: int = 256):
    """Box-method accuracy vs known velocities (v_x=0.1, v_y=0.2), with
    histograms (ref compare_rho_and_actin.py:302-375)."""
    x_velocity, y_velocity, delta_t = 0.1, 0.2, 0.5
    movie, delta_x = make_translating_blob_movie(
        n_frames=5, dimension=dimension, width=20.0, sigma=1.0,
        v_x=x_velocity * delta_t, v_y=y_velocity * delta_t, start=(5.0, 3.0),
        include_noise=include_noise,
    )
    result = conduct_optical_flow(np.asarray(movie), boxsize=15, delta_x=delta_x,
                                  delta_t=delta_t, dtype=np.float64)
    stats = ground_truth_error_statistics(result, x_velocity, y_velocity)
    os.makedirs(output_dir, exist_ok=True)
    suffix = "_with_noise" if include_noise else "_without_noise"
    result.save(os.path.join(output_dir, f"fake_flow_result{suffix}.npy"))

    import matplotlib.pyplot as plt

    plt.figure(figsize=(4.5, 2.5))
    for k, (key, truth) in enumerate([("v_x", x_velocity), ("v_y", y_velocity)]):
        plt.subplot(1, 2, k + 1)
        finite = np.asarray(result[key])
        finite = finite[np.isfinite(finite)]
        plt.hist(finite.ravel(), bins=100)
        plt.axvline(truth, color="red", lw=0.2)
        plt.xlabel(f"$\\mathrm{{{key}}}$ values")
        plt.ylabel("Number of Pixels")
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, f"fake_v_histogram{suffix}.pdf"))
    plt.close()
    print("ground-truth error statistics:", stats)
    return result, stats


def run_variational(movie_path: str, output_dir: str, delta_x: float = 1.0,
                    delta_t: float = 1.0, speed_alpha: float = 1000.0,
                    remodelling_alpha: float = 1000.0,
                    smoothing_sigma: Optional[float] = None,
                    frames: Optional[str] = None, downsample: Optional[float] = None,
                    correct_intensity: bool = False):
    """Full variational run on a movie file/folder (the
    apply_to_bischoff_data workload, ref analyse_variational_optical_flow.py:201-272,
    with optional INTER_AREA downsampling, :526-615).

    ``correct_intensity`` applies the global illumination-change
    correction before solving, matching the reference's corrected-data
    variational runs (ref analyse_short_timeinterval_data.py:395-469)."""
    movie = _load_movie(movie_path)
    if frames:
        start, stop = (int(x) for x in frames.split(":"))
        movie = movie[start:stop]
    if correct_intensity:
        from opticalflow_tpu.analysis.statistics import correct_intensity_change

        movie = correct_intensity_change(movie)
    if downsample:
        movie = np.asarray(downsample_movie(movie, downsample))
        delta_x = delta_x / downsample
    result = variational_optical_flow(
        movie, delta_x=delta_x, delta_t=delta_t, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha, smoothing_sigma=smoothing_sigma,
    )
    os.makedirs(output_dir, exist_ok=True)
    result.save(os.path.join(output_dir, "variational_result.npy"))
    from opticalflow_tpu.viz.plots import make_joint_overlay_movie

    make_joint_overlay_movie(result, os.path.join(output_dir, "variational_joint.mp4"),
                             autoscale=True, dpi=150)
    return result


def run_box(movie_path: str, output_dir: str, delta_x: float = 0.0913,
            delta_t: float = 10.0, boxsize: int = 31, smoothing_sigma: float = 3.0,
            include_remodelling: bool = False):
    """Production box-method run (ref compare_rho_and_actin.py:616-639
    defaults: boxsize=31, sigma=3, actin/Rho pixel geometry :21-22)."""
    movie = _load_movie(movie_path)
    result = conduct_optical_flow(
        movie, boxsize=boxsize, delta_x=delta_x, delta_t=delta_t,
        smoothing_sigma=smoothing_sigma, include_remodelling=include_remodelling,
    )
    os.makedirs(output_dir, exist_ok=True)
    result.save(os.path.join(output_dir, "box_flow_result.npy"))
    return result


def run_sweep(movie_path: str, output_dir: str, delta_x: float = 1.0,
              delta_t: float = 1.0, alphas: str = "500,1000,1500",
              remodelling_alphas: Optional[str] = None, log_axes: bool = False,
              frames: Optional[str] = None):
    movie = _load_movie(movie_path)
    if frames:
        start, stop = (int(x) for x in frames.split(":"))
        movie = movie[start:stop]
    speed_values = np.array([float(x) for x in alphas.split(",")])
    rem_values = (
        np.array([float(x) for x in remodelling_alphas.split(",")])
        if remodelling_alphas else speed_values
    )
    os.makedirs(output_dir, exist_ok=True)
    result = vary_regularisation(
        movie, speed_values, rem_values, delta_x=delta_x, delta_t=delta_t,
        filename=os.path.join(output_dir, "regularisation_sweep.npy"),
    )
    from opticalflow_tpu.viz.plots import plot_regularisation_variation

    plot_regularisation_variation(
        result, os.path.join(output_dir, "regularisation_sweep.pdf"),
        use_log_axes=log_axes, use_log_colorbar=log_axes,
    )
    return result


def run_tune(movie_path: str, output_dir: str, delta_x: float = 1.0,
             delta_t: float = 1.0, resolution: int = 150,
             smoothing_sigma: float = 1.0, frames: Optional[str] = None):
    """shgo regularisation tuning on a downsampled movie
    (ref analyse_variational_optical_flow.py:617-724 semantics: INTER_AREA
    downsample to `resolution`, direct solver, log10 bounds)."""
    movie = _load_movie(movie_path)
    if frames:
        start, stop = (int(x) for x in frames.split(":"))
        movie = movie[start:stop]
    from opticalflow_tpu.ops.resize import area_resize_movie

    scaled_delta_x = movie.shape[1] / resolution * delta_x
    movie_small = np.asarray(area_resize_movie(movie, resolution, resolution))
    optimal, value, opt = optimize_regularisation_parameters(
        movie_small, delta_x=scaled_delta_x, delta_t=delta_t,
        smoothing_sigma=smoothing_sigma, initial_v_x=0.07, initial_v_y=0.07,
        initial_remodelling=10.0, use_direct_solver=True, verbose=True,
    )
    print("Optimal regularisation:", optimal)
    print("Minimum value:", value)
    print("Number of function evaluations:", opt.nfev)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, "optimal_regularisation.npy"),
            {"optimal": optimal, "functional": value, "nfev": opt.nfev})
    return optimal, value


def run_synthetic_big(output_dir: str, dimension: int = 1000,
                      speed_alpha: float = 1e4, remodelling_alpha: float = 1e4):
    """Large fake-data variational run (ref
    analyse_variational_optical_flow.py:68-112 ``test_big_fake_data``:
    1000^2 blob movie, full solve, overlay movie + summary stats)."""
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=dimension, width=20.0, sigma=5.0, v_x=0.2, v_y=0.0,
        start=(10.0, 10.0),
    )
    movie = np.asarray(movie) * 255.0
    result = variational_optical_flow(
        movie, delta_x=delta_x, speed_alpha=speed_alpha,
        remodelling_alpha=remodelling_alpha,
    )
    os.makedirs(output_dir, exist_ok=True)
    result.save(os.path.join(output_dir, "synthetic_big_result.npy"))
    print("mean speed:", float(np.nanmean(result["speed"])),
          "max speed:", float(np.nanmax(result["speed"])),
          "converged:", result["converged"])
    from opticalflow_tpu.viz.plots import make_joint_overlay_movie

    make_joint_overlay_movie(
        result, os.path.join(output_dir, "synthetic_big.mp4"),
        autoscale=True, arrow_boxsize=max(4, dimension // 25), dpi=100,
    )
    return result


def run_boxsize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                      delta_t: float = 10.0, boxsizes: str = "5:150:2",
                      smoothing_sigma: float = 1.3, frame_index: int = 3):
    """Box-size sensitivity sweep (ref compare_rho_and_actin.py:377-483),
    batched on device (analysis.hyperparams)."""
    from opticalflow_tpu.analysis.hyperparams import vary_boxsize
    from opticalflow_tpu.viz.plots import plot_parameter_sweep_summary

    movie = _load_movie(movie_path)
    start, stop, step = (int(x) for x in boxsizes.split(":"))
    os.makedirs(output_dir, exist_ok=True)
    sweep = vary_boxsize(
        movie, boxsizes=np.arange(start, stop, step), frame_index=frame_index,
        delta_x=delta_x, delta_t=delta_t, smoothing_sigma=smoothing_sigma,
        filename=os.path.join(output_dir, "boxsize_sweep.npy"),
    )
    plot_parameter_sweep_summary(
        sweep, os.path.join(output_dir, "boxsize"), "boxsizes")
    return sweep


def run_blursize_sweep(movie_path: str, output_dir: str, delta_x: float = 0.0913,
                       delta_t: float = 10.0, blur_sizes: str = "0.5:15:0.1",
                       boxsize: int = 21, frame_index: int = 3):
    """Blur-size sensitivity sweep (ref compare_rho_and_actin.py:485-614),
    batched on device (analysis.hyperparams)."""
    from opticalflow_tpu.analysis.hyperparams import vary_blursize
    from opticalflow_tpu.viz.plots import plot_parameter_sweep_summary

    movie = _load_movie(movie_path)
    start, stop, step = (float(x) for x in blur_sizes.split(":"))
    os.makedirs(output_dir, exist_ok=True)
    sweep = vary_blursize(
        movie, blur_sizes=np.arange(start, stop, step), boxsize=boxsize,
        frame_index=frame_index, delta_x=delta_x, delta_t=delta_t,
        filename=os.path.join(output_dir, "blursize_sweep.npy"),
    )
    plot_parameter_sweep_summary(
        sweep, os.path.join(output_dir, "blursize"), "blur_sizes")
    return sweep


def run_dual_channel(movie_path_a: str, movie_path_b: str, output_dir: str,
                     delta_x: float = 0.0913, delta_t: float = 10.0,
                     boxsize: int = 31, smoothing_sigma: float = 3.0,
                     label_a: str = "Actin", label_b: str = "Rho",
                     method: str = "box"):
    """Dual-channel comparison workflow (compare_rho_and_actin.py:616-767)."""
    from opticalflow_tpu.analysis.workflows import run_dual_channel_comparison

    return run_dual_channel_comparison(
        _load_movie(movie_path_a), _load_movie(movie_path_b), output_dir,
        label_a=label_a, label_b=label_b, method=method, boxsize=boxsize,
        smoothing_sigma=smoothing_sigma, delta_x=delta_x, delta_t=delta_t,
    )


def run_piv_compare(piv_mat_path: str, movie_path: str, output_dir: str,
                    method: str = "farneback", intensity_threshold: float = 10.0,
                    correct_intensity: bool = False):
    """PIV-vs-flow comparison (analyse_short_timeinterval_data.py:505-638)."""
    from opticalflow_tpu.analysis.workflows import run_piv_comparison

    movie = _load_movie(movie_path)
    if correct_intensity:
        from opticalflow_tpu.analysis.statistics import correct_intensity_change

        movie = correct_intensity_change(movie)
    return run_piv_comparison(
        piv_mat_path, movie, output_dir, method=method,
        intensity_threshold=intensity_threshold,
    )


def run_ground_truth(movie_path: str, measurements_path: str, output_dir: str,
                     method: str = "farneback", frame: int = 8,
                     correct_intensity: bool = False):
    """Hand-clicked displacement validation
    (analyse_short_timeinterval_data.py:128-239, 640-745)."""
    from opticalflow_tpu.analysis.workflows import run_ground_truth_validation

    movie = _load_movie(movie_path)
    if correct_intensity:
        from opticalflow_tpu.analysis.statistics import correct_intensity_change

        movie = correct_intensity_change(movie)
    return run_ground_truth_validation(
        movie, measurements_path, output_dir,
        method=method, frame=frame,
    )


def run_downsampled(movie_path: str, output_dir: str, delta_x: float = 1.0,
                    delta_t: float = 1.0, factor: float = 0.5,
                    speed_alpha: float = 1000.0, remodelling_alpha: float = 1000.0,
                    smoothing_sigma: Optional[float] = None,
                    frames: Optional[str] = None):
    """INTER_AREA-downsampled variational run
    (ref analyse_variational_optical_flow.py:526-615)."""
    return run_variational(
        movie_path, output_dir, delta_x=delta_x, delta_t=delta_t,
        speed_alpha=speed_alpha, remodelling_alpha=remodelling_alpha,
        smoothing_sigma=smoothing_sigma, frames=frames, downsample=factor,
    )


def run_intensity_analysis(movie_path_a: str, movie_path_b: Optional[str] = None,
                           output_dir: str = "output", sigma_a: float = 1.3,
                           sigma_b: float = 1.0, threshold_a: float = 17.0,
                           threshold_b: float = 18.0, label_a: str = "Actin",
                           label_b: str = "Rho"):
    """Raw + blurred per-channel intensity histograms with the
    mode-separating thresholds (ref compare_rho_and_actin.py:98-119
    ``investigate_intensities`` + :200-226
    ``investigate_intensity_thresholds``)."""
    from opticalflow_tpu.ops.blur import blur_movie
    from opticalflow_tpu.viz.plots import plot_intensity_histograms

    movies = [_load_movie(movie_path_a)]
    labels = [label_a]
    sigmas = [sigma_a]
    thresholds = [threshold_a]
    if movie_path_b is not None:
        movies.append(_load_movie(movie_path_b))
        labels.append(label_b)
        sigmas.append(sigma_b)
        thresholds.append(threshold_b)

    os.makedirs(output_dir, exist_ok=True)
    plot_intensity_histograms(
        movies, labels,
        os.path.join(output_dir, "both_intensity_histograms.pdf"),
        xlim=(-2, 120),
    )
    blurred = [np.asarray(blur_movie(m, smoothing_sigma=s))
               for m, s in zip(movies, sigmas)]
    plot_intensity_histograms(
        blurred, labels,
        os.path.join(output_dir, "both_intensity_histograms_blurred.pdf"),
        thresholds=thresholds, xlim=(0, 100),
    )
    for movie, label in zip(movies, labels):
        print(f"{label}: {len(np.unique(np.asarray(movie)))} unique "
              f"intensity values")
    return blurred


def run_threshold_movies(movie_path_a: str, movie_path_b: Optional[str] = None,
                         output_dir: str = "output", threshold: float = 17.5,
                         sigma_a: float = 1.3, sigma_b: float = 1.0,
                         label_a: str = "Actin", label_b: str = "Rho",
                         clahe: Optional[float] = None, adaptive: bool = False,
                         delta_x: float = 0.0913):
    """Thresholded channel overlay movie: below-threshold pixels render
    grayscale, the rest green; optional CLAHE pre-normalisation and
    adaptive (mean-C) thresholding; plus the blurred histograms
    (ref compare_rho_and_actin.py:228-300 ``make_thresholded_movies``)."""
    from opticalflow_tpu.ops.blur import blur_movie
    from opticalflow_tpu.ops.threshold import apply_adaptive_threshold
    from opticalflow_tpu.viz.plots import (
        make_channel_movie, plot_intensity_histograms, tint_below_mask,
    )

    movies = [_load_movie(movie_path_a)]
    labels = [label_a]
    sigmas = [sigma_a]
    if movie_path_b is not None:
        movies.append(_load_movie(movie_path_b))
        labels.append(label_b)
        sigmas.append(sigma_b)

    clahe_string = ""
    if clahe is not None:
        from opticalflow_tpu.ops.clahe import apply_clahe

        movies = [np.asarray(apply_clahe(m, clipLimit=clahe)) for m in movies]
        movies = [m / np.max(m) * 255.0 for m in movies]
        clahe_string = "_w_clahe"

    blurred = [np.asarray(blur_movie(m, smoothing_sigma=s))
               for m, s in zip(movies, sigmas)]
    if adaptive:
        masks = [np.asarray(apply_adaptive_threshold(b, window_size=151,
                                                     threshold=-5))
                 for b in blurred]
    else:
        # fixed threshold masks on the raw movie (ref :258-259)
        masks = [np.asarray(m) < threshold for m in movies]

    rgb = [tint_below_mask(m, mask) for m, mask in zip(movies, masks)]
    os.makedirs(output_dir, exist_ok=True)
    name = (f"joint_movie_thresholded_threshold_{threshold:.2f}"
            f"_sigmas_{sigma_a:.2f}_{sigma_b:.2f}{clahe_string}.mp4")
    make_channel_movie(rgb, labels, delta_x, os.path.join(output_dir, name))
    plot_intensity_histograms(
        blurred, labels,
        os.path.join(output_dir,
                     f"both_intensity_histograms_blurred{clahe_string}.pdf"),
        thresholds=[threshold] * len(blurred),
    )
    return masks


def run_coexpression(movie_path_a: str, movie_path_b: str,
                     output_dir: str = "output", normalised: bool = False,
                     flow_result_path: Optional[str] = None,
                     label: str = "Actin"):
    """Coexpression extras (ref compare_rho_and_actin.py:772-849): joint
    red/green coexpression movie of the two channels, plus — when a saved
    flow result is given — global and per-frame speed histograms with the
    binned table exported (``make_actin_speed_histograms``)."""
    from opticalflow_tpu.viz.plots import (
        make_coexpression_movie, plot_speed_histograms,
    )

    movie_a = _load_movie(movie_path_a)
    movie_b = _load_movie(movie_path_b)
    os.makedirs(output_dir, exist_ok=True)
    suffix = "normalised" if normalised else "unnormalised"
    make_coexpression_movie(
        movie_a, movie_b,
        os.path.join(output_dir, f"coexpression_{suffix}.mp4"),
        normalised=normalised,
    )
    if flow_result_path is not None:
        result = FlowResult.load(flow_result_path)
        plot_speed_histograms(result, output_dir, label=label)
    return None


def run_vortex_pair(output_dir: str = "output", dimension: int = 128,
                    peak_speed: float = 0.5, speed_alpha: float = 500.0,
                    remodelling_alpha: float = 500.0):
    """Figure-producing vortex-pair experiment (ref
    analyse_variational_optical_flow.py:114-179
    ``reproduce_matlab_example_vortex_pair`` — its .tif input is stripped
    from the mirror, so the movie is rebuilt analytically; the
    quantitative version of this workload runs as a test,
    tests/test_physics.py)."""
    from opticalflow_tpu.core.synth import make_vortex_pair_movie
    from opticalflow_tpu.viz.plots import make_velocity_overlay_movie

    movie, v_true_x, v_true_y = make_vortex_pair_movie(
        n_frames=3, dimension=dimension, peak_speed=peak_speed,
    )
    movie = np.asarray(movie)  # texture already ~100 intensity units
    result = variational_optical_flow(
        movie, speed_alpha=speed_alpha, remodelling_alpha=remodelling_alpha,
        dy_mode="fixed",
    )
    os.makedirs(output_dir, exist_ok=True)
    result.save(os.path.join(output_dir, "vortex_pair_result.npy"))
    make_velocity_overlay_movie(
        result, os.path.join(output_dir, "vortex_pair_overlay.mp4"),
        arrow_boxsize=max(4, dimension // 16), autoscale=True, dpi=150,
    )

    import matplotlib.pyplot as plt

    vx = np.asarray(result["v_x"][0])
    vy = np.asarray(result["v_y"][0])
    tx, ty = np.asarray(v_true_x), np.asarray(v_true_y)
    cos = float(
        np.sum(vx * tx + vy * ty)
        / max(np.sqrt(np.sum(vx**2 + vy**2) * np.sum(tx**2 + ty**2)), 1e-30)
    )
    plt.figure(figsize=(4.5, 2.5), constrained_layout=True)
    for k, (field, title) in enumerate([((vx, vy), "inferred"),
                                        ((tx, ty), "true")]):
        plt.subplot(1, 2, k + 1)
        plt.imshow(np.sqrt(field[0] ** 2 + field[1] ** 2), cmap="viridis")
        step = max(1, dimension // 16)
        sl = (slice(step // 2, None, step),) * 2
        plt.quiver(*np.meshgrid(*(np.arange(dimension)[s] for s in sl),
                                indexing="xy"),
                   field[1][sl], -field[0][sl], color="magenta")
        plt.title(f"{title} |v|")
    plt.suptitle(f"flow-alignment cosine: {cos:.4f}")
    plt.savefig(os.path.join(output_dir, "vortex_pair_comparison.pdf"))
    plt.close()
    print(f"vortex-pair alignment cosine: {cos:.4f}")
    return result, cos


def main(argv=None):
    parser = argparse.ArgumentParser(prog="opticalflow_tpu.analysis.drivers")
    parser.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="capture a jax.profiler device trace of the experiment into "
        "LOGDIR (TensorBoard-viewable; solver phases are named-scoped as "
        "el_pair_data / mg_setup / krylov_main / refinement) and print "
        "wall-clock span statistics at exit",
    )
    sub = parser.add_subparsers(dest="experiment", required=True)

    p = sub.add_parser("synthetic-boundary")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=100)

    p = sub.add_parser("synthetic-big")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=1000)
    p.add_argument("--speed-alpha", type=float, default=1e4)
    p.add_argument("--remodelling-alpha", type=float, default=1e4)

    p = sub.add_parser("synthetic-box-error")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--include-noise", action="store_true")
    p.add_argument("--dimension", type=int, default=256)

    p = sub.add_parser("boxsize-sweep")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--boxsizes", default="5:150:2", help="start:stop:step")
    p.add_argument("--smoothing-sigma", type=float, default=1.3)
    p.add_argument("--frame-index", type=int, default=3)

    p = sub.add_parser("blursize-sweep")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--blur-sizes", default="0.5:15:0.1", help="start:stop:step")
    p.add_argument("--boxsize", type=int, default=21)
    p.add_argument("--frame-index", type=int, default=3)

    p = sub.add_parser("dual-channel")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=0.0913)
    p.add_argument("--delta-t", type=float, default=10.0)
    p.add_argument("--boxsize", type=int, default=31)
    p.add_argument("--smoothing-sigma", type=float, default=3.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")
    p.add_argument("--method", default="box", choices=("box", "variational", "farneback"))

    p = sub.add_parser("piv-compare")
    p.add_argument("piv_mat_path")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--method", default="farneback",
                   choices=("box", "variational", "farneback"))
    p.add_argument("--intensity-threshold", type=float, default=10.0)
    p.add_argument("--correct-intensity", action="store_true")

    p = sub.add_parser("ground-truth")
    p.add_argument("movie_path")
    p.add_argument("measurements_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--method", default="farneback",
                   choices=("box", "variational", "farneback"))
    p.add_argument("--frame", type=int, default=8)
    p.add_argument("--correct-intensity", action="store_true")

    p = sub.add_parser("intensity-histograms")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b", nargs="?", default=None)
    p.add_argument("--output-dir", default="output")
    p.add_argument("--sigma-a", type=float, default=1.3)
    p.add_argument("--sigma-b", type=float, default=1.0)
    p.add_argument("--threshold-a", type=float, default=17.0)
    p.add_argument("--threshold-b", type=float, default=18.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")

    p = sub.add_parser("threshold-movies")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b", nargs="?", default=None)
    p.add_argument("--output-dir", default="output")
    p.add_argument("--threshold", type=float, default=17.5)
    p.add_argument("--sigma-a", type=float, default=1.3)
    p.add_argument("--sigma-b", type=float, default=1.0)
    p.add_argument("--label-a", default="Actin")
    p.add_argument("--label-b", default="Rho")
    p.add_argument("--clahe", type=float, default=None)
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--delta-x", type=float, default=0.0913)

    p = sub.add_parser("coexpression")
    p.add_argument("movie_path_a")
    p.add_argument("movie_path_b")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--normalised", action="store_true")
    p.add_argument("--flow-result-path", default=None)
    p.add_argument("--label", default="Actin")

    p = sub.add_parser("vortex-pair")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--peak-speed", type=float, default=0.5)
    p.add_argument("--speed-alpha", type=float, default=500.0)
    p.add_argument("--remodelling-alpha", type=float, default=500.0)

    p = sub.add_parser("downsampled")
    p.add_argument("movie_path")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--delta-x", type=float, default=1.0)
    p.add_argument("--delta-t", type=float, default=1.0)
    p.add_argument("--factor", type=float, default=0.5)
    p.add_argument("--speed-alpha", type=float, default=1000.0)
    p.add_argument("--remodelling-alpha", type=float, default=1000.0)
    p.add_argument("--smoothing-sigma", type=float, default=None)
    p.add_argument("--frames", default=None, help="start:stop frame slice")

    for name in ("variational", "box", "sweep", "tune"):
        p = sub.add_parser(name)
        p.add_argument("movie_path")
        p.add_argument("--output-dir", default="output")
        p.add_argument("--delta-x", type=float, default=1.0)
        p.add_argument("--delta-t", type=float, default=1.0)
        p.add_argument("--frames", default=None, help="start:stop frame slice")
        if name == "variational":
            p.add_argument("--speed-alpha", type=float, default=1000.0)
            p.add_argument("--remodelling-alpha", type=float, default=1000.0)
            p.add_argument("--smoothing-sigma", type=float, default=None)
            p.add_argument("--downsample", type=float, default=None)
            p.add_argument("--correct-intensity", action="store_true")
        if name == "box":
            p.add_argument("--boxsize", type=int, default=31)
            p.add_argument("--smoothing-sigma", type=float, default=3.0)
            p.add_argument("--include-remodelling", action="store_true")
        if name == "sweep":
            p.add_argument("--alphas", default="500,1000,1500")
            p.add_argument("--remodelling-alphas", default=None)
            p.add_argument("--log-axes", action="store_true")
        if name == "tune":
            p.add_argument("--resolution", type=int, default=150)
            p.add_argument("--smoothing-sigma", type=float, default=1.0)

    args = vars(parser.parse_args(argv))
    experiment = args.pop("experiment")
    fn = {
        "synthetic-boundary": run_synthetic_boundary,
        "synthetic-big": run_synthetic_big,
        "synthetic-box-error": run_synthetic_box_error,
        "variational": run_variational,
        "box": run_box,
        "sweep": run_sweep,
        "tune": run_tune,
        "boxsize-sweep": run_boxsize_sweep,
        "blursize-sweep": run_blursize_sweep,
        "dual-channel": run_dual_channel,
        "piv-compare": run_piv_compare,
        "ground-truth": run_ground_truth,
        "downsampled": run_downsampled,
        "intensity-histograms": run_intensity_analysis,
        "threshold-movies": run_threshold_movies,
        "coexpression": run_coexpression,
        "vortex-pair": run_vortex_pair,
    }[experiment]
    kwargs = {k.replace("-", "_"): v for k, v in args.items()}
    profile_dir = kwargs.pop("profile", None)
    if profile_dir:
        from opticalflow_tpu.utils.observability import profile_trace, span_statistics

        with profile_trace(profile_dir):
            out = fn(**kwargs)
        print(f"profiler trace written to {profile_dir}")
        print("span statistics:", span_statistics())
        return out
    return fn(**kwargs)


def cli():
    """Command-line entry point: ``main`` with the persistent compile cache
    enabled (the library itself sets none)."""
    from opticalflow_tpu.utils import compile_cache

    compile_cache.enable()
    return main()


if __name__ == "__main__":
    cli()
