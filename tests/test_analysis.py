"""Analysis layer: sweeps (batched vs serial parity), shgo tuning,
statistics, ground-truth comparison, viz smoke tests."""

import numpy as np
import pytest

from opticalflow_tpu.analysis.statistics import (
    angles_between,
    correct_intensity_change,
    endpoint_error,
    ground_truth_error_statistics,
    speed_pairs,
    velocity_angles,
)
from opticalflow_tpu.analysis.sweeps import vary_regularisation
from opticalflow_tpu.core.synth import make_translating_blob_movie
from opticalflow_tpu.core.types import SolverConfig
from opticalflow_tpu.flow.boxflow import conduct_optical_flow


@pytest.fixture(scope="module")
def movie():
    movie, delta_x = make_translating_blob_movie(
        n_frames=3, dimension=24, width=10.0, sigma=2.5, v_x=0.2, v_y=0.1
    )
    return np.asarray(movie) * 100.0, delta_x


def test_batched_sweep_chunk_invariance(movie):
    """Chunked execution (the sweep's bound on solves per device call)
    must be invisible: a grid split into padded chunks produces the same
    statistics as one whole-grid batch."""
    mov, _ = movie
    a_s = np.logspace(1, 3, 3)
    a_r = np.logspace(1, 3, 4)
    whole = vary_regularisation(mov, a_s, a_r, batched=True, batch_chunk=1000)
    chunked = vary_regularisation(mov, a_s, a_r, batched=True, batch_chunk=5)
    for key in ("speed_means", "remodelling_means", "functional", "converged"):
        np.testing.assert_allclose(
            chunked[key], whole[key], rtol=1e-10, atol=1e-12, err_msg=key
        )


def test_batched_sweep_matches_serial(movie):
    m, delta_x = movie
    alphas_s = np.array([200.0, 1000.0])
    alphas_r = np.array([500.0])
    kwargs = dict(delta_x=delta_x, solver=SolverConfig(rtol=1e-10))
    batched = vary_regularisation(m, alphas_s, alphas_r, batched=True, **kwargs)
    serial = vary_regularisation(m, alphas_s, alphas_r, batched=False,
                                 warm_start="cold", **kwargs)
    np.testing.assert_allclose(batched["speed_means"], serial["speed_means"],
                               rtol=1e-4)
    np.testing.assert_allclose(batched["remodelling_means"],
                               serial["remodelling_means"], rtol=1e-3, atol=1e-8)
    assert batched["converged"].all()
    assert batched["speed_means"].shape == (2, 1)


def test_sweep_saves_and_plots(movie, tmp_path):
    m, delta_x = movie
    result = vary_regularisation(
        m, np.array([500.0, 1000.0]), np.array([500.0, 1000.0]),
        filename=str(tmp_path / "sweep.npy"), delta_x=delta_x,
    )
    loaded = np.load(tmp_path / "sweep.npy", allow_pickle=True).item()
    assert loaded["speed_means"].shape == (2, 2)

    from opticalflow_tpu.viz.plots import plot_regularisation_variation

    plot_regularisation_variation(result, str(tmp_path / "sweep.pdf"))
    plot_regularisation_variation(result, str(tmp_path / "sweep_log.pdf"),
                                  use_log_axes=True, use_log_colorbar=True)
    assert (tmp_path / "sweep.pdf").exists()


def test_shgo_tuner_on_tiny_problem(movie):
    from opticalflow_tpu.analysis.tuning import optimize_regularisation_parameters

    m, delta_x = movie
    optimal, value, opt = optimize_regularisation_parameters(
        m[:2], delta_x=delta_x, bounds=[(2, 4), (2, 4)],
        use_direct_solver=True,
        shgo_kwargs={"n": 8, "iters": 1, "sampling_method": "sobol"},
    )
    assert optimal.shape == (2,)
    assert 1e2 <= optimal[0] <= 1e4
    assert np.isfinite(value)


def test_statistics_roundtrip(movie):
    m, delta_x = movie
    res = conduct_optical_flow(m, boxsize=9, delta_x=delta_x, dtype=np.float64)
    angles = velocity_angles(res)
    assert angles.shape == res["v_x"].shape
    ok = np.isfinite(angles)
    assert np.abs(angles[ok]).max() <= np.pi + 1e-9

    theta, weights = angles_between(res, res)
    # a field against itself: zero angle wherever speed > 0
    valid = np.isfinite(theta)
    np.testing.assert_allclose(theta[valid], 0.0, atol=1e-3)

    a, b = speed_pairs(res, res, threshold=0.0)
    assert a.shape == b.shape

    stats = ground_truth_error_statistics(res, 0.2, 0.1)
    assert set(stats) >= {"bias_v_x", "bias_v_y", "rmse", "epe_mean"}

    epe = endpoint_error(res, res)
    assert epe["epe_max"] == 0.0


def test_intensity_correction_removes_global_drift():
    rng = np.random.default_rng(3)
    base = rng.random((40, 40)) * 50.0
    movie = np.stack([base, base + 20.0])  # pure global illumination jump
    corrected = correct_intensity_change(movie, smoothing_sigma=2.0,
                                         correction_sigma=5.0)
    drift_before = np.mean(movie[1]) - np.mean(movie[0])
    drift_after = np.mean(corrected[1]) - np.mean(corrected[0])
    assert abs(drift_after) < 0.1 * abs(drift_before)


def test_ground_truth_displacement_comparison(movie):
    from opticalflow_tpu.analysis.groundtruth import compare_ground_truth_displacement

    m, delta_x = movie
    res = conduct_optical_flow(m, boxsize=9, delta_x=delta_x, delta_t=1.0,
                               dtype=np.float64)
    measurements = {
        "x_start": np.array([10, 12]),
        "y_start": np.array([11, 13]),
        "x_end": np.array([10.2, 12.2]),
        "y_end": np.array([11.1, 13.1]),
    }
    out = compare_ground_truth_displacement(res, measurements)
    assert out["relative_errors"].shape == (2,)
    assert np.isfinite(out["relative_errors"]).all()


def test_viz_overlay_movies(movie, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from opticalflow_tpu.viz.plots import (
        make_joint_overlay_movie,
        make_velocity_overlay_movie,
        subsample_velocities_for_visualisation,
    )
    from opticalflow_tpu.flow.variational import variational_optical_flow

    m, delta_x = movie
    res = variational_optical_flow(m, delta_x=delta_x, speed_alpha=500.0,
                                   remodelling_alpha=500.0)
    x_pos, y_pos, vx, vy = subsample_velocities_for_visualisation(res, arrow_boxsize=4)
    assert vx.shape == (2, 6, 6)

    make_velocity_overlay_movie(res, str(tmp_path / "overlay.gif"),
                                arrow_boxsize=6, dpi=50)
    assert (tmp_path / "overlay.gif").stat().st_size > 0
    make_joint_overlay_movie(res, str(tmp_path / "joint.gif"),
                             arrow_boxsize=6, dpi=50)
    assert (tmp_path / "joint.gif").stat().st_size > 0


def test_comparison_plots(movie, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from opticalflow_tpu.viz.plots import (
        plot_angle_histogram,
        plot_polar_angle_histogram,
        plot_speed_correlation,
    )

    m, delta_x = movie
    res = conduct_optical_flow(m, boxsize=9, delta_x=delta_x, dtype=np.float64)
    plot_angle_histogram(res, str(tmp_path / "angles.pdf"), dpi=50)
    plot_angle_histogram(res, str(tmp_path / "angles_w.pdf"), weighted=True, dpi=50)
    plot_polar_angle_histogram(res, res, str(tmp_path / "polar.pdf"), dpi=50)
    plot_speed_correlation(res, res, str(tmp_path / "corr.png"), threshold=0.0, dpi=50)
    for name in ["angles.pdf", "angles_w.pdf", "polar.pdf", "corr.png"]:
        assert (tmp_path / name).stat().st_size > 0


def test_mudic_conversion_and_rename(tmp_path):
    from opticalflow_tpu.io.interop import convert_mudic_result
    from opticalflow_tpu.io.sequences import rename_images

    rng = np.random.default_rng(11)
    disp = rng.random((1, 2, 5, 6, 3))
    coords = rng.random((1, 2, 5, 6, 3)) * 10.0
    out = convert_mudic_result(disp, coords, delta_x=0.5, delta_t=2.0)
    assert out["v_x"].shape == (3, 5, 6)
    np.testing.assert_allclose(out["v_x"][1], disp[0, 0, :, :, 1] * 0.25)
    np.testing.assert_allclose(out["x_start_coords"], coords[0, 0, :, :, 0] * 0.5)
    assert np.all(out["speed"] >= 0)

    src = tmp_path / "src"
    src.mkdir()
    (src / "a_control_blurred_1.tif").write_bytes(b"x")
    (src / "a_control_blurred_2.tif").write_bytes(b"y")
    renamed = rename_images(str(src), str(tmp_path / "dst"), "control_blurred_")
    assert renamed == ["a_1.tif", "a_2.tif"]
    assert (tmp_path / "dst" / "a_2.tif").read_bytes() == b"y"


def test_viz_convergence_plots(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from opticalflow_tpu.flow.liushen import conduct_variational_optical_flow_deprecated
    from opticalflow_tpu.viz.plots import make_convergence_plots

    rng = np.random.default_rng(9)
    m = rng.random((2, 16, 16)) * 50.0
    res = conduct_variational_optical_flow_deprecated(
        m, speed_alpha=10.0, max_iterations=4, iteration_stepsize=2,
        return_iterations=True, use_liu_shen=True,
    )
    make_convergence_plots(res, str(tmp_path / "conv_"))
    assert (tmp_path / "conv_speed_convergence.pdf").exists()
    # no ffmpeg in this image -> the saver falls back to GIF
    assert (tmp_path / "conv_compound_figures.mp4").exists() or (
        tmp_path / "conv_compound_figures.gif"
    ).exists()


def test_liu_shen_mat_conversion(tmp_path):
    """Repaired postprocess_Liu loader (the reference version ships broken,
    ref analysis/postprocess_Liu.py:38-59): single-pair 'ux'/'uy' fields
    and per-frame cell-array exports both land in the FlowResult contract."""
    import scipy.io

    from opticalflow_tpu.io.interop import convert_liu_result, load_mat

    rng = np.random.default_rng(3)
    ux = rng.normal(size=(7, 9))
    uy = rng.normal(size=(7, 9))
    path = tmp_path / "Liu_method.mat"
    scipy.io.savemat(path, {"ux": ux, "uy": uy})

    res = convert_liu_result(load_mat(str(path)), movie_shape=(2, 7, 9),
                             delta_x=0.5, delta_t=2.0)
    assert res["v_x"].shape == (1, 7, 9)
    np.testing.assert_allclose(res["v_x"][0], ux * 0.25)
    np.testing.assert_allclose(res["speed"], np.hypot(res["v_x"], res["v_y"]))
    assert res.delta_x == 0.5

    # shape validation against the source movie (what the reference's
    # actin_movie-shaped zero arrays were for)
    import pytest
    with pytest.raises(ValueError):
        convert_liu_result({"ux": ux, "uy": uy}, movie_shape=(2, 5, 5))
    with pytest.raises(KeyError):
        convert_liu_result({"wrong": ux})
