"""Hermetic end-to-end test of the real-data path.

Generates a synthetic ASL-format dataset (rendered PNG frames + IMU CSVs),
then runs the full ``run_opt`` pipeline: reader -> prefetch server ->
KLT tracker -> EqF filter -> CSV writer, and evaluates ATE against the
written ground truth — the in-repo analogue of the reference's external
dataset regression scripts.
"""

import os

import numpy as np
import pytest

from eqvio_tpu.data import ASLDatasetReader, DataServer, generate_asl_dataset
from eqvio_tpu.io import load_config


@pytest.fixture(scope="module")
def synthetic_dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asl"))
    sim = generate_asl_dataset(out, end_time=4.0, width=320, height=240,
                               frame_freq=10.0, num_points=300)
    return out, sim


def test_asl_reader(synthetic_dataset):
    path, sim = synthetic_dataset
    reader = ASLDatasetReader(path)
    assert len(reader.imu.stamps) > 500
    assert len(reader.images.stamps) > 30
    assert reader.camera.model == "radtan"
    assert reader.camera.resolution == (320, 240)
    img = reader.load_image(0)
    assert img.shape == (240, 320)
    assert 0.0 <= img.min() and img.max() <= 1.0
    # extrinsics round-trip
    np.testing.assert_allclose(
        reader.camera.T_BS[:3, :3], np.asarray(sim.camera_offset.R), atol=1e-6
    )


def test_dataserver_ordering(synthetic_dataset):
    path, _ = synthetic_dataset
    reader = ASLDatasetReader(path)
    stamps = []
    kinds = []
    for meas in DataServer(reader):
        stamps.append(meas.stamp)
        kinds.append(meas.kind)
    assert all(s1 <= s2 + 1e-12 for s1, s2 in zip(stamps, stamps[1:]))
    assert "image" in kinds and "imu" in kinds


def test_run_opt_end_to_end(synthetic_dataset, tmp_path):
    path, sim = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.runner import ate_rmse

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["eqf"]["measurementNoise"]["feature"] = 1.0
    cfg["eqf"]["initialVariance"]["point"] = 10.0
    cfg["GIFT"]["maxFeatures"] = 20
    cfg["GIFT"]["winSize"] = 15
    cfg["GIFT"]["featureDist"] = 12

    out_dir = str(tmp_path / "out")
    state, summary = run_dataset(path, cfg, output_dir=out_dir, timing=True)
    assert summary["frames"] > 25
    assert summary["landmarks"] > 3

    # compare the written trajectory against the written ground truth
    est = np.genfromtxt(os.path.join(out_dir, "IMUState.csv"), delimiter=",", skip_header=1)
    gt = np.genfromtxt(
        os.path.join(path, "mav0", "state_groundtruth_estimate0", "data.csv"),
        delimiter=",", skip_header=1,
    )
    assert not np.any(np.isnan(est))
    # align stamps (gt in ns)
    gt_t = gt[:, 0] * 1e-9
    idx = np.searchsorted(gt_t, est[:, 0])
    idx = np.clip(idx, 0, len(gt_t) - 1)
    rmse, scale = ate_rmse(est[:, 1:4], gt[idx, 1:4])
    assert rmse < 0.5, f"ATE {rmse}"
    # timing rows written
    assert os.path.exists(os.path.join(out_dir, "timing.csv"))
    assert os.path.exists(os.path.join(out_dir, "features.csv"))


def test_run_opt_fused_matches_per_frame(synthetic_dataset, tmp_path):
    """The chunked fused device loop must produce the SAME trajectory as the
    per-frame loop (chunking only amortises host transfers; zero-dt padded
    tail frames are exact no-ops)."""
    path, _ = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 12
    cfg["GIFT"]["winSize"] = 15

    out_f = str(tmp_path / "fused")
    out_l = str(tmp_path / "legacy")
    run_dataset(path, cfg, output_dir=out_f, chunk_size=8, limit_frames=20)
    run_dataset(path, cfg, output_dir=out_l, chunk_size=1, limit_frames=20)
    # every CSV must match — the fused path packs all outputs into one device
    # array, and a packing/unpacking misalignment corrupts features/points
    # while leaving IMUState (the first columns) intact
    for name in ("IMUState.csv", "features.csv", "points.csv", "bias.csv", "camera.csv"):
        with open(os.path.join(out_f, name)) as f:
            a_lines = f.readlines()
        with open(os.path.join(out_l, name)) as f:
            b_lines = f.readlines()
        assert len(a_lines) == len(b_lines), name
        assert a_lines[0] == b_lines[0], name  # header
        for la, lb in zip(a_lines[1:], b_lines[1:]):
            ca = [c.strip() for c in la.split(",") if c.strip()]
            cb = [c.strip() for c in lb.split(",") if c.strip()]
            assert len(ca) == len(cb), (name, la[:80], lb[:80])
            np.testing.assert_allclose(
                [float(x) for x in ca], [float(x) for x in cb],
                atol=1e-9, err_msg=name,
            )
    a = np.genfromtxt(os.path.join(out_f, "features.csv"), delimiter=",",
                      skip_header=1, invalid_raise=False)
    # tracked features must actually appear in the output
    with open(os.path.join(out_f, "features.csv")) as f:
        rows = f.readlines()[1:]
    n_feats = [len([c for c in r.split(",") if c.strip()]) // 3 for r in rows]
    assert max(n_feats) >= 5, n_feats


def test_run_opt_checkpoint_resume(synthetic_dataset, tmp_path):
    """Kill a run mid-sequence, resume from its checkpoint, and get the
    IDENTICAL final-state CSV as the uninterrupted run (checkpoint/resume
    as a product feature, not just a library)."""
    path, _ = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 12
    cfg["GIFT"]["winSize"] = 15

    out_full = str(tmp_path / "full")
    out_a = str(tmp_path / "part_a")
    out_b = str(tmp_path / "part_b")

    # uninterrupted
    run_dataset(path, cfg, output_dir=out_full, chunk_size=8, limit_frames=32)
    # interrupted at ~16 frames (2 chunks), checkpointing every 16
    run_dataset(
        path, cfg, output_dir=out_a, chunk_size=8, limit_frames=16,
        checkpoint_every=16,
    )
    ckpt = os.path.join(out_a, "checkpoint.npz")
    assert os.path.exists(ckpt)
    # resumed to the same total frame count
    _, summary = run_dataset(
        path, cfg, output_dir=out_b, chunk_size=8, limit_frames=32, resume=ckpt,
    )
    assert summary["frames"] == 32

    full = np.genfromtxt(os.path.join(out_full, "IMUState.csv"), delimiter=",", skip_header=1)
    a = np.genfromtxt(os.path.join(out_a, "IMUState.csv"), delimiter=",", skip_header=1)
    b = np.genfromtxt(os.path.join(out_b, "IMUState.csv"), delimiter=",", skip_header=1)
    # part A wrote the first 16 frames, part B the rest; stitched == full
    stitched = np.vstack([a[:16], b])
    assert stitched.shape == full.shape
    np.testing.assert_allclose(stitched, full, atol=1e-12)


def test_run_opt_simvis(synthetic_dataset, tmp_path):
    """--simvis path: real IMU + simulated vision around ground truth."""
    path, sim = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["eqf"]["measurementNoise"]["feature"] = 1.0
    cfg["GIFT"]["maxFeatures"] = 16
    _, summary = run_dataset(path, cfg, simvis=True, limit_frames=20)
    assert summary["frames"] == 20
    assert summary["landmarks"] > 3
    assert not np.any(np.isnan(summary["final_position"]))


def test_uzhfpv_reader_and_pipeline(tmp_path):
    """Hermetic UZH-FPV path: fisheye camchain reader + full pipeline."""
    from eqvio_tpu.data import UZHFPVDatasetReader, generate_uzhfpv_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    out = str(tmp_path / "uzh")
    os.makedirs(out, exist_ok=True)
    sim = generate_uzhfpv_dataset(out, end_time=3.0)

    reader = UZHFPVDatasetReader(out, camera_yaml=os.path.join(out, "camchain-imucam.yaml"))
    assert reader.camera.model == "equidistant"
    assert len(reader.imu.stamps) > 400
    np.testing.assert_allclose(
        reader.camera.T_BS[:3, :3], np.asarray(sim.camera_offset.R), atol=1e-6
    )
    assert reader.groundtruth is not None

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 16
    cfg["GIFT"]["winSize"] = 15
    _, summary = run_dataset(
        out, cfg, mode="uzhfpv",
        camera_yaml=os.path.join(out, "camchain-imucam.yaml"),
        limit_frames=15,
    )
    assert summary["frames"] == 15
    assert not np.any(np.isnan(summary["final_position"]))


def test_run_opt_simimu(synthetic_dataset):
    """--simimu path: simulated IMU + simulated vision around ground truth
    (reference main_opt.cpp:249-253 via DataServerBase::getSimIMU)."""
    path, _ = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["eqf"]["measurementNoise"]["feature"] = 1.0
    cfg["GIFT"]["maxFeatures"] = 16
    _, summary = run_dataset(path, cfg, simvis=True, simimu=True, limit_frames=15)
    assert summary["frames"] == 15
    assert summary["landmarks"] > 3
    assert not np.any(np.isnan(summary["final_position"]))


def test_run_opt_start_stop_window(synthetic_dataset):
    """--start/--stop are offsets from the first data time
    (main_opt.cpp:124-130), windowing the processed frames."""
    path, _ = synthetic_dataset
    from eqvio_tpu.app.run_opt import run_dataset

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 12
    _, full = run_dataset(path, cfg, simvis=True)
    _, windowed = run_dataset(path, cfg, simvis=True, start=1.0, stop=3.0)
    assert 0 < windowed["frames"] < full["frames"]
    # ~2 s of a 10 fps stream
    assert windowed["frames"] <= 2.0 * 10 + 2


def test_camera_lag_shifts_image_stamps(synthetic_dataset):
    """main:cameraLag shifts image stamps earlier relative to the IMU
    (reference DatasetReaderBase.h:71, ASLDatasetReader.cpp:71)."""
    path, _ = synthetic_dataset
    from eqvio_tpu.data import create_dataset_reader

    base = create_dataset_reader("asl", path)
    lagged = create_dataset_reader("asl", path, camera_lag=0.025)
    np.testing.assert_allclose(
        lagged.images.stamps, base.images.stamps - 0.025, atol=1e-12
    )
    np.testing.assert_allclose(lagged.imu.stamps, base.imu.stamps, atol=1e-12)


def test_full_state_mode():
    """--fullState: every world landmark stays in the state for the whole run
    (reference eqvio_sim --fullState, main_sim.cpp:56-59,139)."""
    import jax.numpy as jnp

    from eqvio_tpu import filter as F
    from eqvio_tpu.runner import ate_rmse, run_simulation

    res = run_simulation(
        F.Settings(measurement_noise=0.5),
        full_state=True,
        num_points=40,
        max_features=12,
        end_time=5.0,
        dtype=jnp.float64,
    )
    counts = np.asarray(res.num_landmarks)
    assert (counts == 40).all()  # capacity overridden to world size, all active
    rmse, scale = ate_rmse(np.asarray(res.est_position), np.asarray(res.true_position))
    assert rmse < 0.01
    assert abs(scale - 1.0) < 0.01
    assert not np.isnan(np.asarray(res.nees)).any()


def test_imu_window_full_coverage_across_frame_gaps():
    """No IMU interval may be lost when the inter-frame gap exceeds 50 ms
    (dropped frames, 10 Hz datasets): the window trim must keep every entry
    still ahead of the processed frame, not apply a fixed horizon."""
    from eqvio_tpu.app.run_opt import _build_imu_window

    rng = np.random.default_rng(0)
    # 100 Hz IMU over 1 s
    imu_buf = [
        (0.01 * k, rng.normal(size=3), rng.normal(size=3)) for k in range(100)
    ]
    # frames with a 200 ms and a 350 ms gap (both > the old 50 ms horizon)
    frame_stamps = [0.105, 0.305, 0.655, 0.955]
    t_prev = 0.005
    for stamp in frame_stamps:
        (arr_stamp, _g, _a, arr_dt), imu_buf = _build_imu_window(
            imu_buf, t_prev, stamp, imu_window=64
        )
        # the dt coverage must tile [t_prev, stamp] exactly
        np.testing.assert_allclose(arr_dt.sum(), stamp - t_prev, atol=1e-12)
        # padded tail entries are exact no-ops
        assert np.all(arr_dt >= 0.0)
        t_prev = stamp
    # the trimmed buffer still begins at-or-before the last frame
    assert imu_buf[0][0] <= frame_stamps[-1]
