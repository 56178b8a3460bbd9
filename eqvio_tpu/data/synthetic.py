"""Synthetic ASL-format dataset generation for hermetic end-to-end tests.

Renders the simulator's world points into PNG frames and writes a full
EuRoC/ASL directory tree (imu0/cam0 data.csv, sensor.yaml, ground truth), so
the real-data path — reader, tracker, filter, writer — can be exercised
without any external dataset.  (The reference has no equivalent; its dataset
tests are external scripts.)
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from ..io.writer import rotation_to_quaternion
from ..io.yaml_lite import safe_dump
from ..lie import se3_inv, se3_mul, SE3
from ..sim import Simulator
from .png import write_gray


def _render(points_px: np.ndarray, visible: np.ndarray, w: int, h: int, rng,
            amp: np.ndarray | None = None, width: np.ndarray | None = None) -> np.ndarray:
    """Render visible points as 2-D gaussian blobs + mild noise.

    ``amp``/``width``: per-WORLD-POINT appearance (stable across frames).
    Identical blobs alias badly under large inter-frame motion — KLT locks
    onto the wrong neighbour and the filter sees consistent-looking wrong
    tracks.  Real scenes disambiguate by texture variety; so does this.
    """
    img = np.zeros((h, w), dtype=np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for i, ((x, y), v) in enumerate(zip(points_px, visible)):
        if v and 2 < x < w - 2 and 2 < y < h - 2:
            a = 1.0 if amp is None else float(amp[i])
            s2 = 3.0 if width is None else float(width[i])
            r = int(np.ceil(2.5 * np.sqrt(s2 / 2.0))) + 1
            x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
            y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
            img[y0:y1, x0:x1] += a * np.exp(
                -((xs[y0:y1, x0:x1] - x) ** 2 + (ys[y0:y1, x0:x1] - y) ** 2) / s2
            )
    img += rng.normal(scale=0.01, size=img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _point_appearance(num_points: int, seed: int):
    """Stable per-point blob appearance (amplitude, gaussian width)."""
    r = np.random.default_rng(seed + 90210)
    return r.uniform(0.55, 1.25, num_points), r.uniform(1.8, 5.5, num_points)


def generate_asl_dataset(
    out_dir: str,
    end_time: float = 5.0,
    imu_freq: float = 200.0,
    frame_freq: float = 20.0,
    width: int = 320,
    height: int = 240,
    num_points: int = 400,
    seed: int = 0,
    kind: str = "wave",
    intrinsics: tuple | None = None,
    distortion: tuple | None = None,
    imu_noise: dict | None = None,
    gt_freq: float | None = None,
    num_walls: int = 4,
    wall_distance: float = 2.0,
    num_distractors: int = 0,
):
    """Write a synthetic ASL dataset tree under ``out_dir``; returns the Simulator.

    ``num_distractors``: corner-like blobs pinned (with slow sinusoidal
    drift) to IMAGE coordinates rather than the world — the lens-dirt /
    specular-highlight failure mode.  KLT tracks them happily (their image
    motion is smooth) but their tracks are geometrically impossible for the
    camera's true motion, which is exactly what the epipolar RANSAC gate
    exists to reject (GIFT ``ransacParams``); without the gate they enter
    the filter as false landmarks.

    ``intrinsics``/``distortion``: optional (fx, fy, cx, cy) + radtan
    (k1, k2, p1, p2) — frames are rendered through the distorted model, and
    ``sensor.yaml`` carries the same coefficients (reference
    ``ASLDatasetReader.cpp:84-101`` reads them back into a StandardCamera).
    ``imu_noise``: optional continuous noise densities
    ``{"gyr", "acc", "gyrBias", "accBias"}`` (units of the reference's
    ``velocityNoise`` config block) — Gaussian noise at sigma=density*sqrt(f)
    plus an integrated bias random walk are added to the written IMU rows;
    ground truth stays clean.
    ``gt_freq``: ground-truth rate (defaults to the frame rate).
    """
    from ..camera import RadTanCamera

    sim = Simulator.create(
        kind=kind, end_time=end_time + 1.0, num_points=num_points,
        num_walls=num_walls, seed=seed, wall_distance=wall_distance,
    )
    if intrinsics is None:
        fx = fy = 200.0
        cx, cy = width / 2, height / 2
    else:
        fx, fy, cx, cy = intrinsics
    dist = tuple(distortion) if distortion is not None else (0.0, 0.0, 0.0, 0.0)
    cam = RadTanCamera.create(fx, fy, cx, cy, dist, width, height)

    base = os.path.join(out_dir, "mav0")
    for sub in ["imu0", "cam0/data", "state_groundtruth_estimate0"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    rng = np.random.default_rng(seed)
    amp, blob_w = _point_appearance(num_points, seed)
    t0 = 0.2

    # IMU (optionally corrupted at reference-magnitude densities)
    imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
    imu = sim.get_imu_batch(jnp.asarray(imu_times))
    gyr, acc = np.asarray(imu.gyr), np.asarray(imu.acc)
    if imu_noise is not None:
        n, sqf = len(imu_times), float(np.sqrt(imu_freq))
        gyr = gyr + rng.normal(scale=imu_noise["gyr"] * sqf, size=(n, 3))
        acc = acc + rng.normal(scale=imu_noise["acc"] * sqf, size=(n, 3))
        sqdt = float(np.sqrt(1.0 / imu_freq))
        gyr += np.cumsum(rng.normal(scale=imu_noise["gyrBias"] * sqdt, size=(n, 3)), axis=0)
        acc += np.cumsum(rng.normal(scale=imu_noise["accBias"] * sqdt, size=(n, 3)), axis=0)
    with open(os.path.join(base, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, g, a in zip(imu_times, gyr, acc):
            f.write(f"{int(t * 1e9)}," + ",".join(f"{v:.9f}" for v in [*g, *a]) + "\n")

    # camera yaml (EuRoC sensor.yaml schema)
    T_BS = np.eye(4)
    T_BS[:3, :3] = np.asarray(sim.camera_offset.R)
    T_BS[:3, 3] = np.asarray(sim.camera_offset.x)
    with open(os.path.join(base, "cam0", "sensor.yaml"), "w") as f:
        f.write(
            "sensor_type: camera\n"
            f"T_BS:\n  rows: 4\n  cols: 4\n  data: {T_BS.reshape(-1).tolist()}\n"
            f"rate_hz: {frame_freq}\n"
            f"resolution: [{width}, {height}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{fx}, {fy}, {cx}, {cy}]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: {list(dist)}\n"
        )

    # image-pinned distractor blobs: base position + slow sinusoidal drift,
    # strong stable appearance so the Harris detector picks them
    if num_distractors > 0:
        drng = np.random.default_rng(seed + 5150)
        d_base = drng.uniform([0.12 * width, 0.12 * height],
                              [0.88 * width, 0.88 * height],
                              size=(num_distractors, 2))
        d_ampl = drng.uniform(6.0, 18.0, size=(num_distractors, 2))  # px drift
        d_period = drng.uniform(9.0, 23.0, size=(num_distractors, 2))
        d_phase = drng.uniform(0, 2 * np.pi, size=(num_distractors, 2))
        d_amp = drng.uniform(1.0, 1.3, num_distractors)
        d_width = drng.uniform(2.2, 4.5, num_distractors)

    # frames (projected through the distorted camera model)
    frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
    with open(os.path.join(base, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in frame_times:
            pose = sim.interpolate_pose(jnp.asarray(t))
            cam_inv = se3_inv(se3_mul(pose, sim.camera_offset))
            pts = jnp.einsum("ij,pj->pi", cam_inv.R, sim.world) + cam_inv.x
            px = np.asarray(cam.project(pts))
            z = np.asarray(pts)[:, 2]
            vis = (z > 0.1) & (px[:, 0] > 0) & (px[:, 0] < width) & (px[:, 1] > 0) & (px[:, 1] < height)
            ramp, rwidth = amp, blob_w
            if num_distractors > 0:
                d_px = d_base + d_ampl * np.sin(
                    2 * np.pi * t / d_period + d_phase
                )
                px = np.concatenate([px, d_px])
                vis = np.concatenate([vis, np.ones(num_distractors, dtype=bool)])
                ramp = np.concatenate([amp, d_amp])
                rwidth = np.concatenate([blob_w, d_width])
            img = _render(px, vis, width, height, rng, ramp, rwidth)
            name = f"{int(t * 1e9)}.png"
            write_gray(os.path.join(base, "cam0", "data", name), (img * 255).astype(np.uint8))
            f.write(f"{int(t * 1e9)},{name}\n")

    # ground truth (clean)
    gt_times = np.arange(t0, end_time, 1.0 / (gt_freq or frame_freq))
    with open(os.path.join(base, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write(
            "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
            "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
            "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1]\n"
        )
        for t in gt_times:
            xi = sim.full_state(jnp.asarray(float(t)))
            q = rotation_to_quaternion(np.asarray(xi.sensor.pose.R))
            p = np.asarray(xi.sensor.pose.x)
            v = np.asarray(xi.sensor.pose.R) @ np.asarray(xi.sensor.velocity)
            f.write(
                f"{int(t * 1e9)},"
                + ",".join(f"{x:.9f}" for x in [*p, *q, *v])
                + "\n"
            )

    return sim


# EuRoC cam0 (MT9V034 + radial-tangential) public calibration — used for the
# V1_01 proxy so the rendered frames carry the real sensor's geometry.
EUROC_CAM0_INTRINSICS = (458.654, 457.296, 367.215, 248.375)
EUROC_CAM0_DISTORTION = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


def generate_v101_proxy(out_dir: str, end_time: float = 144.0, seed: int = 11):
    """Strongest hermetic stand-in for EuRoC V1_01_easy (no egress, no files).

    A 144 s ``room`` trajectory whose motion statistics match the committed
    V1_01 numbers (path length 58.56 m — reference
    ``configs/EQVIO_results_EuRoC_stationary.yaml`` — over the public 144 s
    duration => mean speed 0.407 m/s), rendered at 752x480/20 Hz through the
    real EuRoC cam0 radtan calibration, with IMU corrupted at the tuned
    config's noise densities (``configs/config_EuRoC.yaml`` velocityNoise)
    including integrated bias random walks.  Returns (sim, stats_dict); the
    measured motion statistics are also written to ``proxy_info.yaml``.
    """
    sim = generate_asl_dataset(
        out_dir,
        end_time=end_time,
        imu_freq=200.0,
        frame_freq=20.0,
        width=752,
        height=480,
        num_points=900,
        seed=seed,
        kind="room",
        intrinsics=EUROC_CAM0_INTRINSICS,
        distortion=EUROC_CAM0_DISTORTION,
        imu_noise={
            # the TRUE sensor noise: ADIS16448 datasheet densities from the
            # public EuRoC calibration (mav0/imu0/sensor.yaml).  The FILTER
            # runs with the reference's auto-tuned (pessimistic) velocityNoise
            # values — the same model/truth mismatch a real run has; injecting
            # the tuned values instead gave the proxy a 7x-worse-than-real
            # gyro bias walk whose integral dominated yaw drift.
            "gyr": 1.6968e-04,
            "acc": 2.0000e-03,
            "gyrBias": 1.9393e-05,
            "accBias": 3.0000e-03,
        },
        gt_freq=100.0,
        num_walls=6,
    )

    # measured motion statistics vs the V1_01 targets
    x = np.asarray(sim.poses.x)
    t = np.asarray(sim.times)
    seg = np.linalg.norm(np.diff(x, axis=0), axis=1)
    speed = seg / np.diff(t)
    R = np.asarray(sim.poses.R)
    dR = np.einsum("tij,tik->tjk", R[:-1], R[1:])  # R_k^T R_{k+1}
    ang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    ang_rate = ang / np.diff(t)
    mask = t[:-1] < end_time
    stats = {
        "duration_s": float(min(end_time, t[-1])),
        "path_length_m": float(seg[mask].sum()),
        "mean_speed_mps": float(speed[mask].mean()),
        "max_speed_mps": float(speed[mask].max()),
        "mean_ang_rate_radps": float(ang_rate[mask].mean()),
        "max_ang_rate_radps": float(ang_rate[mask].max()),
        "targets_v101": {
            "duration_s": 144.0,
            "path_length_m": 58.56120400739347,
            "mean_speed_mps": 58.56120400739347 / 144.0,
        },
    }
    with open(os.path.join(out_dir, "proxy_info.yaml"), "w") as f:
        safe_dump(stats, f)
    return sim, stats


def generate_mh03_proxy(out_dir: str, end_time: float = 132.0, seed: int = 17):
    """Hermetic stand-in for EuRoC MH_03_medium — the fast-motion,
    larger-landmark-set regime (BASELINE.json config #3).

    A 132 s ``mh`` machine-hall sweep whose motion statistics match MH_03's
    committed numbers (path length 127.355 m — reference
    ``configs/EQVIO_results_EuRoC_stationary.yaml`` — mean speed 0.965 m/s,
    peaks ~2.3 m/s, yaw rates to ~0.96 rad/s), rendered at 752x480/20 Hz
    through the real EuRoC cam0 radtan calibration over a larger 6-wall
    world (more landmark churn than the V1_01 proxy), IMU corrupted at
    ADIS16448 datasheet densities with integrated bias random walks.
    Returns (sim, stats_dict); stats also written to ``proxy_info.yaml``.
    """
    sim = generate_asl_dataset(
        out_dir,
        end_time=end_time,
        imu_freq=200.0,
        frame_freq=20.0,
        width=752,
        height=480,
        num_points=1400,
        seed=seed,
        kind="mh",
        intrinsics=EUROC_CAM0_INTRINSICS,
        distortion=EUROC_CAM0_DISTORTION,
        imu_noise={
            # TRUE sensor noise at ADIS16448 datasheet densities (same
            # rationale as the V1_01 proxy: the filter keeps the reference's
            # tuned velocityNoise, the sensor does not)
            "gyr": 1.6968e-04,
            "acc": 2.0000e-03,
            "gyrBias": 1.9393e-05,
            "accBias": 3.0000e-03,
        },
        gt_freq=100.0,
        num_walls=6,
        wall_distance=2.5,
    )

    x = np.asarray(sim.poses.x)
    t = np.asarray(sim.times)
    seg = np.linalg.norm(np.diff(x, axis=0), axis=1)
    speed = seg / np.diff(t)
    R = np.asarray(sim.poses.R)
    dR = np.einsum("tij,tik->tjk", R[:-1], R[1:])
    ang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    ang_rate = ang / np.diff(t)
    mask = t[:-1] < end_time
    stats = {
        "duration_s": float(min(end_time, t[-1])),
        "path_length_m": float(seg[mask].sum()),
        "mean_speed_mps": float(speed[mask].mean()),
        "max_speed_mps": float(speed[mask].max()),
        "mean_ang_rate_radps": float(ang_rate[mask].mean()),
        "max_ang_rate_radps": float(ang_rate[mask].max()),
        "targets_mh03": {
            "duration_s": 132.0,
            "path_length_m": 127.35526466112435,
            "mean_speed_mps": 127.35526466112435 / 132.0,
        },
    }
    with open(os.path.join(out_dir, "proxy_info.yaml"), "w") as f:
        safe_dump(stats, f)
    return sim, stats


def generate_distractor_proxy(out_dir: str, end_time: float = 45.0, seed: int = 21,
                              num_distractors: int = 8):
    """Room-motion proxy with image-pinned distractor blobs — the dataset on
    which the epipolar RANSAC gate must earn its keep (its accuracy
    evidence, beside the correctness tests).

    The distractors render as strong corner-like blobs whose image motion is
    smooth (KLT tracks them) but pinned to the image plane, so their tracks
    are geometrically impossible for the camera's true motion: without the
    gate they enter the filter as false landmarks; with the gate they are
    epipolar outliers every frame.  Returns (sim, stats).
    """
    sim = generate_asl_dataset(
        out_dir,
        end_time=end_time,
        imu_freq=200.0,
        frame_freq=20.0,
        width=752,
        height=480,
        num_points=900,
        seed=seed,
        kind="room",
        intrinsics=EUROC_CAM0_INTRINSICS,
        distortion=EUROC_CAM0_DISTORTION,
        imu_noise={
            "gyr": 1.6968e-04,
            "acc": 2.0000e-03,
            "gyrBias": 1.9393e-05,
            "accBias": 3.0000e-03,
        },
        gt_freq=100.0,
        num_walls=6,
        num_distractors=num_distractors,
    )
    stats = {"duration_s": float(end_time), "num_distractors": num_distractors}
    with open(os.path.join(out_dir, "proxy_info.yaml"), "w") as f:
        safe_dump(stats, f)
    return sim, stats


def generate_uzhfpv_dataset(
    out_dir: str,
    end_time: float = 4.0,
    imu_freq: float = 200.0,
    frame_freq: float = 10.0,
    width: int = 320,
    height: int = 240,
    num_points: int = 300,
    seed: int = 0,
    kind: str = "wave",
    intrinsics: tuple | None = None,
    distortion: tuple = (0.01, -0.005, 0.001, 0.0),
    imu_noise: dict | None = None,
    num_walls: int = 4,
    wall_distance: float = 2.0,
):
    """Write a synthetic UZH-FPV-format tree (imu.txt / left_images.txt /
    kalibr camchain with equidistant model / groundtruth.txt)."""
    sim = Simulator.create(
        kind=kind, end_time=end_time + 1.0, num_points=num_points,
        num_walls=num_walls, wall_distance=wall_distance, seed=seed,
    )
    if intrinsics is None:
        fx = fy = 140.0
        cx, cy = width / 2, height / 2
    else:
        fx, fy, cx, cy = intrinsics
    dist = tuple(distortion)

    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    rng = np.random.default_rng(seed)
    amp, blob_w = _point_appearance(num_points, seed)
    t0 = 0.2

    imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
    imu = sim.get_imu_batch(jnp.asarray(imu_times))
    gyr, acc = np.asarray(imu.gyr), np.asarray(imu.acc)
    if imu_noise is not None:
        n, sqf = len(imu_times), float(np.sqrt(imu_freq))
        gyr = gyr + rng.normal(scale=imu_noise["gyr"] * sqf, size=(n, 3))
        acc = acc + rng.normal(scale=imu_noise["acc"] * sqf, size=(n, 3))
        sqdt = float(np.sqrt(1.0 / imu_freq))
        gyr += np.cumsum(rng.normal(scale=imu_noise["gyrBias"] * sqdt, size=(n, 3)), axis=0)
        acc += np.cumsum(rng.normal(scale=imu_noise["accBias"] * sqdt, size=(n, 3)), axis=0)
    with open(os.path.join(out_dir, "imu.txt"), "w") as f:
        f.write("# id timestamp wx wy wz ax ay az\n")
        for i, (t, g, a) in enumerate(zip(imu_times, gyr, acc)):
            f.write(f"{i} {t:.9f} " + " ".join(f"{v:.9f}" for v in [*g, *a]) + "\n")

    # kalibr camchain with equidistant distortion; T_cam_imu = inverse offset
    from ..camera import EquidistantCamera

    cam = EquidistantCamera.create(fx, fy, cx, cy, dist, width, height)
    T_BS = np.eye(4)
    T_BS[:3, :3] = np.asarray(sim.camera_offset.R)
    T_BS[:3, 3] = np.asarray(sim.camera_offset.x)
    T_cam_imu = np.linalg.inv(T_BS)
    with open(os.path.join(out_dir, "camchain-imucam.yaml"), "w") as f:
        safe_dump(
            {
                "cam0": {
                    "camera_model": "pinhole",
                    "distortion_model": "equidistant",
                    "intrinsics": [fx, fy, cx, cy],
                    "distortion_coeffs": list(dist),
                    "resolution": [width, height],
                    "T_cam_imu": T_cam_imu.tolist(),
                }
            },
            f,
        )

    frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
    with open(os.path.join(out_dir, "left_images.txt"), "w") as f:
        f.write("# id timestamp image_name\n")
        for i, t in enumerate(frame_times):
            pose = sim.interpolate_pose(jnp.asarray(t))
            cam_inv = se3_inv(se3_mul(pose, sim.camera_offset))
            pts = jnp.einsum("ij,pj->pi", cam_inv.R, sim.world) + cam_inv.x
            px = np.asarray(cam.project(pts))
            z = np.asarray(pts)[:, 2]
            vis = (z > 0.1) & (px[:, 0] > 0) & (px[:, 0] < width) & (px[:, 1] > 0) & (px[:, 1] < height)
            img = _render(px, vis, width, height, rng, amp, blob_w)
            name = f"img/image_{i}.png"
            write_gray(os.path.join(out_dir, name), (img * 255).astype(np.uint8))
            f.write(f"{i} {t:.9f} {name}\n")

    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# id timestamp tx ty tz qx qy qz qw\n")
        for i, t in enumerate(frame_times):
            xi = sim.full_state(jnp.asarray(float(t)))
            q = rotation_to_quaternion(np.asarray(xi.sensor.pose.R))
            p = np.asarray(xi.sensor.pose.x)
            f.write(f"{i} {t:.9f} " + " ".join(
                f"{v:.9f}" for v in [*p, q[1], q[2], q[3], q[0]]) + "\n")

    return sim


# UZH-FPV indoor (Snapdragon + fisheye) style calibration for the racing proxy
UZHFPV_CAM_INTRINSICS = (278.66, 278.48, 319.75, 241.96)
UZHFPV_CAM_DISTORTION = (-0.013721808247486035, 0.020727425669427896,
                         -0.012786476702685545, 0.0025242267320687625)


def generate_racing_proxy(out_dir: str, end_time: float = 60.0, seed: int = 13):
    """Aggressive fisheye hermetic stand-in for UZH-FPV indoor-forward.

    A 60 s drone-racing circuit (~216 m path, mean ~3.9 m/s, max ~5.8 m/s,
    yaw rates to ~1.4 rad/s — the envelope of the reference's UZH-FPV
    sequences, BASELINE.md), rendered at 640x480/30 Hz through an equidistant
    fisheye calibration, IMU at 500 Hz corrupted with the tuned UZH-FPV
    config's noise densities (configs/config_UZHFPV.yaml velocityNoise)
    including integrated bias random walks.  Returns (sim, stats_dict) and
    writes the measured motion statistics to ``proxy_info.yaml``.
    """
    sim = generate_uzhfpv_dataset(
        out_dir,
        end_time=end_time,
        imu_freq=500.0,
        frame_freq=30.0,
        width=640,
        height=480,
        num_points=1600,
        seed=seed,
        kind="racing",
        intrinsics=UZHFPV_CAM_INTRINSICS,
        distortion=UZHFPV_CAM_DISTORTION,
        imu_noise={
            # TRUE sensor noise at MEMS-datasheet magnitudes (Snapdragon
            # Flight class; same rationale as the V1_01 proxy — the filter
            # keeps the reference's tuned velocityNoise, the sensor does not)
            "gyr": 3.0e-04,
            "acc": 2.0e-03,
            "gyrBias": 4.0e-05,
            "accBias": 3.0e-03,
        },
        num_walls=6,
        wall_distance=4.0,
    )

    x = np.asarray(sim.poses.x)
    t = np.asarray(sim.times)
    seg = np.linalg.norm(np.diff(x, axis=0), axis=1)
    speed = seg / np.diff(t)
    R = np.asarray(sim.poses.R)
    dR = np.einsum("tij,tik->tjk", R[:-1], R[1:])
    ang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    mask = t[:-1] < end_time
    stats = {
        "duration_s": float(min(end_time, t[-1])),
        "path_length_m": float(seg[mask].sum()),
        "mean_speed_mps": float(speed[mask].mean()),
        "max_speed_mps": float(speed[mask].max()),
        "mean_ang_rate_radps": float((ang / np.diff(t))[mask].mean()),
        "max_ang_rate_radps": float((ang / np.diff(t))[mask].max()),
    }
    with open(os.path.join(out_dir, "proxy_info.yaml"), "w") as f:
        safe_dump(stats, f)
    return sim, stats
