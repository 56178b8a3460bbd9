"""Offline trajectory analysis: the reference ``scripts/`` equivalent.

Replaces ``scripts/analysis_tools.py`` / ``summarise_results.py``: loads the
CSV outputs written by :mod:`eqvio_tpu.io.writer` (or by the reference
binaries — same format), aligns against ground truth with SIM(3) Umeyama,
computes RMSE statistics and failure flags, and writes a ``results.yaml``
matching the reference's committed result-file schema
(``configs/EQVIO_results_EuRoC_stationary.yaml``).
"""

from __future__ import annotations

import os

import numpy as np

from .io.yaml_lite import safe_dump, safe_load
from .runner import umeyama_alignment


def load_imu_state_csv(path: str):
    """Load IMUState.csv (or the reference's identical format)."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    return {
        "t": data[:, 0],
        "position": data[:, 1:4],
        "quaternion": data[:, 4:8],  # (w, x, y, z)
        "velocity": data[:, 8:11] if data.shape[1] >= 11 else None,
    }


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Quaternion [..., 4] (w,x,y,z) -> rotation matrices [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _resample(t_src, x_src, t_dst):
    """Linear interpolation of vector series onto target stamps."""
    out = np.empty((len(t_dst),) + x_src.shape[1:])
    for j in range(x_src.shape[1]):
        out[:, j] = np.interp(t_dst, t_src, x_src[:, j])
    return out


def _stats(err: np.ndarray) -> dict:
    """rmse/mean/std/med/min/max block (analysis_tools.py:274-284)."""
    mag = np.linalg.norm(err, axis=-1) if err.ndim > 1 else np.abs(err)
    return {
        "rmse": float(np.sqrt(np.mean(mag**2))),
        "mean": float(np.mean(mag)),
        "std": float(np.std(mag)),
        "med": float(np.median(mag)),
        "min": float(np.min(mag)),
        "max": float(np.max(mag)),
    }


def analyse_trajectory(
    est_t, est_pos, est_quat, gt_t, gt_pos, gt_quat, est_vel=None, gt_vel=None
) -> dict:
    """SIM(3)-aligned trajectory error analysis (analysis_tools.py:85-183).

    Returns a dict with position/attitude/velocity stats, scale, flags.
    """
    # truncate to common time range and resample GT onto estimate stamps
    lo = max(est_t[0], gt_t[0])
    hi = min(est_t[-1], gt_t[-1])
    keep = (est_t >= lo) & (est_t <= hi)
    flags = {
        "nan": bool(np.any(np.isnan(est_pos))),
        "early_finish": bool((est_t[-1] - est_t[0]) < 0.9 * (gt_t[-1] - gt_t[0])),
    }
    est_t, est_pos, est_quat = est_t[keep], est_pos[keep], est_quat[keep]
    if est_vel is not None:
        est_vel = est_vel[keep]
    gt_pos_r = _resample(gt_t, gt_pos, est_t)
    gt_quat_r = _resample(gt_t, gt_quat, est_t)

    s, R, tr = umeyama_alignment(est_pos, gt_pos_r, with_scale=True)
    aligned = (s * (R @ est_pos.T)).T + tr
    pos_err = aligned - gt_pos_r

    # attitude error after aligning the estimate attitude by R
    R_est = quat_to_rot(est_quat)
    R_gt = quat_to_rot(gt_quat_r)
    att_err = []
    for Re, Rg in zip(R_est, R_gt):
        dR = Rg.T @ (R @ Re)
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        att_err.append(np.degrees(np.arccos(c)))
    att_err = np.asarray(att_err)

    traj_len = float(np.sum(np.linalg.norm(np.diff(gt_pos_r, axis=0), axis=-1)))

    result = {
        "position (m)": _stats(pos_err),
        "attitude (d)": _stats(att_err),
        "scale": float(s),
        "length (m)": traj_len,
        "flags": flags,
    }
    if est_vel is not None and gt_vel is not None:
        # est CSV velocity is BODY-frame (reference convention,
        # VIOState.cpp:50 integrates x via R*velocity; DatasetInfo.py:230
        # reads it raw) — rotate to world with the estimate attitude and the
        # alignment before comparing to the world-frame ground-truth velocity
        gt_vel_r = _resample(gt_t, gt_vel, est_t)
        est_vel_world = np.einsum("tij,tj->ti", R_est, est_vel)
        vel_err = (s * (R @ est_vel_world.T)).T - gt_vel_r
        result["velocity (m/s)"] = _stats(vel_err)
    return result


def load_groundtruth(gt_csv: str, fmt: str = "asl"):
    """Ground truth as ``(t [s], pos, quat wxyz, vel_or_None)``.

    Formats: ``asl`` (EuRoC comma CSV, ns stamps, quat wxyz, world velocity —
    ``ASLDatasetReader.cpp:104-126``) and ``uzhfpv`` (space-delimited
    ``id t tx ty tz qx qy qz qw`` in seconds — the reference reads it via
    ``DatasetInfo.py`` trajectory loading)."""
    if fmt == "uzhfpv":
        data = np.genfromtxt(gt_csv, ndmin=2)
        t = data[:, 1]
        pos = data[:, 2:5]
        quat = data[:, [8, 5, 6, 7]]  # xyzw -> wxyz
        return t, pos, quat, None
    data = np.genfromtxt(gt_csv, delimiter=",", skip_header=1, ndmin=2)
    vel = data[:, 8:11] if data.shape[1] >= 11 else None
    return data[:, 0] * 1e-9, data[:, 1:4], data[:, 4:8], vel


def analyse_output_dir(output_dir: str, gt_csv: str, gt_format: str = "asl") -> dict:
    """Analyse a run's output directory against a ground-truth file."""
    est = load_imu_state_csv(os.path.join(output_dir, "IMUState.csv"))
    gt_t, gt_pos, gt_quat, gt_vel = load_groundtruth(gt_csv, gt_format)
    res = analyse_trajectory(
        est["t"], est["position"], est["quaternion"],
        gt_t, gt_pos, gt_quat,
        est_vel=est["velocity"],
        gt_vel=gt_vel,
    )
    with open(os.path.join(output_dir, "results.yaml"), "w") as f:
        safe_dump(res, f)
    return res


def summarise_results(result_files: list[str]) -> dict:
    """Aggregate per-sequence results.yaml files (summarise_results.py:58-92)."""
    summary = {}
    rmses = []
    for path in result_files:
        with open(path) as f:
            res = safe_load(f)
        name = os.path.basename(os.path.dirname(path))
        summary[name] = res
        if not res["flags"]["nan"] and not res["flags"]["early_finish"]:
            rmses.append(res["position (m)"]["rmse"])
    summary["mean position rmse"] = float(np.mean(rmses)) if rmses else float("nan")
    summary["completed"] = len(rmses)
    return summary


def load_timing_csv(path: str, skip_first: int = 10) -> dict[str, np.ndarray]:
    """Load a ``timing.csv`` into {section label: per-frame milliseconds}.

    The first frames are dropped (jit compilation / cache warm-up), matching
    the reference's warm-up skip (``analyse_timing_data.py`` collect step).
    """
    with open(path) as f:
        labels = [c.strip() for c in f.readline().strip().split(",")][1:]
    data = np.genfromtxt(path, delimiter=",", skip_header=1, ndmin=2)
    data = data[skip_first:]
    return {lab: data[:, 1 + i] * 1e3 for i, lab in enumerate(labels)}


def analyse_timing(path: str, skip_first: int = 10) -> dict:
    """Per-section timing statistics (``analyse_timing_data.py:96-121``
    equivalent): mean/median/std/max milliseconds per label plus the
    headline ``mean time (ms)`` over the 'total' section."""
    timing = load_timing_csv(path, skip_first)
    out = {lab: _stats(vals[:, None]) for lab, vals in timing.items()}
    total = timing.get("total")
    if total is None:
        total = sum(timing.values())
    out["mean time (ms)"] = float(np.mean(total))
    out["fps"] = float(1e3 / max(np.mean(total), 1e-12))
    return out


def make_report(output_dir: str, gt_csv: str | None = None, fig_dir: str | None = None,
                gt_format: str = "asl") -> dict:
    """Produce the per-dataset figure set from a run's output directory.

    Mirrors the reference's offline ``analyse_dataset`` plot family
    (``analysis_tools.py:368-410``): trajectory / position error /
    velocity / biases / camera offset / feature count, plus the timing
    figures when ``timing.csv`` exists. Returns {figure name: path}.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .visualisation import plot_timing, plot_trajectory

    fig_dir = fig_dir or os.path.join(output_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    paths = {}

    est = load_imu_state_csv(os.path.join(output_dir, "IMUState.csv"))
    t = est["t"] - est["t"][0]

    gt_pos = None
    if gt_csv and os.path.exists(gt_csv):
        gt_t, gt_p, _, _ = load_groundtruth(gt_csv, gt_format)
        gt_pos = _resample(gt_t, gt_p, est["t"])

    paths["trajectory"] = plot_trajectory(
        est["position"], gt_pos, os.path.join(fig_dir, "trajectory.pdf")
    )

    if gt_pos is not None:
        s, R, tr = umeyama_alignment(est["position"], gt_pos, with_scale=True)
        err = (s * (R @ est["position"].T)).T + tr - gt_pos
        fig, ax = plt.subplots(figsize=(10, 4))
        for k, lab in enumerate("xyz"):
            ax.plot(t, err[:, k], label=lab)
        ax.plot(t, np.linalg.norm(err, axis=-1), "k", label="|err|")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("position error (m)")
        ax.legend()
        fig.savefig(os.path.join(fig_dir, "position_error.pdf"), bbox_inches="tight")
        plt.close(fig)
        paths["position_error"] = os.path.join(fig_dir, "position_error.pdf")

    fig, ax = plt.subplots(figsize=(10, 4))
    for k, lab in enumerate("xyz"):
        ax.plot(t, est["velocity"][:, k], label=f"v{lab}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("velocity (m/s)")
    ax.legend()
    fig.savefig(os.path.join(fig_dir, "velocity.pdf"), bbox_inches="tight")
    plt.close(fig)
    paths["velocity"] = os.path.join(fig_dir, "velocity.pdf")

    bias_path = os.path.join(output_dir, "bias.csv")
    if os.path.exists(bias_path):
        b = np.genfromtxt(bias_path, delimiter=",", skip_header=1, ndmin=2)
        fig, axs = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        for k, lab in enumerate("xyz"):
            axs[0].plot(b[:, 0] - b[0, 0], b[:, 1 + k], label=lab)
            axs[1].plot(b[:, 0] - b[0, 0], b[:, 4 + k], label=lab)
        axs[0].set_ylabel("gyr bias (rad/s)")
        axs[1].set_ylabel("acc bias (m/s²)")
        axs[1].set_xlabel("time (s)")
        axs[0].legend()
        fig.savefig(os.path.join(fig_dir, "biases.pdf"), bbox_inches="tight")
        plt.close(fig)
        paths["biases"] = os.path.join(fig_dir, "biases.pdf")

    cam_path = os.path.join(output_dir, "camera.csv")
    if os.path.exists(cam_path):
        c = np.genfromtxt(cam_path, delimiter=",", skip_header=1, ndmin=2)
        fig, axs = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        for k, lab in enumerate("xyz"):
            axs[0].plot(c[:, 0] - c[0, 0], c[:, 1 + k], label=lab)
        for k, lab in enumerate("wxyz"):
            axs[1].plot(c[:, 0] - c[0, 0], c[:, 4 + k], label=f"q{lab}")
        axs[0].set_ylabel("camera offset (m)")
        axs[1].set_ylabel("camera offset quat")
        axs[1].set_xlabel("time (s)")
        axs[0].legend()
        axs[1].legend(fontsize=7)
        fig.savefig(os.path.join(fig_dir, "camera_offset.pdf"), bbox_inches="tight")
        plt.close(fig)
        paths["camera_offset"] = os.path.join(fig_dir, "camera_offset.pdf")

    feat_path = os.path.join(output_dir, "features.csv")
    if os.path.exists(feat_path):
        times, counts = [], []
        with open(feat_path) as f:
            next(f)
            for line in f:
                cells = [c for c in line.strip().split(",") if c.strip()]
                times.append(float(cells[0]))
                counts.append((len(cells) - 1) // 3)
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(np.asarray(times) - times[0], counts)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("tracked features")
        fig.savefig(os.path.join(fig_dir, "features.pdf"), bbox_inches="tight")
        plt.close(fig)
        paths["features"] = os.path.join(fig_dir, "features.pdf")

    timing_path = os.path.join(output_dir, "timing.csv")
    if os.path.exists(timing_path):
        try:
            paths.update(plot_timing(load_timing_csv(timing_path), fig_dir))
        except Exception:
            pass  # too few rows after warm-up skip

    return paths
