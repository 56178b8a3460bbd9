"""YAML configuration with the reference's key schema.

Reads the same layered file layout as the reference
(``EQVIO_config_template.yaml``: ``eqf:`` / ``GIFT:`` / ``main:`` / ``sim:``
sections) with tolerant colon-path access and not-found warnings mirroring
``safeConfig`` (``include/eqvio/common/safeConfig.h:9-59``), and SE(3)
literals in the ``["xw", x, y, z, qw, qx, qy, qz]`` form (``LieYaml.h:16-60``).
"""

from __future__ import annotations

import sys

from ..filter import Settings
from ..frontend.tracker import TrackerConfig
from .yaml_lite import safe_load


def load_config(path: str) -> dict:
    with open(path) as f:
        return safe_load(f)


def safe_get(node, path: str, default=None, warn: bool = True):
    """Colon-path access with a warning on missing keys (safeConfig.h:24-43)."""
    cur = node
    for key in path.split(":"):
        if not isinstance(cur, dict) or key not in cur:
            if warn:
                print(f"[config] key not found: {path}", file=sys.stderr)
            return default
        cur = cur[key]
    return cur


def _se3_literal(value):
    """Parse ["xw", x, y, z, qw, qx, qy, qz] (reference LieYaml.h:16-60)."""
    if value is None:
        return (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    order = str(value[0])
    nums = [float(v) for v in value[1:]]
    if order == "xw":
        pos, quat = nums[0:3], nums[3:7]
    elif order == "wx":
        quat, pos = nums[0:4], nums[4:7]
    else:
        raise ValueError(f"unknown SE3 literal order {order!r}")
    return tuple(quat), tuple(pos)


_COORD_ALIAS = {"euclidean": "euclid", "invdepth": "invdepth", "normal": "normal"}


def settings_from_config(cfg: dict, warn: bool = False) -> Settings:
    """Build filter settings from the ``eqf:`` section using reference keys
    (``VIOFilterSettings.h:126-174``).

    ``warn=True`` reports missing keys to stderr — use in tests to guard
    config-key drift (the reference's ``test_settings.cpp:21-34``).
    """
    eqf = cfg.get("eqf", {})
    g = lambda p, d: safe_get(eqf, p, d, warn=warn)
    coord = str(g("settings:coordinateChoice", "Euclidean")).lower()
    quat, pos = _se3_literal(g("initialValue:cameraOffset", None))
    return Settings(
        bias_omega_process_var=g("processVariance:biasGyr", 0.001),
        bias_accel_process_var=g("processVariance:biasAcc", 0.001),
        attitude_process_var=g("processVariance:attitude", 0.001),
        position_process_var=g("processVariance:position", 0.001),
        velocity_process_var=g("processVariance:velocity", 0.001),
        point_process_var=g("processVariance:point", 0.001),
        camera_attitude_process_var=g("processVariance:cameraAttitude", 0.001),
        camera_position_process_var=g("processVariance:cameraPosition", 0.001),
        measurement_noise=g("measurementNoise:feature", 2.0),
        outlier_threshold_abs=g("measurementNoise:featureOutlierAbs", 1e8),
        outlier_threshold_prob=g("measurementNoise:featureOutlierProb", 1e8),
        feature_retention=g("measurementNoise:featureRetention", 0.3),
        vel_gyr_noise=g("velocityNoise:gyr", 1e-4),
        vel_acc_noise=g("velocityNoise:acc", 1e-3),
        vel_gyr_bias_walk=g("velocityNoise:gyrBias", 1e-5),
        vel_acc_bias_walk=g("velocityNoise:accBias", 1e-3),
        initial_attitude_var=g("initialVariance:attitude", 1e-4),
        initial_position_var=g("initialVariance:position", 1e-4),
        initial_velocity_var=g("initialVariance:velocity", 1e-2),
        initial_point_var=g("initialVariance:point", 1.0),
        initial_point_depth_var=g("initialVariance:pointDepth", -1.0),
        initial_bias_omega_var=g("initialVariance:biasGyr", 0.1),
        initial_bias_accel_var=g("initialVariance:biasAcc", 0.1),
        initial_camera_attitude_var=g("initialVariance:cameraAttitude", 1e-5),
        initial_camera_position_var=g("initialVariance:cameraPosition", 1e-4),
        initial_scene_depth=g("initialValue:sceneDepth", 1.0),
        use_discrete_innovation_lift=g("settings:useDiscreteInnovationLift", True),
        use_discrete_velocity_lift=g("settings:useDiscreteVelocityLift", True),
        use_discrete_state_matrix=g("settings:useDiscreteStateMatrix", False),
        # reference semantics: when fastRiccati is off and the discrete state
        # matrix is off, per-sample propagation uses the matrix exponential
        use_accurate_riccati=(
            not g("settings:fastRiccati", False)
            and not g("settings:useDiscreteStateMatrix", False)
        ),
        fast_riccati=g("settings:fastRiccati", False),
        use_median_depth=g("settings:useMedianDepth", True),
        use_feature_predictions=g("settings:useFeaturePredictions", False),
        use_equivariant_output=g("settings:useEquivariantOutput", True),
        remove_lost_landmarks=g("settings:removeLostLandmarks", True),
        # extension (no reference key, so never warn): sqrt-covariance mode
        sqrt_covariance=safe_get(eqf, "settings:useSqrtCovariance", False, warn=False),
        coordinate_choice=_COORD_ALIAS.get(coord, "euclid"),
        camera_offset_quat=quat,
        camera_offset_pos=pos,
    )


def tracker_config_from_config(cfg: dict) -> TrackerConfig:
    """Build tracker config from the ``GIFT:`` section (template keys)."""
    gift = cfg.get("GIFT", {})
    g = lambda k, d: gift.get(k, d)
    return TrackerConfig(
        max_features=int(g("maxFeatures", 30)),
        feature_dist=int(g("featureDist", 20)),
        min_harris_quality=float(g("minHarrisQuality", 0.05)),
        tracked_feature_dist=float(g("trackedFeatureDist", 20.0)),
        win_size=int(g("winSize", 21)),
        max_level=int(g("maxLevel", 3)),
        # GIFT/OpenCV express the KLT residual gate on 0-255 intensities
        # (mean abs window difference); the tracker works on 0-1 images, so
        # config values convert by /255 (reference configs carry values like
        # 76.2, EQVIO_config_EuRoC_stationary.yaml:5)
        max_error=float(g("maxError", 1e8)) / 255.0,
        feature_search_threshold=float(g("featureSearchThreshold", 1.0)),
        equalize_histogram=bool(g("equaliseImageHistogram", False)),
        flow_outlier_threshold=float(g("flowOutlierThreshold", 0.0)),
        **_ransac_kwargs(gift),
    )


def _ransac_kwargs(gift: dict) -> dict:
    """Map ``GIFT:ransacParams`` onto the batched epipolar gate.

    The reference's ``inlierThreshold`` is expressed in undistorted
    normalised-camera units (values ~1e-3, see
    ``configs/EQVIO_config_EuRoC_stationary.yaml:10-14``); the tracker gate
    works in pixels, so it is scaled by a nominal focal length (450 px,
    EuRoC-class sensors) unless ``ransacInlierThresholdPx`` is given
    explicitly.  ``maxIterations`` hypotheses run simultaneously (batched),
    so the sequential-iteration knob maps directly onto the hypothesis count.
    """
    rp = gift.get("ransacParams", None)
    if not rp:
        return {}
    nominal_focal = 450.0
    thr_px = float(gift.get("ransacInlierThresholdPx",
                            float(rp.get("inlierThreshold", 1.0 / nominal_focal))
                            * nominal_focal))
    return {
        "ransac_inlier_threshold": thr_px,
        "ransac_hypotheses": max(int(rp.get("maxIterations", 64)), 16),
        "ransac_min_inliers": int(rp.get("minInliers", 8)),
    }


def sim_params_from_config(cfg: dict) -> dict:
    """Map the ``sim:`` YAML section onto ``prepare_sim_inputs`` kwargs.

    Key names follow the reference's simulation settings
    (``SimulationDataServer.cpp:148,224-232`` and the sim block of
    ``EQVIO_config_template.yaml``): trajectory / duration / imuFreq /
    imageFreq / maxFeatures / numPoints / randomSeed / noise switches.
    """
    sim = cfg.get("sim", {}) or {}
    mapping = {
        "trajectory": ("kind", str),
        "duration": ("end_time", float),
        "imuFreq": ("imu_freq", float),
        "imageFreq": ("frame_freq", float),
        "maxFeatures": ("max_features", int),
        "numPoints": ("num_points", int),
        "numWalls": ("num_walls", int),
        "randomSeed": ("seed", int),
        "initialNoise": ("initial_noise", bool),
        "inputNoise": ("input_noise", bool),
        "outputNoise": ("output_noise", bool),
    }
    out = {}
    for key, (name, cast) in mapping.items():
        if key in sim:
            out[name] = cast(sim[key])
    return out
