"""I/O layer tests: writer formats, native async writer, config parsing."""

import os

import numpy as np
import pytest

from eqvio_tpu.io import VIOWriter, load_config, settings_from_config
from eqvio_tpu.io.writer import rotation_to_quaternion


def test_rotation_quaternion_roundtrip():
    from eqvio_tpu.lie import so3_exp
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w = rng.normal(size=(10, 3))
    R = np.asarray(so3_exp(jnp.asarray(w)))
    q = rotation_to_quaternion(R)
    # rebuild rotation from quaternion
    for Ri, (qw, qx, qy, qz) in zip(R, q):
        M = np.array([
            [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx**2 + qy**2)],
        ])
        np.testing.assert_allclose(M, Ri, atol=1e-9)


@pytest.mark.parametrize("streaming", [False, True])
def test_writer_formats(tmp_path, streaming):
    if streaming:
        from eqvio_tpu.io import native

        if not native.available():
            pytest.skip("native writer unavailable")
    out = str(tmp_path / f"out_{streaming}")
    w = VIOWriter(out, streaming=streaming)
    R = np.eye(3)
    w.write_states(1.5, R, [1, 2, 3], [0.1, 0.2, 0.3], R, [0, 0, 0], np.zeros(6),
                   landmarks=np.array([[0.0, 0.0, 2.0]]), landmark_ids=np.array([7]),
                   landmark_mask=np.array([True]))
    w.write_features(1.5, np.array([[100.0, 200.0]]), np.array([7]), np.array([True]))
    w.flush()

    lines = open(os.path.join(out, "IMUState.csv")).read().splitlines()
    assert lines[0] == "time, px, py, pz, qw, qx, qy, qz, vx, vy, vz"
    vals = [float(v) for v in lines[1].split(",")]
    assert vals[:4] == [1.5, 1.0, 2.0, 3.0]
    assert vals[4] == 1.0  # qw of identity

    feats = open(os.path.join(out, "features.csv")).read().splitlines()
    assert feats[0] == "time, z1id, z1x, z1y, ..."
    assert feats[1].split(",")[1].strip() == "7"

    pts = open(os.path.join(out, "points.csv")).read().splitlines()
    # world point = R*p + x = (1, 2, 5)
    vals = [float(v) for v in pts[1].split(",")[2:]]
    np.testing.assert_allclose(vals, [1.0, 2.0, 5.0], atol=1e-9)


def test_config_parsing(tmp_path):
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml")
    cfg = load_config(cfg_path)
    s = settings_from_config(cfg)
    assert s.coordinate_choice == "euclid"
    assert s.initial_point_var == 5000.0
    assert s.measurement_noise == 2.0
    assert s.use_equivariant_output is True

    # SE3 literal parsing
    cfg["eqf"]["initialValue"]["cameraOffset"] = ["xw", 0.1, 0.2, 0.3, 1.0, 0.0, 0.0, 0.0]
    s2 = settings_from_config(cfg)
    assert s2.camera_offset_pos == (0.1, 0.2, 0.3)
    assert s2.camera_offset_quat == (1.0, 0.0, 0.0, 0.0)


def test_native_image_loader(tmp_path):
    """Native PNG prefetcher decodes identically to PIL."""
    from eqvio_tpu.data import native_loader

    if not native_loader.available():
        pytest.skip("native image loader unavailable")
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    imgs = []
    for k in range(4):
        img = (rng.uniform(0, 255, size=(48, 64))).astype(np.uint8)
        p = str(tmp_path / f"f{k}.png")
        Image.fromarray(img, mode="L").save(p)
        paths.append(p)
        imgs.append(img)

    loader = native_loader.NativeImageLoader(paths, queue_size=2)
    seen = {}
    for idx, arr in loader:
        seen[idx] = arr
    loader.close()
    assert sorted(seen) == [0, 1, 2, 3]
    for k in range(4):
        # canonical in-flight format is uint8 (4x less host->device traffic)
        assert seen[k].dtype == np.uint8
        np.testing.assert_array_equal(seen[k], imgs[k])


def test_template_config_has_all_keys(capsys):
    """The template config covers every settings key — no not-found warnings
    (reference test_settings.cpp:21-34 guards config-key drift)."""
    import sys

    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", "config_template.yaml")
    cfg = load_config(cfg_path)
    settings_from_config(cfg, warn=True)
    err = capsys.readouterr().err
    # allowed gaps: optional keys the template intentionally omits
    allowed = {"initialValue:cameraOffset"}
    missing = {
        line.split("key not found: ")[1]
        for line in err.splitlines()
        if "key not found" in line
    }
    assert missing <= allowed, f"template missing keys: {missing - allowed}"


@pytest.mark.parametrize("name", ["config_EuRoC.yaml", "config_UZHFPV.yaml"])
def test_shipped_configs_parse_clean(name, capsys):
    """Every shipped tuned config parses with zero not-found warnings
    (config-key drift guard over the full config set)."""
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", name)
    cfg = load_config(cfg_path)
    settings = settings_from_config(cfg, warn=True)
    err = capsys.readouterr().err
    allowed = {"initialValue:cameraOffset"}
    missing = {
        line.split("key not found: ")[1]
        for line in err.splitlines()
        if "key not found" in line
    }
    assert missing <= allowed, f"{name} missing keys: {missing - allowed}"
    # tuned switches survive the round-trip
    assert settings.coordinate_choice == "invdepth"
    assert settings.fast_riccati is True

    from eqvio_tpu.io import tracker_config_from_config
    tcfg = tracker_config_from_config(cfg)
    assert 0 < tcfg.feature_search_threshold <= 1.0


REF_CONFIGS = "/root/reference/configs"
REPO_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.mark.skipif(not os.path.isdir(REF_CONFIGS), reason="reference tree not mounted")
@pytest.mark.parametrize(
    "ref_name,our_name",
    [
        ("EQVIO_config_EuRoC_stationary.yaml", "config_EuRoC.yaml"),
        ("EQVIO_config_UZHFPV.yaml", "config_UZHFPV.yaml"),
    ],
)
def test_config_value_parity_with_reference(ref_name, our_name):
    """Every tuned scalar in our shipped configs must parse to EXACTLY the
    same Settings/TrackerConfig as the reference's shipped configs do through
    the same key map (the EuRoC run lives or dies on these values)."""
    from eqvio_tpu.io import tracker_config_from_config

    ref = load_config(os.path.join(REF_CONFIGS, ref_name))
    ours = load_config(os.path.join(REPO_CONFIGS, our_name))
    s_ref = settings_from_config(ref)
    s_ours = settings_from_config(ours)
    assert s_ref == s_ours, {
        k: (getattr(s_ref, k), getattr(s_ours, k))
        for k in s_ref.__dataclass_fields__
        if getattr(s_ref, k) != getattr(s_ours, k)
    }
    t_ref = tracker_config_from_config(ref)
    t_ours = tracker_config_from_config(ours)
    assert t_ref == t_ours, (t_ref, t_ours)
