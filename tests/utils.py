"""Shared test fixtures: random state/group generators and metrics.

Mirrors the reference test utilities (``test/testing_utilities.cpp:24-173``):
"reasonable" states keep landmarks in front of the camera (z ~ 20) and group
elements near the identity.
"""

import jax.numpy as jnp
import numpy as np

from eqvio_tpu.camera import default_test_camera
from eqvio_tpu.group import VIOGroup, group_mul
from eqvio_tpu.lie import SE3, SOT3, se3_exp, so3_exp
from eqvio_tpu.states import IMU, VIOSensorState, VIOState


def reasonable_state(rng, n: int, n_active: int | None = None) -> VIOState:
    """Random state with landmarks pushed to z ~ 20 (testing_utilities.cpp:63-75)."""
    if n_active is None:
        n_active = n
    sensor = VIOSensorState(
        bias=jnp.asarray(rng.normal(size=6) * 0.01),
        pose=se3_exp(jnp.asarray(rng.normal(size=6) * 0.3)),
        velocity=jnp.asarray(rng.normal(size=3)),
        camera_offset=se3_exp(jnp.asarray(rng.normal(size=6) * 0.1)),
    )
    landmarks = rng.uniform(-1, 1, size=(n, 3)) * 10.0 + np.array([0.0, 0.0, 20.0])
    landmarks[n_active:] = np.array([0.0, 0.0, 1.0])
    mask = np.zeros(n, dtype=bool)
    mask[:n_active] = True
    ids = np.where(mask, np.arange(n), -1).astype(np.int32)
    return VIOState(sensor, jnp.asarray(landmarks), jnp.asarray(ids), jnp.asarray(mask))


def reasonable_group(rng, n: int) -> VIOGroup:
    """Group element near the identity (testing_utilities.cpp:100-124)."""
    return VIOGroup(
        beta=jnp.asarray(rng.normal(size=6) * 0.01),
        A=se3_exp(jnp.asarray(rng.normal(size=6) * 0.1)),
        w=jnp.asarray(rng.normal(size=3) * 0.1),
        B=se3_exp(jnp.asarray(rng.normal(size=6) * 0.1)),
        Q=SOT3(
            so3_exp(jnp.asarray(rng.normal(size=(n, 3)) * 0.1)),
            jnp.exp(jnp.asarray(rng.normal(size=n) * 0.1)),
        ),
    )


def random_group(rng, n: int) -> VIOGroup:
    """Fully random group element (testing_utilities.cpp:100-110)."""
    return VIOGroup(
        beta=jnp.asarray(rng.normal(size=6)),
        A=se3_exp(jnp.asarray(rng.normal(size=6))),
        w=jnp.asarray(rng.normal(size=3)),
        B=se3_exp(jnp.asarray(rng.normal(size=6))),
        Q=SOT3(
            so3_exp(jnp.asarray(rng.normal(size=(n, 3)))),
            jnp.exp(jnp.asarray(rng.normal(size=n) * 0.5)),
        ),
    )


def random_imu(rng) -> IMU:
    return IMU.create(
        0.0, jnp.asarray(rng.normal(size=3)), jnp.asarray(rng.normal(size=3))
    )


def state_distance(a: VIOState, b: VIOState) -> float:
    """Max-norm distance over all active components (testing_utilities.cpp:126-150)."""
    d = [
        np.abs(a.sensor.bias - b.sensor.bias).max(),
        np.abs(a.sensor.pose.R - b.sensor.pose.R).max(),
        np.abs(a.sensor.pose.x - b.sensor.pose.x).max(),
        np.abs(a.sensor.velocity - b.sensor.velocity).max(),
        np.abs(a.sensor.camera_offset.R - b.sensor.camera_offset.R).max(),
        np.abs(a.sensor.camera_offset.x - b.sensor.camera_offset.x).max(),
    ]
    lm_err = np.abs(np.asarray(a.landmarks - b.landmarks))
    active = np.asarray(a.mask)
    if active.any():
        d.append(lm_err[active].max())
    return max(d)


def group_distance(a: VIOGroup, b: VIOGroup) -> float:
    d = [
        np.abs(a.beta - b.beta).max(),
        np.abs(a.A.R - b.A.R).max(),
        np.abs(a.A.x - b.A.x).max(),
        np.abs(a.w - b.w).max(),
        np.abs(a.B.R - b.B.R).max(),
        np.abs(a.B.x - b.B.x).max(),
        np.abs(a.Q.R - b.Q.R).max(),
        np.abs(a.Q.a - b.Q.a).max(),
    ]
    return max(d)


camera = default_test_camera


# --------------------------------------------------------------------------
# plain numpy pyramidal Lucas-Kanade: an independent reference for
# ``frontend.klt`` (same clamp-per-sample bilinear sampling and update rule,
# written as loops over features and levels)


def np_bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sample with per-sample clamping to the image (edge
    replication), as GIFT's KLT samples windows that cross the border."""
    h, w = img.shape
    x = np.clip(x, 0.0, w - 1.001)
    y = np.clip(y, 0.0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def np_track_level(img0, img1, pos, guess, win: int, iters: int):
    """One level of LK for one feature: ``(position, mean |residual|)``."""
    offs = np.arange(win) - (win - 1) / 2.0
    ox, oy = np.meshgrid(offs, offs)
    tx, ty = pos[0] + ox, pos[1] + oy
    template = np_bilinear(img0, tx, ty)
    gx = np_bilinear(img0, tx + 1.0, ty) - np_bilinear(img0, tx - 1.0, ty)
    gy = np_bilinear(img0, tx, ty + 1.0) - np_bilinear(img0, tx, ty - 1.0)
    gxx, gxy, gyy = (gx * gx).sum(), (gx * gy).sum(), (gy * gy).sum()
    det = gxx * gyy - gxy * gxy
    det = 1e-12 if abs(det) < 1e-12 else det
    p, err = np.array(guess, dtype=float), np.inf
    for _ in range(iters):
        diff = np_bilinear(img1, p[0] + ox, p[1] + oy) - template
        bx, by = (diff * gx).sum(), (diff * gy).sum()
        p = p - np.array([gyy * bx - gxy * by, gxx * by - gxy * bx]) / det
        err = np.abs(diff).mean()
    return p, err


def np_track_features(pyr0, pyr1, positions, guesses, win: int, iters: int = 8):
    """Coarse-to-fine LK over the pyramids for every feature."""
    levels = len(pyr0)
    pyr0 = [np.asarray(p, dtype=float) for p in pyr0]
    pyr1 = [np.asarray(p, dtype=float) for p in pyr1]
    out, errs = [], []
    for pos, guess in zip(np.asarray(positions, float), np.asarray(guesses, float)):
        p, err = guess / 2.0 ** (levels - 1), np.inf
        for lvl in range(levels - 1, -1, -1):
            if lvl < levels - 1:
                p = p * 2.0
            p, err = np_track_level(pyr0[lvl], pyr1[lvl], pos / 2.0**lvl, p, win, iters)
        out.append(p)
        errs.append(err)
    return np.array(out), np.array(errs)
