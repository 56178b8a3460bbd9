"""Coordinate charts for the VIO state manifold.

Equivalent of the reference chart machinery
(``src/mathematical/VIOState.cpp:104-401``): sphere charts (stereographic and
normal), landmark point charts (euclidean / inverse-depth / normal), sensor
charts (std / SE_2(3)-coupled normal) and the assembled full-state charts.
Everything is batched over the landmark axis and safe at inactive dummy slots.

Chart convention mirrors the reference ``CoordinateChart`` template
(``Geometry.h:46-76``): ``chart(xi, xi0) -> eps`` maps a state to local
coordinates centred at origin ``xi0``; ``chart_inv(eps, xi0) -> xi`` inverts.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from .lie import (
    SE3,
    se3_exp,
    se3_inv,
    se3_log,
    se3_mul,
    se23_exp,
    se23_log,
    SE23,
    skew,
    so3_exp,
    so3_from_vectors,
)
from .states import (
    SENSOR_DIM,
    VIOSensorState,
    VIOState,
    split_coords_vector,
    state_coords_vector,
)

# ---------------------------------------------------------------------------
# Stereographic projection about e3 (reference VIOState.cpp:246-275)
# ---------------------------------------------------------------------------


def e3_project_sphere(eta: jnp.ndarray) -> jnp.ndarray:
    """Stereographic projection of ``eta`` on S^2 about the pole ``e3``."""
    denom = 1.0 - eta[..., 2]
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    return (eta[..., 0:2] - jnp.array([0.0, 0.0], dtype=eta.dtype)) / denom[..., None]


def e3_project_sphere_inv(y: jnp.ndarray) -> jnp.ndarray:
    y_sq = jnp.sum(y * y, axis=-1)
    factor = 2.0 / (y_sq + 1.0)
    eta_xy = factor[..., None] * y
    # eta = e3 + factor * (ybar - e3): z component = 1 - factor
    eta_z = 1.0 - factor
    return jnp.concatenate([eta_xy, eta_z[..., None]], axis=-1)


def e3_project_sphere_diff(eta: jnp.ndarray) -> jnp.ndarray:
    """Differential [..., 2, 3] of :func:`e3_project_sphere` at ``eta``."""
    e3 = jnp.zeros_like(eta).at[..., 2].set(1.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=eta.dtype), eta.shape + (3,))
    M = eye * (1.0 - eta[..., 2])[..., None, None] + jnp.einsum(
        "...i,...j->...ij", eta - e3, e3
    )
    denom = 1.0 - eta[..., 2]
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    return M[..., 0:2, :] / (denom * denom)[..., None, None]


def e3_project_sphere_inv_diff(y: jnp.ndarray) -> jnp.ndarray:
    """Differential [..., 3, 2] of :func:`e3_project_sphere_inv` at ``y``."""
    y_sq = jnp.sum(y * y, axis=-1)
    eye2 = jnp.broadcast_to(jnp.eye(2, dtype=y.dtype), y.shape + (2,))
    top = eye2 * (y_sq + 1.0)[..., None, None] - 2.0 * jnp.einsum("...i,...j->...ij", y, y)
    bottom = 2.0 * y[..., None, :]
    D = jnp.concatenate([top, bottom], axis=-2)
    return 2.0 * D / ((y_sq + 1.0) ** 2)[..., None, None]


# ---------------------------------------------------------------------------
# Sphere charts with arbitrary pole (reference VIOState.cpp:277-353)
# ---------------------------------------------------------------------------


class EmbeddedChart(NamedTuple):
    """Chart of S^2 with forward/inverse maps and differentials at the origin."""

    chart: Callable  # (eta, pole) -> [..., 2]
    chart_inv: Callable  # (y, pole) -> [..., 3]
    chart_diff0: Callable  # (pole) -> [..., 2, 3]
    chart_inv_diff0: Callable  # (pole) -> [..., 3, 2]


def _stereo_rot(pole):
    e3 = jnp.zeros_like(pole).at[..., 2].set(1.0)
    return so3_from_vectors(-pole, e3)


def _stereo_chart(eta, pole):
    R = _stereo_rot(pole)
    return e3_project_sphere(jnp.einsum("...ij,...j->...i", R, eta))


def _stereo_chart_inv(y, pole):
    R = _stereo_rot(pole)
    eta_rot = e3_project_sphere_inv(y)
    return jnp.einsum("...ji,...j->...i", R, eta_rot)


def _stereo_diff0(pole):
    R = _stereo_rot(pole)
    eta_rot = jnp.einsum("...ij,...j->...i", R, pole)
    return e3_project_sphere_diff(eta_rot) @ R


def _stereo_inv_diff0(pole):
    R = _stereo_rot(pole)
    zero2 = jnp.zeros(pole.shape[:-1] + (2,), dtype=pole.dtype)
    return jnp.swapaxes(R, -1, -2) @ e3_project_sphere_inv_diff(zero2)


sphere_chart_stereo = EmbeddedChart(
    _stereo_chart, _stereo_chart_inv, _stereo_diff0, _stereo_inv_diff0
)


def _normal_rot(pole):
    e3 = jnp.zeros_like(pole).at[..., 2].set(1.0)
    return so3_from_vectors(pole, e3)


def _normal_chart(eta, pole):
    e3 = jnp.zeros_like(pole).at[..., 2].set(1.0)
    R = _normal_rot(pole)
    y = jnp.einsum("...ij,...j->...i", R, eta)
    cross = jnp.cross(y, e3)
    sin_th = jnp.linalg.norm(cross, axis=-1)
    cos_th = y[..., 2]
    th = jnp.arctan2(sin_th, cos_th)
    factor = jnp.where(jnp.abs(th) < 1e-8, 1.0, th / jnp.where(sin_th < 1e-30, 1.0, sin_th))
    omega = cross * factor[..., None]
    return omega[..., 0:2]


def _normal_chart_inv(eps, pole):
    e3 = jnp.zeros_like(pole).at[..., 2].set(1.0)
    omega = jnp.concatenate([eps, jnp.zeros(eps.shape[:-1] + (1,), dtype=eps.dtype)], axis=-1)
    y = jnp.einsum("...ij,...j->...i", so3_exp(-omega), e3)
    R = _normal_rot(pole)
    return jnp.einsum("...ji,...j->...i", R, y)


def _normal_diff0(pole):
    R = _normal_rot(pole)
    D = jnp.asarray([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], dtype=pole.dtype)
    return D @ R


def _normal_inv_diff0(pole):
    R = _normal_rot(pole)
    D = jnp.asarray([[0.0, -1.0], [1.0, 0.0], [0.0, 0.0]], dtype=pole.dtype)
    return jnp.swapaxes(R, -1, -2) @ D


sphere_chart_normal = EmbeddedChart(
    _normal_chart, _normal_chart_inv, _normal_diff0, _normal_inv_diff0
)


# ---------------------------------------------------------------------------
# Landmark point charts (batched over slots; reference VIOState.cpp:153-211)
# ---------------------------------------------------------------------------


def point_chart_euclid(p, p0):
    return p - p0


def point_chart_euclid_inv(eps, p0):
    return p0 + eps


def _bearing_invdepth(p):
    r = jnp.linalg.norm(p, axis=-1)
    r = jnp.clip(r, 1e-12, None)
    return p / r[..., None], 1.0 / r


def point_chart_invdepth(p, p0):
    y, rho = _bearing_invdepth(p)
    y0, rho0 = _bearing_invdepth(p0)
    eps_b = sphere_chart_stereo.chart(y, y0)
    return jnp.concatenate([eps_b, (rho - rho0)[..., None]], axis=-1)


def point_chart_invdepth_inv(eps, p0):
    y0, rho0 = _bearing_invdepth(p0)
    y = sphere_chart_stereo.chart_inv(eps[..., 0:2], y0)
    rho = eps[..., 2] + rho0
    rho = jnp.where(rho <= 0.0, 1e-6, rho)  # reference clamp VIOState.cpp:180-183
    return y / rho[..., None]


def point_chart_normal(p, p0):
    y, rho = _bearing_invdepth(p)
    y0, rho0 = _bearing_invdepth(p0)
    eps_b = sphere_chart_normal.chart(y, y0)
    return jnp.concatenate([eps_b, jnp.log(rho / rho0)[..., None]], axis=-1)


def point_chart_normal_inv(eps, p0):
    y0, rho0 = _bearing_invdepth(p0)
    y = sphere_chart_normal.chart_inv(eps[..., 0:2], y0)
    rho = rho0 * jnp.exp(eps[..., 2])
    return y / rho[..., None]


# ---------------------------------------------------------------------------
# Sensor charts (reference VIOState.cpp:104-151)
# ---------------------------------------------------------------------------


def sensor_chart_std(xi: VIOSensorState, xi0: VIOSensorState) -> jnp.ndarray:
    eps_bias = xi.bias - xi0.bias
    eps_pose = se3_log(se3_mul(se3_inv(xi0.pose), xi.pose))
    eps_vel = xi.velocity - xi0.velocity
    eps_cam = se3_log(se3_mul(se3_inv(xi0.camera_offset), xi.camera_offset))
    return jnp.concatenate([eps_bias, eps_pose, eps_vel, eps_cam], axis=-1)


def sensor_chart_std_inv(eps: jnp.ndarray, xi0: VIOSensorState) -> VIOSensorState:
    return VIOSensorState(
        bias=xi0.bias + eps[..., 0:6],
        pose=se3_mul(xi0.pose, se3_exp(eps[..., 6:12])),
        velocity=xi0.velocity + eps[..., 12:15],
        camera_offset=se3_mul(xi0.camera_offset, se3_exp(eps[..., 15:21])),
    )


def sensor_chart_normal(xi: VIOSensorState, xi0: VIOSensorState) -> jnp.ndarray:
    A = se3_mul(se3_inv(xi0.pose), xi.pose)
    v_xi0 = jnp.einsum("...ij,...j->...i", xi0.pose.R, xi0.velocity)
    v_xi = jnp.einsum("...ij,...j->...i", xi.pose.R, xi.velocity)
    v_A = jnp.einsum("...ji,...j->...i", xi0.pose.R, v_xi - v_xi0)
    B = se3_mul(se3_inv(xi0.camera_offset), se3_mul(A, xi.camera_offset))
    eps_bias = xi.bias - xi0.bias
    eps_se23 = se23_log(SE23(A.R, A.x, v_A))
    eps_cam = se3_log(B)
    return jnp.concatenate([eps_bias, eps_se23, eps_cam], axis=-1)


def sensor_chart_normal_inv(eps: jnp.ndarray, xi0: VIOSensorState) -> VIOSensorState:
    ext = se23_exp(eps[..., 6:15])
    A = SE3(ext.R, ext.x1)
    v_A = ext.x2
    B = se3_exp(eps[..., 15:21])
    pose = se3_mul(xi0.pose, A)
    v_xi0 = jnp.einsum("...ij,...j->...i", xi0.pose.R, xi0.velocity)
    velocity = jnp.einsum(
        "...ji,...j->...i", pose.R, v_xi0 + jnp.einsum("...ij,...j->...i", xi0.pose.R, v_A)
    )
    camera_offset = se3_mul(se3_inv(A), se3_mul(xi0.camera_offset, B))
    return VIOSensorState(
        bias=xi0.bias + eps[..., 0:6], pose=pose, velocity=velocity, camera_offset=camera_offset
    )


# ---------------------------------------------------------------------------
# Full-state charts
# ---------------------------------------------------------------------------


class StateChart(NamedTuple):
    """Assembled VIO state chart (reference ``constructVIOChart``, VIOState.cpp:213-240)."""

    chart: Callable  # (xi, xi0) -> [..., 21+3N]
    chart_inv: Callable  # (eps, xi0) -> VIOState


def _make_state_chart(sensor_fwd, sensor_inv, point_fwd, point_inv) -> StateChart:
    def chart(xi: VIOState, xi0: VIOState) -> jnp.ndarray:
        eps_sensor = sensor_fwd(xi.sensor, xi0.sensor)
        eps_points = point_fwd(xi.landmarks, xi0.landmarks)
        return state_coords_vector(eps_sensor, eps_points)

    def chart_inv(eps: jnp.ndarray, xi0: VIOState) -> VIOState:
        eps_sensor, eps_points = split_coords_vector(eps, xi0.capacity)
        return VIOState(
            sensor=sensor_inv(eps_sensor, xi0.sensor),
            landmarks=point_inv(eps_points, xi0.landmarks),
            ids=xi0.ids,
            mask=xi0.mask,
        )

    return StateChart(chart, chart_inv)


state_chart_euclid = _make_state_chart(
    sensor_chart_std, sensor_chart_std_inv, point_chart_euclid, point_chart_euclid_inv
)
state_chart_invdepth = _make_state_chart(
    sensor_chart_std, sensor_chart_std_inv, point_chart_invdepth, point_chart_invdepth_inv
)
state_chart_normal = _make_state_chart(
    sensor_chart_normal, sensor_chart_normal_inv, point_chart_normal, point_chart_normal_inv
)

STATE_CHARTS = {
    "euclid": state_chart_euclid,
    "invdepth": state_chart_invdepth,
    "normal": state_chart_normal,
}


# ---------------------------------------------------------------------------
# Inter-chart differentials (reference VIOState.cpp:355-401)
# ---------------------------------------------------------------------------


def invdepth_euclid_block(p0: jnp.ndarray) -> jnp.ndarray:
    """Per-landmark 3x3 differential M_i of euclid -> invdepth coords at the origin.

    Analytic (reference ``coordinateDifferential_invdepth_euclid``,
    VIOState.cpp:355-389), batched: ``[..., N, 3] -> [..., N, 3, 3]``.
    """
    y0, rho0 = _bearing_invdepth(p0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p0.dtype), y0.shape + (3,))
    proj = eye - jnp.einsum("...i,...j->...ij", y0, y0)
    top = rho0[..., None, None] * (sphere_chart_stereo.chart_diff0(y0) @ proj)
    bottom = -(rho0 * rho0)[..., None, None] * y0[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def euclid_invdepth_block(p0: jnp.ndarray) -> jnp.ndarray:
    """Inverse blocks: invdepth -> euclid coords (reference invdepth.cpp:74-81)."""
    y0, rho0 = _bearing_invdepth(p0)
    left = sphere_chart_stereo.chart_inv_diff0(y0) / rho0[..., None, None]
    right = -(y0 / (rho0 * rho0)[..., None])[..., None]
    return jnp.concatenate([left, right], axis=-1)
