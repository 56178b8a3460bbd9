"""VIO state space with fixed-capacity masked landmarks.

Redesign of the reference state types
(``include/eqvio/mathematical/VIOState.h:41-90``): instead of a
``std::vector<Landmark>`` that grows and shrinks, landmarks live in a
fixed-capacity array ``[N, 3]`` with an activity ``mask [N]`` and id slots
``ids [N]``.  Every filter step is then a jittable pure function of static
shape; landmark add/remove are mask flips and block writes (never reshapes).

State vector layout matches the reference exactly (``euclid.cpp:103-109``):

- ``[0, 6)``   gyr/acc input bias
- ``[6, 12)``  pose (attitude, position)
- ``[12, 15)`` body-fixed velocity
- ``[15, 21)`` camera offset
- ``[21+3i, 21+3i+3)`` camera-frame landmark ``i``

Inactive landmark slots hold the dummy point ``(0, 0, 1)`` so that all chart
and lift math stays NaN-free under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .lie import SE3, se3_apply, se3_identity, se3_inv, se3_mul, so3_exp

GRAVITY = 9.80665  # reference IMUVelocity.h:26
SENSOR_DIM = 21
DUMMY_POINT = (0.0, 0.0, 1.0)


class IMU(NamedTuple):
    """An IMU reading (reference ``IMUVelocity.h:33-84``), batched over leading axes."""

    stamp: jnp.ndarray  # [...]
    gyr: jnp.ndarray  # [..., 3]
    acc: jnp.ndarray  # [..., 3]
    gyr_bias_vel: jnp.ndarray  # [..., 3]
    acc_bias_vel: jnp.ndarray  # [..., 3]

    @staticmethod
    def create(stamp, gyr, acc, gyr_bias_vel=None, acc_bias_vel=None) -> "IMU":
        gyr = jnp.asarray(gyr)
        acc = jnp.asarray(acc)
        z = jnp.zeros_like(gyr)
        return IMU(
            jnp.asarray(stamp, dtype=gyr.dtype),
            gyr,
            acc,
            z if gyr_bias_vel is None else jnp.asarray(gyr_bias_vel),
            z if acc_bias_vel is None else jnp.asarray(acc_bias_vel),
        )


class VIOSensorState(NamedTuple):
    """IMU biases, pose, body-fixed velocity and camera offset (dim 21)."""

    bias: jnp.ndarray  # [..., 6] (gyr then acc)
    pose: SE3  # IMU pose w.r.t. inertial frame
    velocity: jnp.ndarray  # [..., 3] body-fixed
    camera_offset: SE3  # camera w.r.t. IMU

    def gravity_dir(self) -> jnp.ndarray:
        """R^T e3 (reference ``VIOState.cpp:94``)."""
        return self.pose.R[..., 2, :]


class VIOState(NamedTuple):
    """Full VIO state: sensor + fixed-capacity masked camera-frame landmarks."""

    sensor: VIOSensorState
    landmarks: jnp.ndarray  # [..., N, 3] camera-frame points
    ids: jnp.ndarray  # [..., N] int32, -1 when inactive
    mask: jnp.ndarray  # [..., N] bool

    @property
    def capacity(self) -> int:
        return self.landmarks.shape[-2]

    def dim(self) -> int:
        """Static (padded) coordinate dimension 21 + 3N."""
        return SENSOR_DIM + 3 * self.capacity


def sensor_identity(dtype=jnp.float64, batch_shape=()) -> VIOSensorState:
    return VIOSensorState(
        bias=jnp.zeros(batch_shape + (6,), dtype=dtype),
        pose=se3_identity(dtype, batch_shape),
        velocity=jnp.zeros(batch_shape + (3,), dtype=dtype),
        camera_offset=se3_identity(dtype, batch_shape),
    )


def state_identity(capacity: int, dtype=jnp.float64, batch_shape=()) -> VIOState:
    return VIOState(
        sensor=sensor_identity(dtype, batch_shape),
        landmarks=jnp.broadcast_to(
            jnp.asarray(DUMMY_POINT, dtype=dtype), batch_shape + (capacity, 3)
        ),
        ids=-jnp.ones(batch_shape + (capacity,), dtype=jnp.int32),
        mask=jnp.zeros(batch_shape + (capacity,), dtype=bool),
    )


def imu_minus_bias(imu: IMU, bias: jnp.ndarray):
    """(gyr, acc) with the state's input bias removed."""
    return imu.gyr - bias[..., 0:3], imu.acc - bias[..., 3:6]


def integrate_system(state: VIOState, imu: IMU, dt) -> VIOState:
    """Discrete IMU integration of the system function.

    Second-order position update and exact body-frame landmark advection,
    matching the reference integrator (``VIOState.cpp:28-68``).
    """
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)
    dt = jnp.asarray(dt, dtype=sensor.velocity.dtype)
    dt_ = dt[..., None]

    new_bias = sensor.bias + dt_ * jnp.concatenate([imu.gyr_bias_vel, imu.acc_bias_vel], axis=-1)

    R = sensor.pose.R
    Rt = jnp.swapaxes(R, -1, -2)
    grav = jnp.zeros_like(sensor.velocity).at[..., 2].set(-GRAVITY)

    change_R = so3_exp(dt_ * gyr_est)
    inertial_disp = dt_ * jnp.einsum("...ij,...j->...i", R, sensor.velocity) + (
        0.5 * dt_ * dt_
    ) * (jnp.einsum("...ij,...j->...i", R, acc_est) + grav)
    change = SE3(change_R, jnp.einsum("...ij,...j->...i", Rt, inertial_disp))

    new_pose = se3_mul(sensor.pose, change)

    inertial_vel_diff = jnp.einsum("...ij,...j->...i", R, acc_est) + grav
    new_velocity = jnp.einsum(
        "...ji,...j->...i",
        new_pose.R,
        jnp.einsum("...ij,...j->...i", R, sensor.velocity) + dt_ * inertial_vel_diff,
    )

    # landmarks advect by the inverse camera-frame pose change
    cam_change_inv = se3_mul(
        se3_inv(sensor.camera_offset), se3_mul(se3_inv(change), sensor.camera_offset)
    )
    new_landmarks = se3_apply(
        SE3(cam_change_inv.R[..., None, :, :], cam_change_inv.x[..., None, :]),
        state.landmarks,
    )

    return VIOState(
        sensor=VIOSensorState(new_bias, new_pose, new_velocity, sensor.camera_offset),
        landmarks=new_landmarks,
        ids=state.ids,
        mask=state.mask,
    )


def measure_system(state: VIOState, camera) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project all landmark slots through the camera model.

    Returns ``(pixels [..., N, 2], valid [..., N])`` — the masked-array
    equivalent of the reference's id-keyed map (``VIOState.cpp:70-78``).
    """
    pixels = camera.project(state.landmarks)
    valid = state.mask & camera.is_in_domain(state.landmarks)
    return pixels, valid


def state_coords_vector(eps_sensor: jnp.ndarray, eps_points: jnp.ndarray) -> jnp.ndarray:
    """Pack sensor coords [...,21] and point coords [...,N,3] into [..., 21+3N]."""
    flat = eps_points.reshape(eps_points.shape[:-2] + (-1,))
    return jnp.concatenate([eps_sensor, flat], axis=-1)


def split_coords_vector(eps: jnp.ndarray, capacity: int):
    """Inverse of :func:`state_coords_vector`."""
    sensor = eps[..., :SENSOR_DIM]
    points = eps[..., SENSOR_DIM:].reshape(eps.shape[:-1] + (capacity, 3))
    return sensor, points
