"""The VIO symmetry group, its actions and velocity lifts.

Redesign of the reference symmetry-group layer
(``include/eqvio/mathematical/VIOGroup.h:32-179``, ``src/mathematical/VIOGroup.cpp``):
the per-landmark ``std::vector<SOT3d>`` becomes a single batched SOT(3) with
array shapes ``R: [N,3,3], a: [N]`` so every per-landmark loop in the reference
becomes one vectorised einsum over the landmark axis.

Group element: ``X = (beta in R^6, A in SE(3), w in R^3, B in SE(3), Q in SOT(3)^N)``.
Slot alignment replaces the reference's id lists: ``Q[i]`` always acts on
landmark slot ``i`` of the state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .lie import (
    SE3,
    SOT3,
    se3_Adjoint,
    se3_apply,
    se3_exp,
    se3_identity,
    se3_inv,
    se3_mul,
    se23_exp,
    so3_exp,
    so3_from_vectors,
    sot3_exp,
    sot3_identity,
    sot3_inv,
    sot3_mul,
)
from .states import GRAVITY, IMU, VIOSensorState, VIOState, imu_minus_bias


class VIOGroup(NamedTuple):
    """Symmetry group element with batched landmark transforms."""

    beta: jnp.ndarray  # [..., 6]
    A: SE3
    w: jnp.ndarray  # [..., 3]
    B: SE3
    Q: SOT3  # R: [..., N, 3, 3], a: [..., N]


class VIOAlgebra(NamedTuple):
    """Lie-algebra element of the VIO group."""

    u_beta: jnp.ndarray  # [..., 6]
    U_A: jnp.ndarray  # [..., 6]
    u_w: jnp.ndarray  # [..., 3]
    U_B: jnp.ndarray  # [..., 6]
    W: jnp.ndarray  # [..., N, 4]


def group_identity(capacity: int, dtype=jnp.float64, batch_shape=()) -> VIOGroup:
    """Identity element (reference ``VIOGroup.cpp:94-106``)."""
    return VIOGroup(
        beta=jnp.zeros(batch_shape + (6,), dtype=dtype),
        A=se3_identity(dtype, batch_shape),
        w=jnp.zeros(batch_shape + (3,), dtype=dtype),
        B=se3_identity(dtype, batch_shape),
        Q=sot3_identity(dtype, batch_shape + (capacity,)),
    )


def group_mul(x: VIOGroup, y: VIOGroup) -> VIOGroup:
    """Group product (reference ``VIOGroup.cpp:71-92``)."""
    return VIOGroup(
        beta=x.beta + y.beta,
        A=se3_mul(x.A, y.A),
        w=x.w + jnp.einsum("...ij,...j->...i", x.A.R, y.w),
        B=se3_mul(x.B, y.B),
        Q=sot3_mul(x.Q, y.Q),
    )


def group_inv(x: VIOGroup) -> VIOGroup:
    """Group inverse (reference ``VIOGroup.cpp:108-120``)."""
    ARt = jnp.swapaxes(x.A.R, -1, -2)
    return VIOGroup(
        beta=-x.beta,
        A=se3_inv(x.A),
        w=-jnp.einsum("...ij,...j->...i", ARt, x.w),
        B=se3_inv(x.B),
        Q=sot3_inv(x.Q),
    )


def algebra_scale(lam: VIOAlgebra, c) -> VIOAlgebra:
    return VIOAlgebra(lam.u_beta * c, lam.U_A * c, lam.u_w * c, lam.U_B * c, lam.W * c)


def algebra_add(a: VIOAlgebra, b: VIOAlgebra) -> VIOAlgebra:
    return VIOAlgebra(
        a.u_beta + b.u_beta, a.U_A + b.U_A, a.u_w + b.u_w, a.U_B + b.U_B, a.W + b.W
    )


def algebra_sub(a: VIOAlgebra, b: VIOAlgebra) -> VIOAlgebra:
    return algebra_add(a, algebra_scale(b, -1.0))


def group_exp(lam: VIOAlgebra) -> VIOGroup:
    """VIO group exponential; (A, w) via SE_2(3) (reference ``VIOGroup.cpp:273-290``)."""
    ext = se23_exp(
        jnp.concatenate([lam.U_A[..., 0:3], lam.U_A[..., 3:6], lam.u_w], axis=-1)
    )
    return VIOGroup(
        beta=lam.u_beta,
        A=SE3(ext.R, ext.x1),
        w=ext.x2,
        B=se3_exp(lam.U_B),
        Q=sot3_exp(lam.W),
    )


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------


def sensor_action(x: VIOGroup, sensor: VIOSensorState) -> VIOSensorState:
    """Right action on sensor states (reference ``VIOGroup.cpp:25-32``)."""
    ARt = jnp.swapaxes(x.A.R, -1, -2)
    return VIOSensorState(
        bias=sensor.bias + x.beta,
        pose=se3_mul(sensor.pose, x.A),
        velocity=jnp.einsum("...ij,...j->...i", ARt, sensor.velocity - x.w),
        camera_offset=se3_mul(se3_inv(x.A), se3_mul(sensor.camera_offset, x.B)),
    )


def state_action(x: VIOGroup, state: VIOState) -> VIOState:
    """Right action on the full state (reference ``VIOGroup.cpp:34-55``).

    Landmarks transform by ``Q_i^{-1} . p_i`` slot-aligned over the batched
    landmark axis.
    """
    Qinv = sot3_inv(x.Q)
    new_landmarks = Qinv.a[..., None] * jnp.einsum(
        "...nij,...nj->...ni", Qinv.R, state.landmarks
    )
    return VIOState(
        sensor=sensor_action(x, state.sensor),
        landmarks=new_landmarks,
        ids=state.ids,
        mask=state.mask,
    )


def output_action(x: VIOGroup, pixels: jnp.ndarray, camera) -> jnp.ndarray:
    """Action on measurements (reference ``VIOGroup.cpp:57-69``).

    Undistort to unit bearings, rotate by ``Q_i.R^{-1}``, reproject.
    ``pixels`` is slot-aligned ``[..., N, 2]``.
    """
    bearings = camera.undistort(pixels)
    rotated = jnp.einsum("...nji,...nj->...ni", x.Q.R, bearings)
    return camera.project(rotated)


# ---------------------------------------------------------------------------
# Velocity lifts
# ---------------------------------------------------------------------------


def lift_velocity(state: VIOState, imu: IMU) -> VIOAlgebra:
    """Continuous lift Lambda(xi, u) (reference ``VIOGroup.cpp:190-227``)."""
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)

    u_beta = jnp.concatenate([imu.gyr_bias_vel, imu.acc_bias_vel], axis=-1)
    U_A = jnp.concatenate([gyr_est, sensor.velocity], axis=-1)
    AdTinv = se3_Adjoint(se3_inv(sensor.camera_offset))
    U_B = jnp.einsum("...ij,...j->...i", AdTinv, U_A)
    u_w = -acc_est + sensor.gravity_dir() * GRAVITY

    # landmark transform velocities from the camera-frame velocity U_C = U_B
    omega_C = U_B[..., 0:3]
    v_C = U_B[..., 3:6]
    p = state.landmarks
    p_sq = jnp.sum(p * p, axis=-1)
    p_sq = jnp.clip(p_sq, 1e-12, None)
    w_rot = omega_C[..., None, :] + jnp.cross(
        p, jnp.broadcast_to(v_C[..., None, :], p.shape)
    ) / p_sq[..., None]
    w_scale = jnp.sum(p * v_C[..., None, :], axis=-1) / p_sq
    W = jnp.concatenate([w_rot, w_scale[..., None]], axis=-1)

    return VIOAlgebra(u_beta, U_A, u_w, U_B, W)


def lift_velocity_discrete(state: VIOState, imu: IMU, dt) -> VIOGroup:
    """Discrete lift: exact group element for one step (reference ``VIOGroup.cpp:229-271``).

    Chosen so that the group action on the state reproduces
    :func:`eqvio_tpu.states.integrate_system` exactly — the defining property
    tested in ``test/test_VIOLift.cpp:54-71``.
    """
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)
    dt = jnp.asarray(dt, dtype=sensor.velocity.dtype)
    dt_ = dt[..., None]

    beta = dt_ * jnp.concatenate([imu.gyr_bias_vel, imu.acc_bias_vel], axis=-1)

    R = sensor.pose.R
    Rt = jnp.swapaxes(R, -1, -2)
    grav = jnp.zeros_like(sensor.velocity).at[..., 2].set(-GRAVITY)
    A_R = so3_exp(dt_ * gyr_est)
    inertial_disp = dt_ * jnp.einsum("...ij,...j->...i", R, sensor.velocity) + (
        0.5 * dt_ * dt_
    ) * (jnp.einsum("...ij,...j->...i", R, acc_est) + grav)
    A = SE3(A_R, jnp.einsum("...ij,...j->...i", Rt, inertial_disp))

    B = se3_mul(se3_inv(sensor.camera_offset), se3_mul(A, sensor.camera_offset))

    body_vel_diff = acc_est - sensor.gravity_dir() * GRAVITY
    w = -dt_ * body_vel_diff

    cam_change_inv = se3_mul(
        se3_inv(sensor.camera_offset), se3_mul(se3_inv(A), sensor.camera_offset)
    )
    p0 = state.landmarks
    p1 = se3_apply(SE3(cam_change_inv.R[..., None, :, :], cam_change_inv.x[..., None, :]), p0)
    n0 = jnp.linalg.norm(p0, axis=-1)
    n1 = jnp.linalg.norm(p1, axis=-1)
    Q_R = so3_from_vectors(p1 / jnp.clip(n1, 1e-30, None)[..., None],
                           p0 / jnp.clip(n0, 1e-30, None)[..., None])
    Q_a = n0 / jnp.clip(n1, 1e-30, None)

    return VIOGroup(beta=beta, A=A, w=w, B=B, Q=SOT3(Q_R, Q_a))


def group_element_between(xi0: VIOState, xi1: VIOState) -> VIOGroup:
    """The group element L with ``phi_L(xi0) = xi1`` (transitive-action inverse).

    Generalises the single-step discrete lift (``VIOGroup.cpp:229-271``): the
    observer update for a whole IMU window collapses to integrating the
    estimate and composing with this one element — mathematically identical
    to chaining per-sample discrete lifts, at a fraction of the op count.
    """
    beta = xi1.sensor.bias - xi0.sensor.bias
    A = se3_mul(se3_inv(xi0.sensor.pose), xi1.sensor.pose)
    w = xi0.sensor.velocity - jnp.einsum(
        "...ij,...j->...i", A.R, xi1.sensor.velocity
    )
    B = se3_mul(
        se3_inv(xi0.sensor.camera_offset), se3_mul(A, xi1.sensor.camera_offset)
    )
    p0, p1 = xi0.landmarks, xi1.landmarks
    n0 = jnp.clip(jnp.linalg.norm(p0, axis=-1), 1e-30, None)
    n1 = jnp.clip(jnp.linalg.norm(p1, axis=-1), 1e-30, None)
    Q_R = so3_from_vectors(p1 / n1[..., None], p0 / n0[..., None])
    Q_a = n0 / n1
    return VIOGroup(beta, A, w, B, SOT3(Q_R, Q_a))


def group_normalize(x: VIOGroup) -> VIOGroup:
    """Project all rotation blocks back onto SO(3).

    Called after group compositions in the filter loop to stop geometric
    growth of matrix non-orthogonality through the camera-offset conjugation
    feedback (see :func:`eqvio_tpu.lie.so3_project`).
    """
    from .lie import so3_project

    return VIOGroup(
        beta=x.beta,
        A=SE3(so3_project(x.A.R), x.A.x),
        w=x.w,
        B=SE3(so3_project(x.B.R), x.B.x),
        Q=SOT3(so3_project(x.Q.R), x.Q.a),
    )


def group_has_nan(x: VIOGroup) -> jnp.ndarray:
    """NaN detector (reference ``VIOGroup.cpp:122-130``), returns a scalar bool array."""
    flags = [
        jnp.any(jnp.isnan(x.beta)),
        jnp.any(jnp.isnan(x.A.R)),
        jnp.any(jnp.isnan(x.A.x)),
        jnp.any(jnp.isnan(x.w)),
        jnp.any(jnp.isnan(x.B.R)),
        jnp.any(jnp.isnan(x.B.x)),
        jnp.any(jnp.isnan(x.Q.R)),
        jnp.any(jnp.isnan(x.Q.a)),
    ]
    return jnp.any(jnp.stack(flags))
