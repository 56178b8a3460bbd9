"""EqF linearisation matrices A, B, C and innovation lifts.

Redesign of the reference matrix suites
(``include/eqvio/mathematical/EqFMatrices.h:35-90``,
``src/mathematical/coordinateSuite/{euclid,invdepth,normal}.cpp``): the
reference's per-landmark 3x3/3x6/2x3 loops become batched einsums over the
landmark axis, and the function-pointer table becomes a :class:`CoordinateSuite`
of pure functions chosen statically by chart name.

State-vector layout (see ``eqvio_tpu.states``): bias 6 | pose 6 | vel 3 |
camera offset 6 | landmarks 3N.  Inactive landmark slots have their rows and
columns masked to zero so they stay decoupled from the active filter.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .charts import (
    STATE_CHARTS,
    StateChart,
    euclid_invdepth_block,
    invdepth_euclid_block,
    sphere_chart_normal,
)
from .group import (
    VIOAlgebra,
    VIOGroup,
    group_inv,
    group_mul,
    lift_velocity_discrete,
    state_action,
)
from .lie import (
    SOT3,
    se3_Adjoint,
    se3_adjoint,
    se3_exp,
    se3_inv,
    se3_mul,
    skew,
    so3_from_vectors,
)
from .states import GRAVITY, IMU, SENSOR_DIM, VIOState, split_coords_vector

# ---------------------------------------------------------------------------
# Euclid suite (reference euclid.cpp)
# ---------------------------------------------------------------------------


def _mask_f(xi0: VIOState):
    return xi0.mask.astype(xi0.landmarks.dtype)


def _landmark_common(X: VIOGroup, xi0: VIOState, xi_hat: VIOState):
    """Shared per-landmark quantities for A/B builders."""
    Qhat = X.Q.R * X.Q.a[..., None, None]  # [N,3,3]
    Qhat_inv = jnp.swapaxes(X.Q.R, -1, -2) / X.Q.a[..., None, None]
    return Qhat, Qhat_inv


def input_matrix_B_euclid(X: VIOGroup, xi0: VIOState) -> jnp.ndarray:
    """Input matrix B_t [D, 12] (reference ``euclid.cpp:186-233``), masked."""
    N = xi0.capacity
    D = SENSOR_DIM + 3 * N
    dtype = xi0.landmarks.dtype
    xi_hat = state_action(X, xi0)
    R_A = X.A.R

    B = jnp.zeros((D, 12), dtype=dtype)
    B = B.at[0:6, 6:12].set(jnp.eye(6, dtype=dtype))
    B = B.at[6:9, 0:3].set(R_A)
    B = B.at[9:12, 0:3].set(skew(X.A.x) @ R_A)
    B = B.at[12:15, 0:3].set(R_A @ skew(xi_hat.sensor.velocity))
    B = B.at[12:15, 3:6].set(R_A)

    Qhat, _ = _landmark_common(X, xi0, xi_hat)
    RT_IC = jnp.swapaxes(xi_hat.sensor.camera_offset.R, -1, -2)
    x_IC = xi_hat.sensor.camera_offset.x
    qhat = xi_hat.landmarks  # [N,3]
    lm_gyr = Qhat @ (skew(qhat) @ RT_IC + RT_IC @ skew(x_IC))  # [N,3,3]
    lm_gyr = lm_gyr * _mask_f(xi0)[..., None, None]
    B = B.at[SENSOR_DIM:, 0:3].set(lm_gyr.reshape(3 * N, 3))
    return B


def _A_sensor_and_terms(X: VIOGroup, xi0: VIOState, imu: IMU):
    """Sensor-block pieces of A and the common landmark terms."""
    xi_hat = state_action(X, xi0)
    gyr_est = imu.gyr - xi_hat.sensor.bias[..., 0:3]
    U_I = jnp.concatenate([gyr_est, xi_hat.sensor.velocity], axis=-1)
    AdT0inv = se3_Adjoint(se3_inv(xi0.sensor.camera_offset))
    AdA = se3_Adjoint(X.A)
    ad_term = se3_adjoint(AdT0inv @ (AdA @ U_I))  # [6,6]
    common = se3_Adjoint(se3_inv(X.B)) @ ad_term  # [6,6]
    U_C = se3_Adjoint(se3_inv(xi_hat.sensor.camera_offset)) @ U_I
    v_C = U_C[..., 3:6]
    return xi_hat, ad_term, common, v_C


def _A_landmark_blocks_euclid(X: VIOGroup, xi0: VIOState, xi_hat, common, v_C):
    """Batched landmark blocks of A (reference ``euclid.cpp:128-155``)."""
    Qhat, Qhat_inv = _landmark_common(X, xi0, xi_hat)
    R_IC = xi_hat.sensor.camera_offset.R
    R_Ahat = X.A.R
    # effect of velocity cov on landmark cov: [N,3,3]
    lm_vel = -(Qhat @ jnp.swapaxes(R_IC, -1, -2) @ jnp.swapaxes(R_Ahat, -1, -2))
    # effect of camera-offset cov: [N,3,6]
    q0 = xi0.landmarks
    temp = jnp.concatenate(
        [skew(q0) @ X.Q.R, -X.Q.a[..., None, None] * X.Q.R], axis=-1
    )  # [N,3,6]
    lm_cam = temp @ common
    # landmark self-term: [N,3,3]
    qhat = xi_hat.landmarks
    qhat_sq = jnp.clip(jnp.sum(qhat * qhat, axis=-1), 1e-12, None)
    inner = (
        skew(qhat) @ skew(jnp.broadcast_to(v_C, qhat.shape))
        - 2.0 * jnp.einsum("...i,...j->...ij", jnp.broadcast_to(v_C, qhat.shape), qhat)
        + jnp.einsum("...i,...j->...ij", qhat, jnp.broadcast_to(v_C, qhat.shape))
    )
    lm_diag = -(Qhat @ inner @ Qhat_inv) / qhat_sq[..., None, None]
    return lm_vel, lm_cam, lm_diag


def _assemble_A(xi0: VIOState, B_full, ad_term, lm_vel, lm_cam, lm_diag):
    """Scatter blocks into the dense [D, D] state matrix, masking inactive slots."""
    N = xi0.capacity
    D = SENSOR_DIM + 3 * N
    dtype = xi0.landmarks.dtype
    mask = _mask_f(xi0)

    A = jnp.zeros((D, D), dtype=dtype)
    # effect of bias: A[:, 0:6] = -B[:, 0:6] (masked already via B)
    A = A.at[:, 0:6].set(-B_full[:, 0:6])
    A = A.at[9:12, 12:15].set(jnp.eye(3, dtype=dtype))
    g0 = xi0.sensor.gravity_dir()
    A = A.at[12:15, 6:9].set(-GRAVITY * skew(g0))
    A = A.at[15:21, 15:21].set(ad_term)

    lm_rows = jnp.zeros((N, 3, D), dtype=dtype)
    lm_rows = lm_rows.at[:, :, 0:6].set(A[SENSOR_DIM:, 0:6].reshape(N, 3, 6))
    lm_rows = lm_rows.at[:, :, 12:15].set(lm_vel)
    lm_rows = lm_rows.at[:, :, 15:21].set(lm_cam)
    diag = jnp.zeros((N, 3, N, 3), dtype=dtype)
    idx = jnp.arange(N)
    diag = diag.at[idx, :, idx, :].set(lm_diag)
    lm_rows = lm_rows.at[:, :, SENSOR_DIM:].set(diag.reshape(N, 3, 3 * N))
    lm_rows = lm_rows * mask[:, None, None]
    A = A.at[SENSOR_DIM:, :].set(lm_rows.reshape(3 * N, D))
    return A


def state_matrix_A_euclid(X: VIOGroup, xi0: VIOState, imu: IMU) -> jnp.ndarray:
    """State matrix A0_t [D, D] (reference ``euclid.cpp:99-160``)."""
    B_full = input_matrix_B_euclid(X, xi0)
    xi_hat, ad_term, common, v_C = _A_sensor_and_terms(X, xi0, imu)
    lm_vel, lm_cam, lm_diag = _A_landmark_blocks_euclid(X, xi0, xi_hat, common, v_C)
    return _assemble_A(xi0, B_full, ad_term, lm_vel, lm_cam, lm_diag)


def _DRho(y_bearing: jnp.ndarray, camera) -> jnp.ndarray:
    """DRho(y) = projJac(y) @ [skew(y) | 0]: [..., 2, 4] (reference euclid.cpp:173-178)."""
    S = skew(y_bearing)
    zero = jnp.zeros(y_bearing.shape[:-1] + (3, 1), dtype=y_bearing.dtype)
    M = jnp.concatenate([S, zero], axis=-1)  # [...,3,4]
    return camera.projection_jacobian(y_bearing) @ M


def output_matrix_Ci_star_euclid(
    q0: jnp.ndarray, Q: SOT3, camera, y_pixels: jnp.ndarray
) -> jnp.ndarray:
    """Equivariant output matrix C*_i [..., 2, 3] (reference ``euclid.cpp:162-184``)."""
    q_sq = jnp.clip(jnp.sum(q0 * q0, axis=-1), 1e-12, None)
    m2g = jnp.concatenate([-skew(q0), -q0[..., None, :]], axis=-2) / q_sq[..., None, None]
    Qinv_R = jnp.swapaxes(Q.R, -1, -2)
    q_hat = jnp.einsum("...ij,...j->...i", Qinv_R, q0) / Q.a[..., None]
    y_hat = q_hat / jnp.clip(jnp.linalg.norm(q_hat, axis=-1, keepdims=True), 1e-12, None)
    y_tru = camera.undistort(y_pixels)

    # Ad_{Q^{-1}} as [..., 4, 4] = blockdiag(R^T, 1)
    AdQinv = jnp.zeros(Q.R.shape[:-2] + (4, 4), dtype=Q.R.dtype)
    AdQinv = AdQinv.at[..., 0:3, 0:3].set(Qinv_R)
    AdQinv = AdQinv.at[..., 3, 3].set(1.0)

    return 0.5 * (_DRho(y_tru, camera) + _DRho(y_hat, camera)) @ AdQinv @ m2g


def output_matrix_Ci_euclid(q0: jnp.ndarray, Q: SOT3, camera) -> jnp.ndarray:
    """Non-equivariant C_i: evaluate C*_i at the estimated output (EqFMatrices.cpp:84-89)."""
    Qinv_R = jnp.swapaxes(Q.R, -1, -2)
    q_hat = jnp.einsum("...ij,...j->...i", Qinv_R, q0) / Q.a[..., None]
    y_hat = camera.project(q_hat)
    return output_matrix_Ci_star_euclid(q0, Q, camera, y_hat)


def lift_innovation_euclid(Gamma: jnp.ndarray, xi0: VIOState) -> VIOAlgebra:
    """Continuous innovation lift (reference ``euclid.cpp:36-69``)."""
    u_beta = Gamma[..., 0:6]
    U_A = Gamma[..., 6:12]
    gamma_v = Gamma[..., 12:15]
    u_w = -gamma_v - jnp.cross(U_A[..., 0:3], xi0.sensor.velocity)
    AdT0inv = se3_Adjoint(se3_inv(xi0.sensor.camera_offset))
    U_B = Gamma[..., 15:21] + jnp.einsum("...ij,...j->...i", AdT0inv, U_A)

    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    q_sq = jnp.clip(jnp.sum(q0 * q0, axis=-1), 1e-12, None)
    w_rot = -jnp.cross(q0, gamma_q) / q_sq[..., None]
    w_scale = -jnp.sum(q0 * gamma_q, axis=-1) / q_sq
    W = jnp.concatenate([w_rot, w_scale[..., None]], axis=-1)
    return VIOAlgebra(u_beta, U_A, u_w, U_B, W)


def lift_innovation_discrete_euclid(Gamma: jnp.ndarray, xi0: VIOState) -> VIOGroup:
    """Discrete innovation lift (reference ``euclid.cpp:71-97``)."""
    beta = Gamma[..., 0:6]
    A = se3_exp(Gamma[..., 6:12])
    w = xi0.sensor.velocity - jnp.einsum(
        "...ij,...j->...i", A.R, xi0.sensor.velocity + Gamma[..., 12:15]
    )
    T0 = xi0.sensor.camera_offset
    B = se3_mul(se3_inv(T0), se3_mul(A, se3_mul(T0, se3_exp(Gamma[..., 15:21]))))

    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    q1 = q0 + gamma_q
    n0 = jnp.clip(jnp.linalg.norm(q0, axis=-1), 1e-12, None)
    n1 = jnp.clip(jnp.linalg.norm(q1, axis=-1), 1e-12, None)
    Q_R = so3_from_vectors(q1 / n1[..., None], q0 / n0[..., None])
    Q_a = n0 / n1
    return VIOGroup(beta, A, w, B, SOT3(Q_R, Q_a))


# ---------------------------------------------------------------------------
# Inverse-depth suite (reference invdepth.cpp): conjugate landmark blocks
# ---------------------------------------------------------------------------


def input_matrix_B_invdepth(X: VIOGroup, xi0: VIOState) -> jnp.ndarray:
    B = input_matrix_B_euclid(X, xi0)
    N = xi0.capacity
    conv = invdepth_euclid_block(xi0.landmarks)  # [N,3,3]
    lm = B[SENSOR_DIM:, :].reshape(N, 3, 12)
    return B.at[SENSOR_DIM:, :].set((conv @ lm).reshape(3 * N, 12))


def state_matrix_A_invdepth(X: VIOGroup, xi0: VIOState, imu: IMU) -> jnp.ndarray:
    B_full = input_matrix_B_invdepth(X, xi0)
    xi_hat, ad_term, common, v_C = _A_sensor_and_terms(X, xi0, imu)
    lm_vel, lm_cam, lm_diag = _A_landmark_blocks_euclid(X, xi0, xi_hat, common, v_C)
    e2i = invdepth_euclid_block(xi0.landmarks)
    i2e = euclid_invdepth_block(xi0.landmarks)
    return _assemble_A(xi0, B_full, ad_term, e2i @ lm_vel, e2i @ lm_cam, e2i @ lm_diag @ i2e)


def output_matrix_Ci_star_invdepth(q0, Q, camera, y_pixels) -> jnp.ndarray:
    return output_matrix_Ci_star_euclid(q0, Q, camera, y_pixels) @ euclid_invdepth_block(q0)


def output_matrix_Ci_invdepth(q0, Q, camera) -> jnp.ndarray:
    return output_matrix_Ci_euclid(q0, Q, camera) @ euclid_invdepth_block(q0)


def lift_innovation_invdepth(Gamma: jnp.ndarray, xi0: VIOState) -> VIOAlgebra:
    """Innovation lift in inverse-depth coords (reference ``invdepth.cpp:183-223``)."""
    eps_sensor, gamma_ind = split_coords_vector(Gamma, xi0.capacity)
    i2e = euclid_invdepth_block(xi0.landmarks)
    gamma_euc = jnp.einsum("...nij,...nj->...ni", i2e, gamma_ind)
    Gamma_euc = jnp.concatenate(
        [eps_sensor, gamma_euc.reshape(gamma_euc.shape[:-2] + (-1,))], axis=-1
    )
    return lift_innovation_euclid(Gamma_euc, xi0)


def lift_innovation_discrete_invdepth(Gamma: jnp.ndarray, xi0: VIOState) -> VIOGroup:
    """Discrete lift via the invdepth point chart inverse (reference ``invdepth.cpp:225-253``)."""
    from .charts import point_chart_invdepth_inv

    beta = Gamma[..., 0:6]
    A = se3_exp(Gamma[..., 6:12])
    w = xi0.sensor.velocity - jnp.einsum(
        "...ij,...j->...i", A.R, xi0.sensor.velocity + Gamma[..., 12:15]
    )
    T0 = xi0.sensor.camera_offset
    B = se3_mul(se3_inv(T0), se3_mul(A, se3_mul(T0, se3_exp(Gamma[..., 15:21]))))

    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    q1 = point_chart_invdepth_inv(gamma_q, q0)
    n0 = jnp.clip(jnp.linalg.norm(q0, axis=-1), 1e-12, None)
    n1 = jnp.clip(jnp.linalg.norm(q1, axis=-1), 1e-12, None)
    Q_R = so3_from_vectors(q1 / n1[..., None], q0 / n0[..., None])
    Q_a = n0 / n1
    return VIOGroup(beta, A, w, B, SOT3(Q_R, Q_a))


# ---------------------------------------------------------------------------
# Normal suite (reference normal.cpp): conjugate euclid via the exact Jacobian
# of the chart transition map, computed with jax.jacfwd instead of the
# reference's central differences (VIOState.cpp:391-401).
# ---------------------------------------------------------------------------


def normal_euclid_sensor_differential(xi0: VIOState) -> jnp.ndarray:
    """Sensor block [21, 21] of d(normal o euclid^{-1}) at 0, by forward AD.

    The chart transition is exactly block diagonal — the normal sensor chart
    touches only sensor components and the landmark charts act slot-wise — so
    only this block needs AD; the landmark blocks are analytic
    (:func:`normal_euclid_point_blocks`).  The reference instead differences
    the full dense map (``VIOState.cpp:391-401``) and inverts it dense
    (``normal.cpp:37-55``) — an O(D^3) tax this layout avoids.
    """
    from .charts import sensor_chart_normal, sensor_chart_std_inv

    s0 = xi0.sensor

    def f(eps_s):
        return sensor_chart_normal(sensor_chart_std_inv(eps_s, s0), s0)

    return jax.jacfwd(f)(jnp.zeros(SENSOR_DIM, dtype=xi0.landmarks.dtype))


def normal_euclid_point_blocks(p0: jnp.ndarray) -> jnp.ndarray:
    """Per-landmark blocks [N, 3, 3] of d(normal o euclid^{-1}) at 0, analytic.

    Rows 0:2: sphere-normal chart differential of the bearing,
    d y/d p = (I - y0 y0^T)/r0; row 2: d log(rho)/d p = -y0^T/r0.
    """
    r0 = jnp.clip(jnp.linalg.norm(p0, axis=-1), 1e-12, None)
    y0 = p0 / r0[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p0.dtype), p0.shape + (3,))
    P = (eye - jnp.einsum("...i,...j->...ij", y0, y0)) / r0[..., None, None]
    top = sphere_chart_normal.chart_diff0(y0) @ P  # [N, 2, 3]
    bot = -(y0 / r0[..., None])[..., None, :]  # [N, 1, 3]
    return jnp.concatenate([top, bot], axis=-2)


def euclid_normal_sensor_differential(xi0: VIOState) -> jnp.ndarray:
    """Sensor block [21, 21] of the INVERSE transition d(euclid o normal^{-1})
    at 0 — the exact inverse of :func:`normal_euclid_sensor_differential`
    (mutually inverse diffeomorphisms have inverse Jacobians at 0)."""
    from .charts import sensor_chart_normal_inv, sensor_chart_std

    s0 = xi0.sensor

    def f(eps_s):
        return sensor_chart_std(sensor_chart_normal_inv(eps_s, s0), s0)

    return jax.jacfwd(f)(jnp.zeros(SENSOR_DIM, dtype=xi0.landmarks.dtype))


def euclid_normal_point_blocks(p0: jnp.ndarray) -> jnp.ndarray:
    """Per-landmark inverse blocks [N, 3, 3], analytic: p = y/rho with
    y = chart_inv(eps_b, y0), rho = rho0 exp(eps_z), so at 0
    dp = r0 * chart_inv_diff0(y0) d(eps_b) - p0 d(eps_z)."""
    r0 = jnp.clip(jnp.linalg.norm(p0, axis=-1), 1e-12, None)
    y0 = p0 / r0[..., None]
    left = r0[..., None, None] * sphere_chart_normal.chart_inv_diff0(y0)  # [N,3,2]
    return jnp.concatenate([left, -p0[..., None]], axis=-1)


def normal_euclid_differential(xi0: VIOState) -> jnp.ndarray:
    """d(normal o euclid^{-1}) at 0: dense [D, D], assembled from blocks
    (kept for tests and external callers; the suite itself works block-wise)."""
    N = xi0.capacity
    D = xi0.dim()
    dtype = xi0.landmarks.dtype
    M = jnp.zeros((D, D), dtype=dtype)
    M = M.at[:SENSOR_DIM, :SENSOR_DIM].set(normal_euclid_sensor_differential(xi0))
    blocks = jnp.zeros((N, 3, N, 3), dtype=dtype)
    idx = jnp.arange(N)
    blocks = blocks.at[idx, :, idx, :].set(normal_euclid_point_blocks(xi0.landmarks))
    return M.at[SENSOR_DIM:, SENSOR_DIM:].set(blocks.reshape(3 * N, 3 * N))


def state_matrix_A_normal(X: VIOGroup, xi0: VIOState, imu: IMU) -> jnp.ndarray:
    """A in normal coords = M A_euclid M^{-1}, applied block-wise: one 21x21
    solve plus batched 3x3 solves instead of a dense D x D inverse."""
    A = state_matrix_A_euclid(X, xi0, imu)
    Ms = normal_euclid_sensor_differential(xi0)
    Mp = normal_euclid_point_blocks(xi0.landmarks)
    N = xi0.capacity
    D = A.shape[-1]
    # left-multiply by blockdiag(Ms, Mp_i)
    top = Ms @ A[:SENSOR_DIM]
    rest = jnp.einsum(
        "nij,njd->nid", Mp, A[SENSOR_DIM:].reshape(N, 3, D)
    ).reshape(3 * N, D)
    A1 = jnp.concatenate([top, rest], axis=0)
    # right-multiply by blockdiag(Ms, Mp_i)^{-1}, using the analytic inverse
    # blocks of the reverse transition (no factorizations — pure matmuls)
    Ms_inv = euclid_normal_sensor_differential(xi0)
    Mp_inv = euclid_normal_point_blocks(xi0.landmarks)
    left = A1[:, :SENSOR_DIM] @ Ms_inv
    right = jnp.einsum(
        "dni,nij->dnj", A1[:, SENSOR_DIM:].reshape(D, N, 3), Mp_inv
    ).reshape(D, 3 * N)
    return jnp.concatenate([left, right], axis=1)


def input_matrix_B_normal(X: VIOGroup, xi0: VIOState) -> jnp.ndarray:
    B = input_matrix_B_euclid(X, xi0)
    Ms = normal_euclid_sensor_differential(xi0)
    Mp = normal_euclid_point_blocks(xi0.landmarks)
    N = xi0.capacity
    top = Ms @ B[:SENSOR_DIM]
    rest = jnp.einsum(
        "nij,njk->nik", Mp, B[SENSOR_DIM:].reshape(N, 3, 12)
    ).reshape(3 * N, 12)
    return jnp.concatenate([top, rest], axis=0)


def output_matrix_Ci_star_normal(q0, Q, camera, y_pixels) -> jnp.ndarray:
    """Analytic sphere-chart C*_i (reference ``normal.cpp:57-65``)."""
    y0 = q0 / jnp.clip(jnp.linalg.norm(q0, axis=-1, keepdims=True), 1e-12, None)
    Qinv_R = jnp.swapaxes(Q.R, -1, -2)
    y_hat = jnp.einsum("...ij,...j->...i", Qinv_R, y0)
    block = camera.projection_jacobian(y_hat) @ Qinv_R @ sphere_chart_normal.chart_inv_diff0(q0)
    zero = jnp.zeros(block.shape[:-1] + (1,), dtype=block.dtype)
    return jnp.concatenate([block, zero], axis=-1)


def output_matrix_Ci_normal(q0, Q, camera) -> jnp.ndarray:
    return output_matrix_Ci_star_normal(q0, Q, camera, None)


def lift_innovation_normal(Gamma: jnp.ndarray, xi0: VIOState) -> VIOAlgebra:
    Ms_inv = euclid_normal_sensor_differential(xi0)
    Mp_inv = euclid_normal_point_blocks(xi0.landmarks)
    eps_sensor, gamma_p = split_coords_vector(Gamma, xi0.capacity)
    s = jnp.einsum("ij,...j->...i", Ms_inv, eps_sensor)
    p = jnp.einsum("...nij,...nj->...ni", Mp_inv, gamma_p)
    Gamma_euc = jnp.concatenate([s, p.reshape(p.shape[:-2] + (-1,))], axis=-1)
    return lift_innovation_euclid(Gamma_euc, xi0)


def lift_innovation_discrete_normal(Gamma: jnp.ndarray, xi0: VIOState) -> VIOGroup:
    euclid = STATE_CHARTS["euclid"]
    normal = STATE_CHARTS["normal"]
    Gamma_euc = euclid.chart(normal.chart_inv(Gamma, xi0), xi0)
    return lift_innovation_discrete_euclid(Gamma_euc, xi0)


# ---------------------------------------------------------------------------
# Discrete state matrix (any suite): exact AD of the lift conjugation
# (reference EqFMatrices.cpp:24-41 uses central differences)
# ---------------------------------------------------------------------------


def state_matrix_A_discrete(
    suite: "CoordinateSuite", X: VIOGroup, xi0: VIOState, imu: IMU, dt
) -> jnp.ndarray:
    chart = suite.chart

    def step(eps):
        xi_e = chart.chart_inv(eps, xi0)
        xi_hat = state_action(X, xi0)
        xi = state_action(X, xi_e)
        lam = group_mul(
            lift_velocity_discrete(xi, imu, dt),
            group_inv(lift_velocity_discrete(xi_hat, imu, dt)),
        )
        xi_e1 = state_action(group_mul(group_mul(X, lam), group_inv(X)), xi_e)
        return chart.chart(xi_e1, xi0)

    D = xi0.dim()
    A = jax.jacfwd(step)(jnp.zeros(D, dtype=xi0.landmarks.dtype))
    # mask inactive landmark rows/cols to keep padding decoupled
    mask_vec = jnp.concatenate(
        [
            jnp.ones((SENSOR_DIM,), dtype=A.dtype),
            jnp.repeat(_mask_f(xi0), 3),
        ]
    )
    return A * mask_vec[:, None] * mask_vec[None, :]


# ---------------------------------------------------------------------------
# Suite table (reference EqFMatrices.h:70-74, getCoordinates EqFMatrices.h:81-90)
# ---------------------------------------------------------------------------


class CoordinateSuite(NamedTuple):
    name: str
    chart: StateChart
    state_matrix_A: Callable  # (X, xi0, imu) -> [D, D]
    input_matrix_B: Callable  # (X, xi0) -> [D, 12]
    output_Ci_star: Callable  # (q0, Q, camera, y_px) -> [..., 2, 3]
    output_Ci: Callable  # (q0, Q, camera) -> [..., 2, 3]
    lift_innovation: Callable  # (Gamma, xi0) -> VIOAlgebra
    lift_innovation_discrete: Callable  # (Gamma, xi0) -> VIOGroup


SUITES = {
    "euclid": CoordinateSuite(
        "euclid",
        STATE_CHARTS["euclid"],
        state_matrix_A_euclid,
        input_matrix_B_euclid,
        output_matrix_Ci_star_euclid,
        output_matrix_Ci_euclid,
        lift_innovation_euclid,
        lift_innovation_discrete_euclid,
    ),
    "invdepth": CoordinateSuite(
        "invdepth",
        STATE_CHARTS["invdepth"],
        state_matrix_A_invdepth,
        input_matrix_B_invdepth,
        output_matrix_Ci_star_invdepth,
        output_matrix_Ci_invdepth,
        lift_innovation_invdepth,
        lift_innovation_discrete_invdepth,
    ),
    "normal": CoordinateSuite(
        "normal",
        STATE_CHARTS["normal"],
        state_matrix_A_normal,
        input_matrix_B_normal,
        output_matrix_Ci_star_normal,
        output_matrix_Ci_normal,
        lift_innovation_normal,
        lift_innovation_discrete_normal,
    ),
}


def get_suite(name: str) -> CoordinateSuite:
    """Map config names to suites (reference coordinate choices Euclidean/InvDepth/Normal)."""
    alias = {"euclidean": "euclid", "invdepth": "invdepth", "normal": "normal"}
    return SUITES[alias.get(name.lower(), name.lower())]
