"""The EqF filter core: propagation, vision update, landmark lifecycle.

Redesign of the reference filter
(``src/mathematical/VIO_eqf.cpp`` + ``src/VIOFilter.cpp`` +
``include/eqvio/VIOFilterSettings.h``): the filter state is a fixed-shape
pytree, every step is a pure jittable function, and landmark add/remove are
mask flips with covariance-row surgery instead of matrix resizes.

Slot protocol: the feature tracker and the filter share slot indices.  A
feature keeps its slot for its lifetime; slot reuse is detected by id
mismatch.  This turns the reference's id-searching lifecycle
(``VIOFilter.cpp:258-364``) into pure vectorised mask algebra.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .group import (
    VIOGroup,
    group_exp,
    group_identity,
    group_inv,
    group_mul,
    group_normalize,
    lift_velocity,
    lift_velocity_discrete,
    algebra_scale,
    state_action,
)
from .lie import SE3, so3_from_vectors
from .matrices import CoordinateSuite, get_suite, state_matrix_A_discrete
from .states import (
    IMU,
    SENSOR_DIM,
    VIOState,
    integrate_system,
    measure_system,
    state_identity,
)

# ---------------------------------------------------------------------------
# Settings (reference VIOFilterSettings.h:58-124)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Settings:
    """EqF settings; a frozen dataclass so it can be closed over statically."""

    # process (state gain) variances
    bias_omega_process_var: float = 0.001
    bias_accel_process_var: float = 0.001
    attitude_process_var: float = 0.001
    position_process_var: float = 0.001
    velocity_process_var: float = 0.001
    camera_attitude_process_var: float = 0.001
    camera_position_process_var: float = 0.001
    point_process_var: float = 0.001

    # input (IMU) noise
    vel_gyr_noise: float = 1e-4
    vel_acc_noise: float = 1e-3
    vel_gyr_bias_walk: float = 1e-5
    vel_acc_bias_walk: float = 1e-3

    # output (feature) noise and outlier gates
    measurement_noise: float = 2.0
    outlier_threshold_abs: float = 1e8
    outlier_threshold_prob: float = 1e8
    feature_retention: float = 0.3

    # initial variances
    initial_attitude_var: float = 1e-4
    initial_position_var: float = 1e-4
    initial_velocity_var: float = 1e-2
    initial_camera_attitude_var: float = 1e-5
    initial_camera_position_var: float = 1e-4
    initial_point_var: float = 1.0
    initial_point_depth_var: float = -1.0
    initial_bias_omega_var: float = 0.1
    initial_bias_accel_var: float = 0.1
    initial_scene_depth: float = 1.0

    # algorithm switches
    use_discrete_innovation_lift: bool = True
    use_discrete_velocity_lift: bool = True
    use_discrete_state_matrix: bool = False
    use_accurate_riccati: bool = False  # reference default when !fastRiccati
    fast_riccati: bool = False
    use_median_depth: bool = True
    use_feature_predictions: bool = False
    use_equivariant_output: bool = True
    remove_lost_landmarks: bool = True
    coordinate_choice: str = "euclid"
    # square-root covariance mode: EqFState.Sigma holds the lower Cholesky
    # factor L (Sigma = L L^T), maintained by QR re-triangularisation.  The
    # condition number of the factor is the square root of the covariance's,
    # which keeps the filter finite in float32 even with the reference's
    # tuned EuRoC variances (spread ~1e13), where the reference relies on
    # float64 Eigen math.  No reference equivalent.
    sqrt_covariance: bool = False

    # initial camera offset as an se(3) tangent? No: (qw,qx,qy,qz, x,y,z) quat+pos
    camera_offset_quat: tuple = (1.0, 0.0, 0.0, 0.0)
    camera_offset_pos: tuple = (0.0, 0.0, 0.0)

    @property
    def suite(self) -> CoordinateSuite:
        return get_suite(self.coordinate_choice)

    def camera_offset_se3(self, dtype=jnp.float64) -> SE3:
        w, x, y, z = self.camera_offset_quat
        n = (w * w + x * x + y * y + z * z) ** 0.5
        w, x, y, z = w / n, x / n, y / n, z / n
        R = jnp.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            dtype=dtype,
        )
        return SE3(R, jnp.asarray(self.camera_offset_pos, dtype=dtype))

    # --- gain matrix builders (reference VIOFilterSettings.h:176-229) ---

    def initial_sensor_cov_diag(self, dtype=jnp.float64) -> jnp.ndarray:
        vals = (
            [self.initial_bias_omega_var] * 3
            + [self.initial_bias_accel_var] * 3
            + [self.initial_attitude_var] * 3
            + [self.initial_position_var] * 3
            + [self.initial_velocity_var] * 3
            + [self.initial_camera_attitude_var] * 3
            + [self.initial_camera_position_var] * 3
        )
        return jnp.asarray(vals, dtype=dtype)

    def initial_point_cov_diag(self, dtype=jnp.float64) -> jnp.ndarray:
        d = [self.initial_point_var] * 3
        if self.initial_point_depth_var > 0:
            d[2] = self.initial_point_depth_var
        return jnp.asarray(d, dtype=dtype)

    def state_gain_diag(self, capacity: int, dtype=jnp.float64) -> jnp.ndarray:
        vals = (
            [self.bias_omega_process_var] * 3
            + [self.bias_accel_process_var] * 3
            + [self.attitude_process_var] * 3
            + [self.position_process_var] * 3
            + [self.velocity_process_var] * 3
            + [self.camera_attitude_process_var] * 3
            + [self.camera_position_process_var] * 3
            + [self.point_process_var] * 3 * capacity
        )
        return jnp.asarray(vals, dtype=dtype)

    def input_gain_diag(self, dtype=jnp.float64) -> jnp.ndarray:
        vals = (
            [self.vel_gyr_noise**2] * 3
            + [self.vel_acc_noise**2] * 3
            + [self.vel_gyr_bias_walk**2] * 3
            + [self.vel_acc_bias_walk**2] * 3
        )
        return jnp.asarray(vals, dtype=dtype)


# ---------------------------------------------------------------------------
# Filter state
# ---------------------------------------------------------------------------


class EqFState(NamedTuple):
    """Complete EqF filter state (reference ``VIO_eqf.h:36-42``)."""

    xi0: VIOState  # fixed origin configuration
    X: VIOGroup  # observer group element
    Sigma: jnp.ndarray  # [D, D] Riccati matrix
    t: jnp.ndarray  # current filter time


def _mask_vec(xi0: VIOState) -> jnp.ndarray:
    """[D] vector: 1 on sensor + active landmark coords, 0 on inactive slots."""
    m = jnp.repeat(xi0.mask.astype(xi0.landmarks.dtype), 3)
    return jnp.concatenate([jnp.ones((SENSOR_DIM,), dtype=xi0.landmarks.dtype), m])


import os as _os

# Re-triangularisation mode (EQVIO_TRIA):
#   raw (default): plain f32 QR.  With the two-QR frame structure and the
#       deterministic tracker, f32-raw matches the f64 filter to <0.001 m
#       on both committed proxies (RESULTS.md round-4 controlled study);
#       the round-4 "f64 island fixes f32" result was confounded by the
#       RANSAC RNG stream and does not survive a controlled rerun.
#   f64: f64-island Gram+Cholesky (exact f64 Gram of the f32 factor, f64
#       Cholesky, entrywise downcast).  Numerically the strongest factor
#       update; an accuracy-validation option, not the production default
#       (its cost on the GPU is not measured).
_TRIA_MODE = _os.environ.get("EQVIO_TRIA", "raw")


def tria(M: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangularise: L with L L^T = M M^T and nonnegative diagonal.

    Default: one QR of M^T [K,D] (K >= D).  ``EQVIO_TRIA=f64`` with f32
    input: the f64-island Gram+Cholesky (see above) — the same unique
    factor at f64 backward error.
    """
    in_dtype = M.dtype
    if _TRIA_MODE == "f64" and in_dtype == jnp.float32 and jax.config.jax_enable_x64:
        M64 = M.astype(jnp.float64)
        L = jnp.linalg.cholesky(M64 @ M64.T)
        return L.astype(in_dtype)
    R = jnp.linalg.qr(M.T, mode="r")  # [D, D] upper, M M^T = R^T R
    L = R.T
    sign = jnp.sign(jnp.diagonal(L))
    sign = jnp.where(sign == 0, 1.0, sign)
    return (L * sign[None, :]).astype(in_dtype)


def _sqrt_mask_reset(L: jnp.ndarray, keep_vec: jnp.ndarray, add_diag: jnp.ndarray) -> jnp.ndarray:
    """Factor of ``diag(keep) (L L^T) diag(keep) + diag(add_diag)``.

    The sqrt form of the masked-array covariance surgery (slot add/remove):
    zero the slot rows of L, then re-triangularise with the fresh diagonal.

    Note the hot path never calls this: the fused propagate/update steps
    absorb the mask surgery into the QRs they already perform
    (:func:`_sqrt_riccati_step` pre-masks its stacked blocks;
    :func:`update_vision` widens the Kailath pre-array with the surgery
    columns), so the sqrt filter runs exactly two QRs per frame.  This
    standalone form remains for the generic API (``set_landmarks``,
    checkpoint surgery, the dryrun shard path).
    """
    Lm = L * keep_vec[:, None]
    return tria(jnp.concatenate([Lm, jnp.diag(jnp.sqrt(add_diag))], axis=1))


def sanitize_sigma(Sigma: jnp.ndarray, xi0: VIOState, settings: Settings) -> jnp.ndarray:
    """Zero inactive rows/cols and reset their diagonal to the initial point
    variance so padding slots stay decoupled and well-conditioned.

    In sqrt mode ``Sigma`` is the lower Cholesky factor; the same surgery is
    done by masked re-triangularisation."""
    mv = _mask_vec(xi0)
    pad_diag = (1.0 - mv) * settings.initial_point_var
    if settings.sqrt_covariance:
        return _sqrt_mask_reset(Sigma, mv, pad_diag)
    Sigma = Sigma * mv[:, None] * mv[None, :]
    return Sigma + jnp.diag(pad_diag)


def dense_sigma(state: "EqFState", settings: Settings | None = None) -> jnp.ndarray:
    """The covariance as a dense matrix regardless of mode.

    In sqrt mode the state carries the lower Cholesky factor; consistency
    metrics, serialisation and marginal covariances reconstruct through here.
    """
    if settings is not None and settings.sqrt_covariance:
        return state.Sigma @ state.Sigma.T
    return state.Sigma


def init_state(settings: Settings, capacity: int, dtype=jnp.float64) -> EqFState:
    """Initial filter state (reference VIOFilter ctor, ``VIOFilter.cpp:31-41``)."""
    xi0 = state_identity(capacity, dtype)
    xi0 = xi0._replace(
        sensor=xi0.sensor._replace(camera_offset=settings.camera_offset_se3(dtype))
    )
    D = SENSOR_DIM + 3 * capacity
    diag = jnp.concatenate(
        [
            settings.initial_sensor_cov_diag(dtype),
            jnp.tile(settings.initial_point_cov_diag(dtype), capacity),
        ]
    )
    Sigma = jnp.diag(jnp.sqrt(diag) if settings.sqrt_covariance else diag)
    return EqFState(
        xi0=xi0,
        X=group_identity(capacity, dtype),
        Sigma=Sigma,
        t=jnp.asarray(-1.0, dtype=dtype),
    )


def initialize_attitude_from_imu(state: EqFState, imu: IMU) -> EqFState:
    """Gravity-aligned attitude init (reference ``VIOFilter.cpp:65-78``)."""
    acc_dir = imu.acc / jnp.clip(jnp.linalg.norm(imu.acc, axis=-1, keepdims=True), 1e-9, None)
    e3 = jnp.zeros_like(acc_dir).at[..., 2].set(1.0)
    R0 = so3_from_vectors(acc_dir, e3)
    xi0 = state.xi0._replace(
        sensor=state.xi0.sensor._replace(pose=SE3(R0, state.xi0.sensor.pose.x))
    )
    return state._replace(xi0=xi0, t=imu.stamp.astype(state.t.dtype))


def state_estimate(state: EqFState) -> VIOState:
    """phi_X(xi0) (reference ``VIO_eqf.cpp:137``)."""
    return state_action(state.X, state.xi0)


# ---------------------------------------------------------------------------
# Propagation (reference VIO_eqf.cpp:47-103, VIOFilter.cpp:134-192)
# ---------------------------------------------------------------------------


def integrate_observer(state: EqFState, imu: IMU, dt, settings: Settings) -> EqFState:
    xi_hat = state_estimate(state)
    if settings.use_discrete_velocity_lift:
        lifted = lift_velocity_discrete(xi_hat, imu, dt)
    else:
        lifted = group_exp(algebra_scale(lift_velocity(xi_hat, imu), dt))
    # re-orthogonalise: matrix products otherwise feed non-orthogonality back
    # through the camera-offset conjugation with geometric growth
    return state._replace(X=group_normalize(group_mul(state.X, lifted)))


def integrate_riccati_fast(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite,
    wide: bool = False,
) -> EqFState:
    """Euler Riccati step (reference ``VIO_eqf.cpp:62-72``).

    ``wide=True`` (sqrt mode only) skips the re-triangularising QR and stores
    the wide stacked factor in ``Sigma`` (shape ``[D, Wc+12+D]``) — exact,
    since only the factor's Gram is meaningful.  Every sqrt-mode consumer
    (:func:`outlier_mask`, :func:`update_vision`, :func:`dense_sigma`,
    :func:`_sqrt_mask_reset`) is width-generic, and the frame's Kailath
    update QR returns a square factor, so the wide form lives only between
    propagation and update inside a fused frame program.
    """
    D = state.xi0.dim()
    dtype = state.Sigma.dtype
    A0t = suite.state_matrix_A(state.X, state.xi0, imu)
    Bt = suite.input_matrix_B(state.X, state.xi0)
    A_exp = jnp.eye(D, dtype=dtype) + dt * A0t
    if settings.sqrt_covariance:
        if wide:
            # no dt>0 bypass (shapes differ); at dt == 0 the stack's Gram is
            # exactly the sanitized covariance, so downstream results match
            return state._replace(
                Sigma=_sqrt_riccati_stack(state, A_exp, Bt, dt, settings, dtype)
            )
        # zero-dt padded entries must be exact no-ops: bypass the QR
        Sigma = jnp.where(
            jnp.asarray(dt, dtype=dtype) > 0,
            _sqrt_riccati_step(state, A_exp, Bt, dt, settings, dtype),
            state.Sigma,
        )
        return state._replace(Sigma=Sigma)
    else:
        Q_in = Bt * settings.input_gain_diag(dtype)[None, :] @ Bt.T
        P = jnp.diag(settings.state_gain_diag(state.xi0.capacity, dtype)) * _mask_outer(state.xi0)
        Sigma = A_exp @ state.Sigma @ A_exp.T + dt * (Q_in + P)
        Sigma = 0.5 * (Sigma + Sigma.T)
    return state._replace(Sigma=sanitize_sigma(Sigma, state.xi0, settings))


def _mask_outer(xi0: VIOState) -> jnp.ndarray:
    mv = _mask_vec(xi0)
    return mv[:, None] * mv[None, :]


def _sqrt_riccati_stack(state, A_exp, Bt, dt, settings: Settings, dtype) -> jnp.ndarray:
    """Wide (un-triangularised) factor ``S`` with ``S S^T = mask (A Sigma A^T
    + dt (B q B^T + P)) mask + pad`` — the stacked blocks of the sqrt Riccati
    step, width ``Wc + 12 + D`` where ``Wc`` is the incoming factor's width.

    Row-masking every stacked block zeroes both rows and columns of each
    Gram contribution.  The process-noise and pad diagonals merge into ONE
    diagonal block because their masks are disjoint (``p_diag`` is active-
    masked, ``pad`` inactive-masked), so the stack stays as narrow as
    possible for the downstream QR.
    """
    dt = jnp.asarray(dt, dtype=dtype)
    dt_pos = jnp.maximum(dt, 0.0)
    mv = _mask_vec(state.xi0)
    q_sqrt = jnp.sqrt(settings.input_gain_diag(dtype))
    p_diag = settings.state_gain_diag(state.xi0.capacity, dtype) * mv
    pad = (1.0 - mv) * settings.initial_point_var
    return jnp.concatenate(
        [
            (A_exp @ state.Sigma) * mv[:, None],
            jnp.sqrt(dt_pos) * (Bt * q_sqrt[None, :]) * mv[:, None],
            jnp.diag(jnp.sqrt(dt_pos * p_diag + pad)),
        ],
        axis=1,
    )


def _sqrt_riccati_step(state, A_exp, Bt, dt, settings: Settings, dtype) -> jnp.ndarray:
    """Sqrt form of the Riccati step: ONE QR over the row-masked stacked
    factor blocks (:func:`_sqrt_riccati_stack`).

    The pad columns contribute only inactive-slot diagonals, so the QR
    output is the exact Cholesky factor of the *sanitized* covariance — no
    follow-up ``sanitize_sigma`` QR.  Combined with the surgery-absorbing
    update (:func:`update_vision`) the sqrt filter runs at most two QRs per
    frame — and the fused frame path (``wide_factor=True`` in
    :func:`propagate_window`) skips this QR entirely, carrying the wide
    stack into the update's Kailath pre-array for ONE QR per frame.
    """
    return tria(_sqrt_riccati_stack(state, A_exp, Bt, dt, settings, dtype))


def integrate_riccati_accurate(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite
) -> EqFState:
    """Matrix-exponential Riccati step (reference ``VIO_eqf.cpp:74-91``).

    Uses scaling-and-squaring expm of the stacked [A B; 0 0] system.
    """
    D = state.xi0.dim()
    dtype = state.Sigma.dtype
    # guard zero-dt padding entries (the reference's `dt > 0` branch,
    # VIOFilter.cpp:165): compute with a safe dt and select the identity step
    dt = jnp.asarray(dt, dtype=dtype)
    dt_safe = jnp.where(dt > 0, dt, 1.0)
    A0t = suite.state_matrix_A(state.X, state.xi0, imu)
    Bt = suite.input_matrix_B(state.X, state.xi0)
    AB = jnp.zeros((D + 12, D + 12), dtype=dtype)
    AB = AB.at[:D, :D].set(A0t)
    AB = AB.at[:D, D:].set(Bt)
    ABexp = jax.scipy.linalg.expm(dt_safe * AB)
    A_exp = ABexp[:D, :D]
    B_exp = ABexp[:D, D:]
    if settings.sqrt_covariance:
        # Q_in = B_exp diag(q/dt) B_exp^T, P added at dt: reuse the stacked QR
        # with B_exp/sqrt(dt) in place of sqrt(dt) B; row-masked + padded so
        # the one QR also sanitizes (see _sqrt_riccati_step)
        mv = _mask_vec(state.xi0)
        q_sqrt = jnp.sqrt(settings.input_gain_diag(dtype) / dt_safe)
        p_diag = settings.state_gain_diag(state.xi0.capacity, dtype) * mv
        pad = (1.0 - mv) * settings.initial_point_var
        stacked = jnp.concatenate(
            [
                (A_exp @ state.Sigma) * mv[:, None],
                (B_exp * q_sqrt[None, :]) * mv[:, None],
                # p_diag and pad have disjoint masks: one diagonal block
                jnp.diag(jnp.sqrt(dt_safe * p_diag + pad)),
            ],
            axis=1,
        )
        Sigma = jnp.where(dt > 0, tria(stacked), state.Sigma)
        return state._replace(Sigma=Sigma)
    else:
        Q_in = B_exp * (settings.input_gain_diag(dtype) / dt_safe)[None, :] @ B_exp.T
        P = jnp.diag(settings.state_gain_diag(state.xi0.capacity, dtype)) * _mask_outer(state.xi0)
        Sigma = A_exp @ state.Sigma @ A_exp.T + Q_in + dt_safe * P
        Sigma = 0.5 * (Sigma + Sigma.T)
    Sigma = jnp.where(dt > 0, Sigma, state.Sigma)
    return state._replace(Sigma=sanitize_sigma(Sigma, state.xi0, settings))


def integrate_riccati_discrete(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite
) -> EqFState:
    """Discrete-transition Riccati step (reference ``VIO_eqf.cpp:93-103``)."""
    dtype = state.Sigma.dtype
    A_d = state_matrix_A_discrete(suite, state.X, state.xi0, imu, dt)
    Bt = suite.input_matrix_B(state.X, state.xi0)
    if settings.sqrt_covariance:
        Sigma = jnp.where(
            jnp.asarray(dt, dtype=dtype) > 0,
            _sqrt_riccati_step(state, A_d, Bt, dt, settings, dtype),
            state.Sigma,
        )
        return state._replace(Sigma=Sigma)
    else:
        Q_in = Bt * settings.input_gain_diag(dtype)[None, :] @ Bt.T
        P = jnp.diag(settings.state_gain_diag(state.xi0.capacity, dtype)) * _mask_outer(state.xi0)
        Sigma = A_d @ state.Sigma @ A_d.T + dt * (Q_in + P)
        Sigma = 0.5 * (Sigma + Sigma.T)
    return state._replace(Sigma=sanitize_sigma(Sigma, state.xi0, settings))


def propagate(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite | None = None
) -> EqFState:
    """One IMU step: Riccati + observer (reference ``VIOFilter.cpp:160-178``).

    A ``dt == 0`` step is an exact no-op, so zero-padded IMU windows scan
    cleanly under jit.
    """
    if suite is None:
        suite = settings.suite
    if settings.use_discrete_state_matrix:
        state = integrate_riccati_discrete(state, imu, dt, settings, suite)
    elif settings.use_accurate_riccati:
        # matrix-exponential per sample (the reference's default when
        # fastRiccati is off, VIOFilter.cpp:165-175)
        state = integrate_riccati_accurate(state, imu, dt, settings, suite)
    else:
        state = integrate_riccati_fast(state, imu, dt, settings, suite)
    state = integrate_observer(state, imu, dt, settings)
    return state._replace(t=jnp.maximum(state.t, imu.stamp.astype(state.t.dtype)))


def propagate_window(
    state: EqFState,
    imu_window: IMU,
    dts: jnp.ndarray,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    wide_factor: bool = False,
) -> EqFState:
    """Propagate over a padded IMU window [K] with per-sample dt via lax.scan.

    Replaces the reference's velocity-buffer loop (``VIOFilter.cpp:160-178``).
    With ``fast_riccati`` the Riccati step runs once on the time-weighted mean
    IMU (``VIOFilter.cpp:140-157``); otherwise per sample.

    ``wide_factor=True``: with sqrt covariance + fast Riccati, skip the
    Riccati QR and return ``Sigma`` as the wide stacked factor ``[D, 2D+12]``
    (see :func:`integrate_riccati_fast`).  The caller MUST follow with a
    re-squaring consumer (``process_vision`` / ``update_vision`` /
    ``sanitize via _sqrt_mask_reset``) in the same program — this is the
    one-QR-per-frame fusion of the Riccati and Kailath pre-arrays
    (reference's two separate steps: ``VIO_eqf.cpp:62-72`` and ``105-135``).
    In any other mode the flag is a no-op, so callers may pass it
    unconditionally.
    """
    if suite is None:
        suite = settings.suite
    wide = wide_factor and settings.sqrt_covariance and settings.fast_riccati

    if settings.fast_riccati:
        total = jnp.clip(jnp.sum(dts), 1e-9, None)
        weight = (dts / total)[:, None]
        mean_imu = IMU(
            stamp=jnp.max(imu_window.stamp),
            gyr=jnp.sum(imu_window.gyr * weight, axis=0),
            acc=jnp.sum(imu_window.acc * weight, axis=0),
            gyr_bias_vel=jnp.sum(imu_window.gyr_bias_vel * weight, axis=0),
            acc_bias_vel=jnp.sum(imu_window.acc_bias_vel * weight, axis=0),
        )
        state = integrate_riccati_fast(state, mean_imu, total, settings, suite, wide=wide)

        if settings.use_discrete_velocity_lift:
            # fused observer: integrate the estimate cheaply, then apply ONE
            # exact group element for the whole window (identical to chaining
            # per-sample discrete lifts, far fewer sequential ops)
            from .group import group_element_between

            xi_hat0 = state_estimate(state)

            def int_body(x, inp):
                imu_i, dt_i = inp
                return integrate_system(x, imu_i, dt_i), None

            xi_hatK, _ = jax.lax.scan(int_body, xi_hat0, (imu_window, dts))
            L = group_element_between(xi_hat0, xi_hatK)
            state = state._replace(X=group_normalize(group_mul(state.X, L)))
        else:

            def body(s, inp):
                imu_i, dt_i = inp
                s = integrate_observer(s, imu_i, dt_i, settings)
                return s, None

            state, _ = jax.lax.scan(body, state, (imu_window, dts))
    else:

        def body(s, inp):
            imu_i, dt_i = inp
            s = propagate(s, imu_i, dt_i, settings, suite)
            return s, None

        state, _ = jax.lax.scan(body, state, (imu_window, dts))

    # padded entries must repeat the last real sample with dt = 0, so the max
    # stamp is the true new filter time
    new_t = jnp.maximum(state.t, jnp.max(imu_window.stamp).astype(state.t.dtype))
    return state._replace(t=new_t)


# ---------------------------------------------------------------------------
# Vision update (reference VIO_eqf.cpp:105-135)
# ---------------------------------------------------------------------------


def update_vision(
    state: EqFState,
    pixels: jnp.ndarray,  # [N, 2] slot-aligned measurements
    vis_mask: jnp.ndarray,  # [N] bool
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    surgery: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> EqFState:
    """Masked EqF Kalman update with the block-structured C matrix.

    ``C`` has one 2x3 block per landmark (sensor columns are zero, reference
    ``EqFMatrices.cpp:43-82``), so ``C Sigma C^T`` and ``Sigma C^T`` reduce to
    einsums over the landmark axis — O(N^2) not O(D^2).

    ``surgery=(keep_vec, add_diag)`` folds the frame's landmark-lifecycle
    covariance surgery into the update itself: the update runs against
    ``Sigma' = diag(keep) Sigma diag(keep) + diag(add)``.  In sqrt mode this
    is absorbed into ONE widened Kailath pre-array ``[[R^1/2, C W], [0, W]]``
    with ``W = [keep o L, diag(sqrt(add))]`` — no standalone surgery QR, and
    the post-array factor is automatically the clean Cholesky factor of the
    sanitized posterior (inactive slots exactly decoupled), so no follow-up
    ``sanitize_sigma`` QR either.
    """
    if suite is None:
        suite = settings.suite
    xi0, X, Sigma = state.xi0, state.X, state.Sigma
    N = xi0.capacity
    D = xi0.dim()
    dtype = Sigma.dtype

    active = (xi0.mask & vis_mask).astype(dtype)  # [N]
    xi_hat = state_action(X, xi0)
    y_hat, _ = measure_system(xi_hat, camera)
    resid = (pixels - y_hat) * active[:, None]  # [N,2]

    if settings.use_equivariant_output:
        C = suite.output_Ci_star(xi0.landmarks, X.Q, camera, pixels)  # [N,2,3]
    else:
        C = suite.output_Ci(xi0.landmarks, X.Q, camera)
    C = C * active[:, None, None]

    r_diag = jnp.where(
        jnp.repeat(active, 2) > 0, settings.measurement_noise**2, 1.0
    ).astype(dtype)

    if settings.sqrt_covariance:
        # array square-root update (Kailath pre-/post-array): one QR of
        #   [[R^1/2, C W], [0, W]]  ->  [[S^1/2, 0], [Sigma C^T S^-T/2, L+]]
        # keeps the f32 condition at sqrt of the covariance's
        m = 2 * N
        L = Sigma  # lower Cholesky factor
        if surgery is not None:
            keep_vec, add_diag = surgery
            W = jnp.concatenate(
                [L * keep_vec[:, None], jnp.diag(jnp.sqrt(add_diag))], axis=1
            )  # [D, 2D] wide factor of the post-surgery covariance
        else:
            W = L
        Wc = W.shape[1]
        CW = jnp.einsum("iax,ixd->iad", C, W[SENSOR_DIM:].reshape(N, 3, Wc)).reshape(m, Wc)
        pre = jnp.zeros((m + D, m + Wc), dtype=dtype)
        pre = pre.at[:m, :m].set(jnp.diag(jnp.sqrt(r_diag)))
        pre = pre.at[:m, m:].set(CW)
        pre = pre.at[m:, m:].set(W)
        post = tria(pre)
        S_half = post[:m, :m]
        Kbar = post[m:, :m]
        L_new = post[m:, m:]
        Gamma = Kbar @ jax.scipy.linalg.solve_triangular(
            S_half, resid.reshape(-1), lower=True
        )
        Sigma_new = L_new
    else:
        if surgery is not None:
            keep_vec, add_diag = surgery
            Sigma = Sigma * keep_vec[:, None] * keep_vec[None, :] + jnp.diag(add_diag)
        Sig_lm = Sigma[SENSOR_DIM:, SENSOR_DIM:].reshape(N, 3, N, 3)
        S = jnp.einsum("iax,ixjy,jby->iajb", C, Sig_lm, C).reshape(2 * N, 2 * N)
        S = S + jnp.diag(r_diag)

        SigCt = jnp.einsum("djy,jby->djb", Sigma[:, SENSOR_DIM:].reshape(D, N, 3), C).reshape(
            D, 2 * N
        )

        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        K = jax.scipy.linalg.cho_solve(chol, SigCt.T).T  # [D, 2N]

        Gamma = K @ resid.reshape(-1)
        Sigma_new = Sigma - K @ SigCt.T
        Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)

    if settings.use_discrete_innovation_lift:
        Delta = suite.lift_innovation_discrete(Gamma, xi0)
    else:
        Delta = group_exp(suite.lift_innovation(Gamma, xi0))

    X_new = group_normalize(group_mul(Delta, X))
    if not (settings.sqrt_covariance and surgery is not None):
        # with fused surgery the sqrt post-array is already the clean factor
        # of the sanitized posterior; otherwise sanitize as before
        Sigma_new = sanitize_sigma(Sigma_new, xi0, settings)
    return state._replace(X=X_new, Sigma=Sigma_new)


# ---------------------------------------------------------------------------
# Landmark lifecycle (reference VIO_eqf.cpp:172-245, VIOFilter.cpp:258-364)
# ---------------------------------------------------------------------------


def remove_landmarks(state: EqFState, rm_mask: jnp.ndarray, settings: Settings) -> EqFState:
    """Deactivate slots: mask off, reset Q to identity, dummy origin point,
    zero Sigma rows/cols (reference removeLandmarkByIndex ``VIO_eqf.cpp:172-178``)."""
    keep = state.xi0.mask & ~rm_mask
    dtype = state.xi0.landmarks.dtype
    dummy = jnp.asarray([0.0, 0.0, 1.0], dtype=dtype)
    landmarks = jnp.where(keep[:, None], state.xi0.landmarks, dummy)
    ids = jnp.where(keep, state.xi0.ids, -1)
    xi0 = state.xi0._replace(landmarks=landmarks, ids=ids, mask=keep)
    eyeN = jnp.broadcast_to(jnp.eye(3, dtype=dtype), state.X.Q.R.shape)
    Q = state.X.Q._replace(
        R=jnp.where(keep[:, None, None], state.X.Q.R, eyeN),
        a=jnp.where(keep, state.X.Q.a, 1.0),
    )
    X = state.X._replace(Q=Q)
    Sigma = sanitize_sigma(state.Sigma, xi0, settings)
    return state._replace(xi0=xi0, X=X, Sigma=Sigma)


def remove_invalid_landmarks(state: EqFState, settings: Settings) -> EqFState:
    """Prune landmarks whose scale left [1e-8, 1e8] (reference ``VIO_eqf.cpp:213-223``)."""
    bad = (state.X.Q.a <= 1e-8) | (state.X.Q.a > 1e8)
    return remove_landmarks(state, bad & state.xi0.mask, settings)


def median_scene_depth(
    state: EqFState, settings: Settings, mask: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Masked median depth of the current estimate (reference ``VIOFilter.cpp:366-380``)."""
    xi_hat = state_estimate(state)
    if mask is None:
        mask = xi_hat.mask
    d2 = jnp.sum(xi_hat.landmarks**2, axis=-1)
    big = jnp.asarray(1e30, dtype=d2.dtype)
    d2_sorted = jnp.sort(jnp.where(mask, d2, big))
    n_active = jnp.sum(mask)
    idx = jnp.clip(n_active // 2, 0, xi_hat.capacity - 1)
    med = jnp.sqrt(d2_sorted[idx])
    return jnp.where(n_active > 0, med, settings.initial_scene_depth)


def add_landmarks(
    state: EqFState,
    pixels: jnp.ndarray,  # [N,2]
    new_mask: jnp.ndarray,  # [N] slots to initialise
    new_ids: jnp.ndarray,  # [N]
    camera,
    settings: Settings,
) -> EqFState:
    """Initialise new landmark slots from undistorted bearings at the median
    scene depth (reference ``VIOFilter.cpp:258-278``, ``VIO_eqf.cpp:225-245``).

    New landmarks enter at the *current estimate*, i.e. the origin landmark is
    chosen so that phi_X(q0) = depth * bearing with Q_slot = identity.
    """
    dtype = state.xi0.landmarks.dtype
    depth = (
        median_scene_depth(state, settings)
        if settings.use_median_depth
        else jnp.asarray(settings.initial_scene_depth, dtype=dtype)
    )
    bearings = camera.undistort(pixels)  # [N,3]
    q_new = bearings * depth
    # Q slot must be identity; since phi acts by Q^{-1}, set xi0 landmark = q_new
    landmarks = jnp.where(new_mask[:, None], q_new, state.xi0.landmarks)
    ids = jnp.where(new_mask, new_ids, state.xi0.ids)
    mask = state.xi0.mask | new_mask
    xi0 = state.xi0._replace(landmarks=landmarks, ids=ids, mask=mask)

    eyeN = jnp.broadcast_to(jnp.eye(3, dtype=dtype), state.X.Q.R.shape)
    Q = state.X.Q._replace(
        R=jnp.where(new_mask[:, None, None], eyeN, state.X.Q.R),
        a=jnp.where(new_mask, 1.0, state.X.Q.a),
    )
    X = state.X._replace(Q=Q)

    # Sigma: zero new rows/cols, initial point variance on the diagonal
    mv_new = jnp.repeat(new_mask.astype(dtype), 3)
    full_new = jnp.concatenate([jnp.zeros((SENSOR_DIM,), dtype=dtype), mv_new])
    keep = 1.0 - full_new
    pdiag_full = jnp.concatenate(
        [
            jnp.zeros((SENSOR_DIM,), dtype=dtype),
            jnp.tile(settings.initial_point_cov_diag(dtype), state.xi0.capacity),
        ]
    )
    if settings.sqrt_covariance:
        Sigma = _sqrt_mask_reset(state.Sigma, keep, full_new * pdiag_full)
    else:
        Sigma = state.Sigma * keep[:, None] * keep[None, :]
        Sigma = Sigma + jnp.diag(full_new * pdiag_full)
    return state._replace(xi0=xi0, X=X, Sigma=Sigma)


def outlier_mask(
    state: EqFState,
    pixels: jnp.ndarray,
    vis_mask: jnp.ndarray,
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
) -> jnp.ndarray:
    """Two-stage ranked outlier rejection (reference ``VIOFilter.cpp:304-364``).

    Absolute-pixel-error outliers rank above Mahalanobis outliers; at most
    ``(1 - feature_retention) * M`` features are discarded.
    """
    if suite is None:
        suite = settings.suite
    xi0, X, Sigma = state.xi0, state.X, state.Sigma
    N = xi0.capacity
    dtype = Sigma.dtype
    tracked = xi0.mask & vis_mask

    xi_hat = state_estimate(state)
    y_hat, _ = measure_system(xi_hat, camera)
    resid = pixels - y_hat  # [N,2]
    err_abs = jnp.linalg.norm(resid, axis=-1)
    abs_out = tracked & (err_abs > settings.outlier_threshold_abs)

    # Mahalanobis gate with the marginal output covariance (VIO_eqf.cpp:196-211)
    C0 = suite.output_Ci(xi0.landmarks, X.Q, camera)  # [N,2,3]
    if settings.sqrt_covariance:
        # marginal 3x3 blocks from the factor's landmark rows
        L_lm = Sigma[SENSOR_DIM:].reshape(N, 3, -1)
        lm_diag = jnp.einsum("nxd,nyd->nxy", L_lm, L_lm)  # [N,3,3]
    else:
        lm_cov = Sigma[SENSOR_DIM:, SENSOR_DIM:].reshape(N, 3, N, 3)
        idx = jnp.arange(N)
        lm_diag = lm_cov[idx, :, idx, :]  # [N,3,3]
    out_cov = C0 @ lm_diag @ jnp.swapaxes(C0, -1, -2)  # [N,2,2]
    out_cov = out_cov + jnp.eye(2, dtype=dtype) * 1e-12
    # explicit closed-form 2x2 inverse
    a, b = out_cov[:, 0, 0], out_cov[:, 0, 1]
    c, d = out_cov[:, 1, 0], out_cov[:, 1, 1]
    det = a * d - b * c
    sol = jnp.stack(
        [d * resid[:, 0] - b * resid[:, 1], -c * resid[:, 0] + a * resid[:, 1]],
        axis=-1,
    ) / det[:, None]
    err_prob = jnp.sum(resid * sol, axis=-1)
    prob_out = tracked & ~abs_out & (err_prob > settings.outlier_threshold_prob)

    proposed = abs_out | prob_out
    # ranking score: absolute outliers dominate, larger error first
    score = jnp.where(
        abs_out, 1e12 + err_abs, jnp.where(prob_out, err_prob, -jnp.inf)
    )
    # stable descending order and its inverse, rank[i] = position of slot i,
    # with int32 indices: XLA's GPU compiler rejects the argsort of an int64
    # permutation that jnp.argsort emits under x64 (HLO verifier, jax 0.9)
    iota = jax.lax.iota(jnp.int32, score.shape[0])
    _, order = jax.lax.sort((-score, iota), num_keys=1, is_stable=True)
    rank = jnp.zeros_like(iota).at[order].set(iota)
    m_meas = jnp.sum(tracked)
    max_outliers = jnp.floor((1.0 - settings.feature_retention) * m_meas).astype(rank.dtype)
    return proposed & (rank < max_outliers)


def process_vision(
    state: EqFState,
    pixels: jnp.ndarray,  # [N,2]
    vis_mask: jnp.ndarray,  # [N] bool
    ids: jnp.ndarray,  # [N] tracker slot ids
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    do_update: bool = True,
) -> EqFState:
    """Full per-frame vision pipeline (reference ``VIOFilter.cpp:194-241``):
    remove lost -> outlier rejection -> add new -> EqF update -> prune invalid.

    ``do_update=False`` stops after the lifecycle/preprocessing stage (no EqF
    update) — used by the fused-path timing calibration to attribute device
    time to the reference's "preprocessing" vs "correction" labels.

    All of the frame's landmark-lifecycle covariance surgery (lost/outlier/
    invalid removal + new-slot initialisation) is folded into the update step
    via ``update_vision(..., surgery=...)`` — in sqrt mode that keeps the
    filter at exactly two QRs per frame (Riccati + Kailath).  Scale-invalid
    pruning (reference ``VIO_eqf.cpp:213-223``, applied post-update there)
    runs at frame entry here: a one-frame timing shift on a rare divergence
    guard.
    """
    if suite is None:
        suite = settings.suite
    xi0, X = state.xi0, state.X
    dtype = state.Sigma.dtype
    N = xi0.capacity

    # slot-id agreement: a reused slot with a different id is lost + new
    same_id = xi0.ids == ids
    if settings.remove_lost_landmarks:
        vis_tracked = vis_mask & same_id
        lost = xi0.mask & ~vis_tracked
    else:
        vis_tracked = vis_mask
        lost = jnp.zeros_like(xi0.mask)
    invalid = ((X.Q.a <= 1e-8) | (X.Q.a > 1e8)) & xi0.mask

    out = outlier_mask(state, pixels, vis_tracked, camera, settings, suite)
    rm = (lost | out | invalid) & xi0.mask
    kept = xi0.mask & ~rm
    # new slots: visible, not kept, and not just rejected as outliers
    new = vis_mask & ~out & ~kept

    # --- xi0 / X surgery: masks, ids, landmark origins, Q resets ---
    depth = (
        median_scene_depth(state, settings, mask=kept)
        if settings.use_median_depth
        else jnp.asarray(settings.initial_scene_depth, dtype=dtype)
    )
    q_new = camera.undistort(pixels) * depth
    dummy = jnp.asarray([0.0, 0.0, 1.0], dtype=dtype)
    landmarks = jnp.where(
        new[:, None], q_new, jnp.where(kept[:, None], xi0.landmarks, dummy)
    )
    ids_new = jnp.where(new, ids, jnp.where(kept, xi0.ids, -1))
    xi0_new = xi0._replace(landmarks=landmarks, ids=ids_new, mask=kept | new)
    eyeN = jnp.broadcast_to(jnp.eye(3, dtype=dtype), X.Q.R.shape)
    Q = X.Q._replace(
        R=jnp.where(kept[:, None, None], X.Q.R, eyeN),
        a=jnp.where(kept, X.Q.a, 1.0),
    )
    state = state._replace(xi0=xi0_new, X=X._replace(Q=Q))

    # --- Sigma surgery vectors (applied inside the update) ---
    keep_vec = jnp.concatenate(
        [jnp.ones((SENSOR_DIM,), dtype=dtype), jnp.repeat(kept.astype(dtype), 3)]
    )
    pv_init = jnp.tile(settings.initial_point_cov_diag(dtype), N).reshape(N, 3)
    add_lm = jnp.where(
        new[:, None],
        pv_init,
        jnp.where(kept[:, None], 0.0, settings.initial_point_var),
    )
    add_diag = jnp.concatenate(
        [jnp.zeros((SENSOR_DIM,), dtype=dtype), add_lm.reshape(-1)]
    )

    if not do_update:
        if settings.sqrt_covariance:
            Sigma = _sqrt_mask_reset(state.Sigma, keep_vec, add_diag)
        else:
            Sigma = state.Sigma * keep_vec[:, None] * keep_vec[None, :] + jnp.diag(add_diag)
        return state._replace(Sigma=Sigma)

    vis_upd = (vis_tracked & kept) | new
    return update_vision(
        state, pixels, vis_upd, camera, settings, suite,
        surgery=(keep_vec, add_diag),
    )


def health_check(state: EqFState, settings: Settings | None = None) -> dict:
    """Failure-detection flags, the masked-array form of the reference's
    pervasive asserts (``VIO_eqf.cpp:57,71,120,133``, ``VIOGroup::hasNaN``).

    Returns jnp scalars: ``nan`` (any NaN anywhere), ``sigma_pd`` (Cholesky
    of the masked Sigma succeeded), ``scales_valid`` (all active landmark
    scales inside [1e-8, 1e8]).  Cheap enough to run per keyframe.
    """
    from .group import group_has_nan

    nan = group_has_nan(state.X) | jnp.any(jnp.isnan(state.Sigma)) | jnp.any(
        jnp.isnan(state.xi0.landmarks)
    ) | jnp.any(jnp.isnan(state.xi0.sensor.pose.R))
    if settings is not None and settings.sqrt_covariance:
        # the state carries the Cholesky factor already: PD <=> diag > 0
        sigma_pd = jnp.all(jnp.diagonal(state.Sigma) > 0)
    else:
        chol = jnp.linalg.cholesky(state.Sigma)
        sigma_pd = ~jnp.any(jnp.isnan(chol))
    a = state.X.Q.a
    scales_valid = jnp.all(
        jnp.where(state.xi0.mask, (a > 1e-8) & (a < 1e8), True)
    )
    return {"nan": nan, "sigma_pd": sigma_pd, "scales_valid": scales_valid}


# ---------------------------------------------------------------------------
# Simulation-support API (reference VIOFilter.cpp:80-132)
# ---------------------------------------------------------------------------


def set_state(state: EqFState, xi: VIOState, settings: Settings) -> EqFState:
    """Reset the filter to an exact state (reference ``VIOFilter::setState``)."""
    dtype = state.Sigma.dtype
    capacity = xi.capacity
    X = group_identity(capacity, dtype)
    diag = jnp.concatenate(
        [
            settings.initial_sensor_cov_diag(dtype),
            jnp.tile(settings.initial_point_cov_diag(dtype), capacity),
        ]
    )
    Sigma0 = jnp.diag(jnp.sqrt(diag) if settings.sqrt_covariance else diag)
    Sigma = sanitize_sigma(Sigma0, xi, settings)
    return EqFState(xi0=xi, X=X, Sigma=Sigma, t=state.t)


def set_landmarks(
    state: EqFState, landmarks: jnp.ndarray, ids: jnp.ndarray, mask: jnp.ndarray,
    settings: Settings,
) -> EqFState:
    """Replace all landmark slots with exact values and reset their covariance
    (reference ``VIOFilter::setLandmarks``)."""
    dtype = state.Sigma.dtype
    xi0 = state.xi0._replace(landmarks=landmarks, ids=ids, mask=mask)
    eyeN = jnp.broadcast_to(jnp.eye(3, dtype=dtype), state.X.Q.R.shape)
    X = state.X._replace(Q=state.X.Q._replace(R=eyeN, a=jnp.ones_like(state.X.Q.a)))
    mv = jnp.concatenate(
        [jnp.zeros((SENSOR_DIM,), dtype=dtype), jnp.repeat(mask.astype(dtype), 3)]
    )
    keep = 1.0 - mv
    pdiag = jnp.concatenate(
        [
            jnp.zeros((SENSOR_DIM,), dtype=dtype),
            jnp.tile(settings.initial_point_cov_diag(dtype), xi0.capacity),
        ]
    )
    if settings.sqrt_covariance:
        Sigma = _sqrt_mask_reset(state.Sigma, keep, mv * pdiag)
    else:
        Sigma = state.Sigma * keep[:, None] * keep[None, :]
        Sigma = Sigma + jnp.diag(mv * pdiag)
    return state._replace(xi0=xi0, X=X, Sigma=sanitize_sigma(Sigma, xi0, settings))


def augment_landmarks(
    state: EqFState,
    new_mask: jnp.ndarray,
    ids: jnp.ndarray,
    true_points: jnp.ndarray,
    settings: Settings,
) -> EqFState:
    """Insert new landmark slots at exact (estimate-frame) positions
    (reference ``VIOFilter::augmentLandmarkStates``)."""
    dtype = state.xi0.landmarks.dtype
    landmarks = jnp.where(new_mask[:, None], true_points, state.xi0.landmarks)
    ids_new = jnp.where(new_mask, ids, state.xi0.ids)
    mask = state.xi0.mask | new_mask
    xi0 = state.xi0._replace(landmarks=landmarks, ids=ids_new, mask=mask)
    eyeN = jnp.broadcast_to(jnp.eye(3, dtype=dtype), state.X.Q.R.shape)
    Q = state.X.Q._replace(
        R=jnp.where(new_mask[:, None, None], eyeN, state.X.Q.R),
        a=jnp.where(new_mask, 1.0, state.X.Q.a),
    )
    X = state.X._replace(Q=Q)
    mv_new = jnp.repeat(new_mask.astype(dtype), 3)
    full_new = jnp.concatenate([jnp.zeros((SENSOR_DIM,), dtype=dtype), mv_new])
    keep = 1.0 - full_new
    pdiag_full = jnp.concatenate(
        [
            jnp.zeros((SENSOR_DIM,), dtype=dtype),
            jnp.tile(settings.initial_point_cov_diag(dtype), state.xi0.capacity),
        ]
    )
    if settings.sqrt_covariance:
        Sigma = _sqrt_mask_reset(state.Sigma, keep, full_new * pdiag_full)
    else:
        Sigma = state.Sigma * keep[:, None] * keep[None, :]
        Sigma = Sigma + jnp.diag(full_new * pdiag_full)
    return state._replace(xi0=xi0, X=X, Sigma=Sigma)


# ---------------------------------------------------------------------------
# Consistency metrics (reference VIO_eqf.cpp:153-170)
# ---------------------------------------------------------------------------


def compute_nees(
    state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
    settings: Settings | None = None,
) -> jnp.ndarray:
    """Normalised estimation error squared against a slot-aligned true state.

    ``true_state`` must carry the true landmark positions in the same slots as
    the filter (the simulator provides this alignment).
    """
    if suite is None:
        suite = (settings or Settings()).suite
    err_state = state_action(group_inv(state.X), true_state)
    eps = suite.chart.chart(err_state, state.xi0)
    mv = _mask_vec(state.xi0)
    eps = eps * mv
    # masked Sigma is block diagonal w.r.t. inactive slots (diag = const), so
    # solving on the full matrix is exact for the active subspace.  Sigma is
    # PD: solve via Cholesky.
    if settings is not None and settings.sqrt_covariance:
        w = jax.scipy.linalg.solve_triangular(state.Sigma, eps, lower=True)
        nees = jnp.sum(w * w)
    else:
        chol = jnp.linalg.cholesky(state.Sigma)
        w = jax.scipy.linalg.solve_triangular(chol, eps, lower=True)
        nees = jnp.sum(w * w)
    dim = SENSOR_DIM + 3 * jnp.sum(state.xi0.mask)
    return nees / dim


def compute_nees_breakdown(
    state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
    settings: Settings | None = None,
):
    """(total, pose, attitude) NEES against the marginal Sigma blocks
    (reference ``VIOWriter::writeConsistency``, VIOWriter.cpp:159-170)."""
    total, pose, att, *_ = consistency_outputs(state, true_state, suite, settings)
    return total, pose, att


def predict_state(
    state: EqFState, stamp, imu_window: IMU, dts: jnp.ndarray
) -> VIOState:
    """Forward-predict the state estimate over buffered IMU (``VIO_eqf.cpp:139-151``)."""
    xi = state_estimate(state)

    def body(x, inp):
        imu_i, dt_i = inp
        return integrate_system(x, imu_i, dt_i), None

    xi, _ = jax.lax.scan(body, xi, (imu_window, dts))
    return xi


def consistency_outputs(
    state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
    settings: Settings | None = None,
):
    """Everything the sim consistency CSVs need, in one pass
    (reference ``VIOWriter::writeConsistency``, VIOWriter.cpp:141-228):
    (total NEES, pose NEES, attitude NEES, sensor error coordinates
    eps[21], marginal Sigma diagonal[21], per-slot landmark position
    error norms [N]).
    """
    if suite is None:
        suite = (settings or Settings()).suite
    err_state = state_action(group_inv(state.X), true_state)
    eps = suite.chart.chart(err_state, state.xi0) * _mask_vec(state.xi0)
    dim = SENSOR_DIM + 3 * jnp.sum(state.xi0.mask)
    Sig = dense_sigma(state, settings)

    def pd_quad(M, v):  # v^T M^-1 v via Cholesky
        w = jax.scipy.linalg.solve_triangular(jnp.linalg.cholesky(M), v, lower=True)
        return jnp.sum(w * w)

    total = pd_quad(Sig, eps) / dim
    pose = pd_quad(Sig[6:12, 6:12], eps[6:12]) / 6.0
    att = pd_quad(Sig[6:9, 6:9], eps[6:9]) / 3.0
    est = state_estimate(state)
    lm_err = jnp.linalg.norm(est.landmarks - true_state.landmarks, axis=-1)
    lm_err = jnp.where(state.xi0.mask, lm_err, jnp.nan)
    return (
        total,
        pose,
        att,
        eps[:SENSOR_DIM],
        jnp.diagonal(Sig)[:SENSOR_DIM],
        lm_err,
    )
