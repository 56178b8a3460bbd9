"""Filter statistical consistency (vmapped particle Monte-Carlo) and e2e smoke.

Mirrors ``test/test_FilterStatistics.cpp``: mean NEES of a 1000-particle
population must stay near 1 at initialisation, through propagation, and
through a vision update with weighted resampling.  The reference's particle
loop becomes one vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eqvio_tpu import filter as F
from eqvio_tpu import group as G
from eqvio_tpu import states as S
from eqvio_tpu.camera import PinholeCamera
from eqvio_tpu.runner import default_sim_camera

from .utils import reasonable_state

NUM_PARTICLES = 1000
N = 2


def make_settings():
    # reference test_FilterStatistics.cpp:30-39
    return F.Settings(
        coordinate_choice="invdepth",
        initial_point_var=0.01**2,
        initial_point_depth_var=0.01**2,
        initial_bias_omega_var=0.01**2,
        initial_bias_accel_var=0.01**2,
        initial_velocity_var=0.1**2,
        initial_position_var=0.001**2,
    )


@pytest.fixture
def setup():
    rng = np.random.default_rng(99)
    settings = make_settings()
    suite = settings.suite
    xi0 = reasonable_state(rng, N)
    dtype = jnp.float64
    D = xi0.dim()
    diag = np.concatenate(
        [
            np.asarray(settings.initial_sensor_cov_diag(dtype)),
            np.tile(np.asarray(settings.initial_point_cov_diag(dtype)), N),
        ]
    )
    Sigma0 = jnp.asarray(np.diag(diag))
    state = F.EqFState(
        xi0=xi0, X=G.group_identity(N), Sigma=Sigma0, t=jnp.asarray(0.0)
    )

    # particles from the initial distribution via the innovation lift
    # (reference test_FilterStatistics.cpp:87-95)
    eps = rng.normal(size=(NUM_PARTICLES, D)) * np.sqrt(diag)[None, :]
    eps = jnp.asarray(eps)

    def make_particle(e):
        Delta = G.group_exp(suite.lift_innovation(e, xi0))
        return G.state_action(Delta, xi0)

    particles = jax.vmap(make_particle)(eps)
    return rng, settings, suite, state, particles


def mean_nees(state, particles, suite, settings):
    f = jax.vmap(lambda p: F.compute_nees(state, p, suite, settings))
    return float(jnp.mean(f(particles)))


def test_initial_distribution(setup):
    rng, settings, suite, state, particles = setup
    assert abs(mean_nees(state, particles, suite, settings) - 1.0) < 0.1


def test_propagation_consistency(setup):
    """Zero-noise propagation keeps NEES (test_FilterStatistics.cpp:100-116)."""
    rng, settings, suite, state, particles = setup
    import dataclasses

    zero_settings = dataclasses.replace(
        settings,
        bias_omega_process_var=0.0,
        bias_accel_process_var=0.0,
        attitude_process_var=0.0,
        position_process_var=0.0,
        velocity_process_var=0.0,
        camera_attitude_process_var=0.0,
        camera_position_process_var=0.0,
        point_process_var=0.0,
        vel_gyr_noise=0.0,
        vel_acc_noise=0.0,
        vel_gyr_bias_walk=0.0,
        vel_acc_bias_walk=0.0,
    )
    dt = 0.2
    imu = S.IMU.create(0.0, jnp.zeros(3), jnp.zeros(3))

    step_particles = jax.jit(
        jax.vmap(lambda p: S.integrate_system(p, imu, dt))
    )

    for rep in range(5):
        particles = step_particles(particles)
        state = F.integrate_riccati_discrete(state, imu, dt, zero_settings, suite)
        state = F.integrate_observer(state, imu, dt, zero_settings)
        nees = mean_nees(state, particles, suite, settings)
        assert abs(nees - 1.0) < 1.0, f"rep {rep}: NEES {nees}"


def test_update_consistency(setup):
    """Vision update against weighted-resampled particles
    (test_FilterStatistics.cpp:140-168)."""
    rng, settings, suite, state, particles = setup
    cam = default_sim_camera()

    meas_var = settings.measurement_noise**2
    y0, _ = S.measure_system(state.xi0, cam)
    noise = rng.normal(size=y0.shape) * settings.measurement_noise
    y_meas = jnp.asarray(np.asarray(y0) + noise)

    # particle weights by measurement likelihood
    def loglike(p):
        y, _ = S.measure_system(p, cam)
        e = (y_meas - y).reshape(-1)
        return -0.5 * jnp.sum(e * e) / meas_var

    ll = np.asarray(jax.vmap(loglike)(particles))
    w = np.exp(ll - ll.max())
    w = w / w.sum()
    idx = rng.choice(NUM_PARTICLES, size=NUM_PARTICLES, p=w)
    particles = jax.tree.map(lambda a: a[jnp.asarray(idx)], particles)

    vis = jnp.ones(N, dtype=bool)
    state = F.update_vision(state, y_meas, vis, cam, settings, suite)

    nees = mean_nees(state, particles, suite, settings)
    assert abs(nees - 1.0) < 0.5, f"NEES {nees}"


# ---------------------------------------------------------------------------
# End-to-end simulation smoke test
# ---------------------------------------------------------------------------


def test_sim_end_to_end():
    from eqvio_tpu.runner import ate_rmse, run_simulation

    settings = F.Settings(measurement_noise=0.5)
    res = run_simulation(
        settings, capacity=16, max_features=12, end_time=8.0, num_walls=4
    )
    nl = np.asarray(res.num_landmarks)
    assert not np.any(np.isnan(np.asarray(res.est_position)))
    # landmarks must be tracked for most of the sequence
    assert (nl > 0).mean() > 0.7
    rmse, scale = ate_rmse(np.asarray(res.est_position), np.asarray(res.true_position))
    assert rmse < 0.05
    assert abs(scale - 1.0) < 0.05


def test_sim_full_pipeline_with_outliers():
    """process_vision path (tracker-driven landmarks, no true augmentation)."""
    from eqvio_tpu.runner import ate_rmse, run_simulation

    settings = F.Settings(
        measurement_noise=0.5,
        initial_point_var=1.0,
        outlier_threshold_abs=100.0,
        outlier_threshold_prob=30.0,
    )
    res = run_simulation(
        settings,
        capacity=16,
        max_features=12,
        end_time=8.0,
        num_walls=4,
        augment_true_landmarks=False,
    )
    nl = np.asarray(res.num_landmarks)
    assert not np.any(np.isnan(np.asarray(res.est_position)))
    assert (nl > 0).mean() > 0.7
    rmse, _ = ate_rmse(np.asarray(res.est_position), np.asarray(res.true_position))
    assert rmse < 0.5


def test_sim_noisy_consistency():
    """With realistic IMU + pixel noise drawn from the filter's own gain
    matrices, the whole-trajectory NEES stays O(1) and the trajectory error
    stays bounded — the end-to-end analogue of the particle tests."""
    from eqvio_tpu.runner import ate_rmse, prepare_sim_inputs, run_prepared

    settings = F.Settings(
        measurement_noise=1.0,
        vel_gyr_noise=0.002,
        vel_acc_noise=0.02,
        initial_point_var=0.05,
    )
    inputs = prepare_sim_inputs(
        settings, capacity=16, max_features=12, end_time=10.0,
        input_noise=True, output_noise=True,
    )
    res = run_prepared(settings, inputs, augment_true_landmarks=True)
    nees = np.asarray(res.nees)
    est = np.asarray(res.est_position)
    assert not np.any(np.isnan(est))
    rmse, scale = ate_rmse(est, np.asarray(res.true_position))
    assert rmse < 0.3, rmse
    med = float(np.nanmedian(nees))
    assert 0.05 < med < 3.0, med


def test_sim_long_noisy_euroc_tuned():
    """60 s noisy self-initialising run with the reference's EuRoC-tuned
    process variances lands in the reference's EuRoC accuracy envelope
    (BASELINE.md: pos 0.056-0.277 m, scale 0.97-1.01)."""
    from eqvio_tpu.runner import ate_rmse, prepare_sim_inputs, run_prepared

    settings = F.Settings(
        measurement_noise=1.5, coordinate_choice="invdepth", fast_riccati=True,
        use_discrete_innovation_lift=False, use_median_depth=False,
        initial_scene_depth=3.0, initial_point_var=5.0,
        vel_gyr_noise=0.0003, vel_acc_noise=0.012,
        vel_gyr_bias_walk=0.00013, vel_acc_bias_walk=0.0045,
        bias_omega_process_var=0.0, bias_accel_process_var=0.0,
        attitude_process_var=6.0e-05, position_process_var=1.0e-05,
        velocity_process_var=0.025, point_process_var=3.0e-4,
        camera_attitude_process_var=5.1e-06, camera_position_process_var=1.2e-05,
        outlier_threshold_abs=20.0, outlier_threshold_prob=16.0,
    )
    inputs = prepare_sim_inputs(
        settings, capacity=32, max_features=30, end_time=40.0,
        input_noise=True, output_noise=True,
    )
    res = run_prepared(settings, inputs, augment_true_landmarks=False)
    est = np.asarray(res.est_position)
    assert not np.any(np.isnan(est))
    rmse, scale = ate_rmse(est, np.asarray(res.true_position))
    assert rmse < 0.35, rmse
    assert 0.85 < scale < 1.1, scale


def test_sim_normal_suite_end_to_end():
    """The normal coordinate suite (AD-conjugated matrices) runs the full
    pipeline without NaN and tracks accurately."""
    from eqvio_tpu.runner import ate_rmse, run_simulation

    settings = F.Settings(measurement_noise=0.5, coordinate_choice="normal")
    res = run_simulation(settings, capacity=12, max_features=10, end_time=5.0)
    est = np.asarray(res.est_position)
    assert not np.any(np.isnan(est))
    rmse, _ = ate_rmse(est, np.asarray(res.true_position))
    assert rmse < 0.05


def test_health_check():
    settings = F.Settings()
    state = F.init_state(settings, 4)
    h = F.health_check(state)
    assert not bool(h["nan"]) and bool(h["sigma_pd"]) and bool(h["scales_valid"])
    bad = state._replace(Sigma=state.Sigma.at[0, 0].set(jnp.nan))
    h2 = F.health_check(bad)
    assert bool(h2["nan"])
    indef = state._replace(Sigma=state.Sigma.at[0, 0].set(-1.0))
    h3 = F.health_check(indef)
    assert not bool(h3["sigma_pd"])


def test_consistency_outputs_mode():
    """Full consistency mode: pose/attitude NEES ~ O(1), eps within the
    marginal sigmas, landmark errors finite for live slots."""
    from eqvio_tpu.runner import run_simulation

    settings = F.Settings(measurement_noise=0.5)
    res = run_simulation(settings, capacity=12, max_features=10, end_time=6.0,
                         consistency=True)
    assert res.consistency is not None
    pose_nees, att_nees, eps, sig_diag, lm_err = [np.asarray(a) for a in res.consistency]
    T = len(np.asarray(res.times))
    assert pose_nees.shape == (T,) and eps.shape == (T, 21)
    assert sig_diag.shape == (T, 21) and lm_err.shape == (T, 12)
    assert np.all(np.isfinite(pose_nees)) and np.all(np.isfinite(att_nees))
    assert np.nanmedian(pose_nees) < 5.0
    # noise-free augmented run: eps small relative to marginal sigma
    assert np.all(np.abs(eps[-1]) <= 5 * np.sqrt(sig_diag[-1]) + 1e-6)
    live = ~np.isnan(lm_err[-1])
    assert live.sum() >= 5 and np.all(lm_err[-1][live] < 0.5)


def test_consistency_outputs_batch_mode():
    """Consistency extras survive the vmapped batch-of-sequences runner."""
    from eqvio_tpu.runner import build_sim_runner, prepare_sim_inputs

    settings = F.Settings(measurement_noise=0.5)
    inputs = prepare_sim_inputs(settings, capacity=8, max_features=6, end_time=3.0)
    res = build_sim_runner(settings, inputs, batch=2, consistency=True)()
    assert res.consistency is not None
    pose_nees = np.asarray(res.consistency[0])
    T = np.asarray(res.times).shape[0]
    assert pose_nees.shape == (2, T)
    assert np.all(np.isfinite(pose_nees))


def test_sqrt_covariance_matches_dense():
    """sqrt-mode (Cholesky-factor) filter == dense filter in f64 over a full
    self-initialising sim sequence, including landmark lifecycle."""
    import numpy as np

    from eqvio_tpu.runner import ate_rmse, run_simulation

    kw = dict(capacity=12, max_features=10, end_time=4.0, num_walls=4,
              augment_true_landmarks=False)
    res_d = run_simulation(F.Settings(measurement_noise=0.5), **kw)
    res_s = run_simulation(F.Settings(measurement_noise=0.5, sqrt_covariance=True), **kw)
    np.testing.assert_allclose(
        np.asarray(res_s.est_position), np.asarray(res_d.est_position),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(res_s.nees), np.asarray(res_d.nees), rtol=1e-4, atol=1e-8
    )


def test_sqrt_covariance_f32_survives_euroc_variances():
    """float32 + the reference's tuned EuRoC variances (spread ~1e13): the
    dense filter's Cholesky collapses, the sqrt filter must stay finite and
    track.  This is the f32 numerics case off the CPU (configs/config_EuRoC.yaml)."""
    import numpy as np

    euroc = dict(
        measurement_noise=1.9297839969591413,
        initial_attitude_var=0.13565029126052572,
        initial_bias_accel_var=1.5813333765300104,
        initial_bias_omega_var=97162.79515771076,
        initial_camera_attitude_var=0.0010228558965517584,
        initial_camera_position_var=0.023501400846134893,
        initial_point_var=129.90415638150924,
        initial_position_var=0.1,
        initial_velocity_var=8.974852995731e-08,
        attitude_process_var=6.025875320811407e-05,
        camera_attitude_process_var=5.075382174045239e-06,
        camera_position_process_var=1.2188313140115635e-05,
        point_process_var=0.00029845436136043135,
        position_process_var=9.981466095928483e-06,
        velocity_process_var=0.025317333863551263,
        bias_accel_process_var=0.0,
        bias_omega_process_var=0.0,
        coordinate_choice="invdepth",
        fast_riccati=True,
        use_discrete_innovation_lift=False,
        use_median_depth=True,
        initial_scene_depth=2.0,
    )
    import jax.numpy as jnp

    from eqvio_tpu.runner import prepare_sim_inputs, run_prepared

    settings = F.Settings(sqrt_covariance=True, **euroc)
    inputs = prepare_sim_inputs(settings, capacity=10, max_features=8,
                                end_time=3.0, dtype=jnp.float32)
    res = run_prepared(settings, inputs, augment_true_landmarks=False,
                       compute_nees=False)
    pos = np.asarray(res.est_position)
    assert not np.any(np.isnan(pos))
    err = np.linalg.norm(pos - np.asarray(res.true_position), axis=-1)
    assert err.max() < 1.0, err.max()


def test_process_vision_fused_surgery_matches_legacy_chain():
    """The round-4 fused-surgery ``process_vision`` (lifecycle covariance
    surgery folded into the update, scale-invalid pruning at entry) must
    equal the legacy remove -> add -> update chain when no scale-invalid
    slots exist, in BOTH covariance modes."""
    rng = np.random.default_rng(3)
    cam = default_sim_camera(jnp.float64)
    N = 10

    for sqrt_mode in (False, True):
        settings = F.Settings(measurement_noise=0.5, sqrt_covariance=sqrt_mode)
        suite = settings.suite
        state = F.init_state(settings, N, jnp.float64)
        # active slots 0..6 with landmarks in front of the camera
        pts = jnp.asarray(rng.uniform(-0.5, 0.5, size=(N, 3)) + [0, 0, 4.0])
        ids0 = jnp.arange(N, dtype=jnp.int64)
        mask0 = jnp.arange(N) < 7
        state = F.add_landmarks(
            state, cam.project(pts), mask0, ids0, cam, settings
        )
        # run a couple of updates so Sigma carries real correlations
        pix = cam.project(pts) + rng.normal(size=(N, 2)) * 0.3
        state = F.update_vision(state, pix, mask0, cam, settings, suite)

        # measurements: slot 2 lost, slot 3 reused with a new id, slot 8 new
        vis = mask0.at[2].set(False).at[8].set(True)
        ids = ids0.at[3].set(103).at[8].set(108)
        pix2 = cam.project(pts) + rng.normal(size=(N, 2)) * 0.3

        fused = F.process_vision(state, pix2, vis, ids, cam, settings, suite)

        # legacy chain (the pre-round-4 order, reference VIOFilter.cpp:194-241)
        st = state
        same_id = st.xi0.ids == ids
        lost = st.xi0.mask & (~vis | ~same_id)
        st = F.remove_landmarks(st, lost, settings)
        out = F.outlier_mask(st, pix2, vis & same_id, cam, settings, suite)
        st = F.remove_landmarks(st, out, settings)
        vis2 = vis & ~out
        new = vis2 & ~st.xi0.mask
        st = F.add_landmarks(st, pix2, new, ids, cam, settings)
        st = F.update_vision(st, pix2, vis2 & (st.xi0.mask | new), cam, settings, suite)
        st = F.remove_invalid_landmarks(st, settings)

        np.testing.assert_array_equal(np.asarray(fused.xi0.mask), np.asarray(st.xi0.mask))
        np.testing.assert_array_equal(np.asarray(fused.xi0.ids), np.asarray(st.xi0.ids))
        np.testing.assert_allclose(
            np.asarray(fused.X.A.x), np.asarray(st.X.A.x), atol=1e-9
        )
        Sig_f = np.asarray(F.dense_sigma(fused, settings))
        Sig_l = np.asarray(F.dense_sigma(st, settings))
        np.testing.assert_allclose(Sig_f, Sig_l, atol=1e-8), sqrt_mode


def test_one_qr_frame_fusion_matches_two_qr():
    """The one-QR frame fusion (``propagate_window(wide_factor=True)``: the
    Riccati stack feeds the Kailath pre-array un-triangularised) must equal
    the two-QR path exactly in covariance semantics, in f64 and f32, over a
    multi-frame sequence with landmark lifecycle and zero-dt window padding.

    Fuses the reference's two per-frame covariance steps
    (``VIO_eqf.cpp:62-72`` Riccati, ``VIO_eqf.cpp:105-135`` update) into a
    single QR — only the factor's Gram is meaningful, so skipping the
    intermediate re-triangularisation is exact algebra.
    """
    from eqvio_tpu.states import IMU

    for dtype, tol in ((jnp.float64, 1e-9), (jnp.float32, 2e-4)):
        rng = np.random.default_rng(11)
        cam = default_sim_camera(dtype)
        Ncap = 10
        settings = F.Settings(
            measurement_noise=0.5, sqrt_covariance=True, fast_riccati=True
        )
        suite = settings.suite
        state0 = F.init_state(settings, Ncap, dtype)
        pts = jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(Ncap, 3)) + [0, 0, 4.0], dtype=dtype
        )
        ids0 = jnp.arange(Ncap, dtype=jnp.int64)
        mask0 = jnp.arange(Ncap) < 7
        state0 = F.add_landmarks(state0, cam.project(pts), mask0, ids0, cam, settings)

        K = 4

        def run(wide):
            st = state0
            r = np.random.default_rng(7)
            for k in range(6):
                # last window entry is a zero-dt pad (must be a no-op)
                dts = jnp.asarray([0.005, 0.005, 0.005, 0.0], dtype=dtype)
                imu_win = IMU(
                    stamp=jnp.asarray([0.005 * (4 * k + i) for i in range(K)], dtype=dtype),
                    gyr=jnp.asarray(r.normal(size=(K, 3)) * 0.1, dtype=dtype),
                    acc=jnp.asarray(r.normal(size=(K, 3)) + [0, 0, 9.81], dtype=dtype),
                    gyr_bias_vel=jnp.zeros((K, 3), dtype=dtype),
                    acc_bias_vel=jnp.zeros((K, 3), dtype=dtype),
                )
                st = F.propagate_window(st, imu_win, dts, settings, suite,
                                        wide_factor=wide)
                pix = cam.project(pts) + jnp.asarray(
                    r.normal(size=(Ncap, 2)) * 0.3, dtype=dtype
                )
                # frame 3: lose slot 2, re-use slot 3 under a new id, add slot 8
                vis, ids = mask0, ids0
                if k == 3:
                    vis = mask0.at[2].set(False).at[8].set(True)
                    ids = ids0.at[3].set(103).at[8].set(108)
                st = F.process_vision(st, pix, vis, ids, cam, settings, suite)
            return st

        two_qr = run(False)
        one_qr = run(True)
        assert one_qr.Sigma.shape == two_qr.Sigma.shape  # re-squared by the update
        np.testing.assert_array_equal(
            np.asarray(one_qr.xi0.mask), np.asarray(two_qr.xi0.mask)
        )
        np.testing.assert_allclose(
            np.asarray(one_qr.X.A.x), np.asarray(two_qr.X.A.x), atol=tol
        )
        Sig_1 = np.asarray(F.dense_sigma(one_qr, settings))
        Sig_2 = np.asarray(F.dense_sigma(two_qr, settings))
        scale = max(1.0, np.abs(Sig_2).max())
        np.testing.assert_allclose(Sig_1 / scale, Sig_2 / scale, atol=tol)
