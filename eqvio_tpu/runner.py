"""End-to-end simulation runner: the ``eqvio_sim`` equivalent.

Mirrors the reference's pure-simulation entry point (``src/main_sim.cpp:37-192``)
but as a single jitted ``lax.scan`` over frames: IMU propagation windows,
feature selection, slot tracking, landmark augmentation from the true state,
the EqF vision update, and NEES all execute on-device with no per-frame host
round-trips.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import filter as F
from .camera import PinholeCamera
from .sim import (
    Simulator,
    gather_slots_compact,
    slot_tracker_init,
    slot_tracker_step_compact,
)
from .states import IMU, VIOState
from .lie import SE3


def build_imu_windows(imu_times: np.ndarray, frame_times: np.ndarray, t_start: float):
    """Per-frame padded IMU application windows.

    Implements the reference's buffered-velocity semantics
    (``VIOFilter.cpp:160-178``): sample ``j`` applies from
    ``max(stamp_j, t_prev)`` to ``min(stamp_{j+1}, t_frame)``.
    Returns ``(sample_idx [T, K], dts [T, K])`` with zero-dt padding.
    """
    T = len(frame_times)
    idx_windows = []
    dt_windows = []
    prev = t_start
    ext = np.append(imu_times, np.inf)
    for ti in frame_times:
        j0 = np.searchsorted(imu_times, prev, side="right") - 1
        j0 = max(j0, 0)
        j1 = np.searchsorted(imu_times, ti, side="left")
        js = np.arange(j0, max(j1, j0 + 1))
        dts = np.minimum(ext[js + 1], ti) - np.maximum(imu_times[js], prev)
        dts = np.clip(dts, 0.0, None)
        idx_windows.append(js)
        dt_windows.append(dts)
        prev = ti
    K = max(len(w) for w in idx_windows)
    idx = np.zeros((T, K), dtype=np.int64)
    dts = np.zeros((T, K), dtype=np.float64)
    for i, (js, dw) in enumerate(zip(idx_windows, dt_windows)):
        idx[i, : len(js)] = js
        idx[i, len(js) :] = js[-1]  # repeat last sample with dt 0
        dts[i, : len(dw)] = dw
    return idx, dts


class SimRunResult(NamedTuple):
    times: jnp.ndarray  # [T]
    est_position: jnp.ndarray  # [T, 3]
    est_attitude: jnp.ndarray  # [T, 3, 3]
    est_velocity: jnp.ndarray  # [T, 3]
    true_position: jnp.ndarray  # [T, 3]
    true_attitude: jnp.ndarray  # [T, 3, 3]
    true_velocity: jnp.ndarray  # [T, 3]
    nees: jnp.ndarray  # [T]
    num_landmarks: jnp.ndarray  # [T]
    # full consistency mode: (pose_nees [T], attitude_nees [T], eps [T, 21],
    # sigma_diag [T, 21], landmark_err [T, N]); None unless requested
    consistency: tuple | None = None


def default_sim_camera(dtype=jnp.float64) -> PinholeCamera:
    """EuRoC-like pinhole camera (reference SimulationDataServer.cpp:162-176)."""
    return PinholeCamera.create(458.654, 457.296, 367.215, 248.375, 752, 480, dtype=dtype)


def example_frame_inputs(capacity: int = 16, window: int = 8, dtype=jnp.float32):
    """Fixed-seed inputs of one frame step: an IMU window near hover, its
    sample intervals, and ``capacity`` visible pixels with their ids."""
    rng = np.random.default_rng(0)
    imu_win = IMU(
        stamp=jnp.asarray(np.linspace(0.0, 0.035, window), dtype=dtype),
        gyr=jnp.asarray(rng.normal(size=(window, 3)) * 0.01, dtype=dtype),
        acc=jnp.asarray(
            rng.normal(size=(window, 3)) * 0.01 + np.array([0.0, 0.0, 9.81]), dtype=dtype
        ),
        gyr_bias_vel=jnp.zeros((window, 3), dtype=dtype),
        acc_bias_vel=jnp.zeros((window, 3), dtype=dtype),
    )
    dts = jnp.full((window,), 0.005, dtype=dtype)
    pixels = jnp.asarray(rng.uniform(100, 500, size=(capacity, 2)), dtype=dtype)
    vis = jnp.ones((capacity,), dtype=bool)
    ids = jnp.arange(capacity, dtype=jnp.int32)
    return imu_win, dts, pixels, vis, ids


class SimInputs(NamedTuple):
    """Prepared (host-side) inputs for a simulation run."""

    sim: Simulator
    camera: PinholeCamera
    state0: "F.EqFState"
    ftimes: jnp.ndarray
    idx: jnp.ndarray
    dts: jnp.ndarray
    imu_all: IMU
    max_features: int
    capacity: int
    pixel_noise: jnp.ndarray | None = None  # [T, capacity, 2]
    sel_ids: jnp.ndarray | None = None  # [T, F] selected world ids
    sel_pts: jnp.ndarray | None = None  # [T, F, 3] camera-frame points
    true_pos: jnp.ndarray | None = None  # [T, 3]
    true_R: jnp.ndarray | None = None  # [T, 3, 3]
    true_vel: jnp.ndarray | None = None  # [T, 3]
    true_lm_full: jnp.ndarray | None = None  # [T, P, 3] full-state mode only


def prepare_sim_inputs(
    settings: F.Settings,
    capacity: int = 32,
    max_features: int = 30,
    end_time: float = 30.0,
    imu_freq: float = 200.0,
    frame_freq: float = 20.0,
    kind: str = "wave",
    seed: int = 0,
    num_walls: int = 4,
    num_points: int = 1000,
    input_noise: bool = False,
    output_noise: bool = False,
    initial_noise: bool = False,
    noise_seed: int = 1,
    dtype=jnp.float64,
    sim: Simulator | None = None,
    camera: PinholeCamera | None = None,
    full_state: bool = False,
) -> SimInputs:
    """One-time host-side setup: trajectory, IMU batch, windows, initial state.

    Noise switches mirror the reference simulator's ``initialNoise /
    inputNoise / outputNoise`` (``VIOSimulator.cpp:163-167,258-262,300-307``):
    samples are drawn from the filter's own gain matrices.

    ``full_state``: every world landmark is part of the filter state from
    initialisation and stays there (reference ``eqvio_sim --fullState``,
    ``main_sim.cpp:56-59,139``; the initial condition is the simulator's full
    state with ALL world points, ``VIOSimulator.cpp:269-310``).  ``capacity``
    is overridden to the world size.
    """
    if sim is None:
        sim = Simulator.create(
            kind=kind,
            end_time=end_time + 1.0,
            seed=seed,
            num_walls=num_walls,
            num_points=num_points,
            dtype=dtype,
        )
    if camera is None:
        camera = default_sim_camera(dtype)
    if full_state:
        capacity = int(sim.world.shape[0])

    t0 = 0.2
    imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
    frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
    idx_np, dts_np = build_imu_windows(imu_times, frame_times, t0)

    imu_all = jax.jit(sim.get_imu_batch)(jnp.asarray(imu_times, dtype=dtype))

    nrng = np.random.default_rng(noise_seed)
    if input_noise:
        # cov = input gain * sampling frequency (VIOSimulator.cpp:163-167)
        sf = np.sqrt(imu_freq)
        gyr_n = nrng.normal(size=imu_all.gyr.shape) * settings.vel_gyr_noise * sf
        acc_n = nrng.normal(size=imu_all.acc.shape) * settings.vel_acc_noise * sf
        imu_all = imu_all._replace(
            gyr=imu_all.gyr + jnp.asarray(gyr_n, dtype=dtype),
            acc=imu_all.acc + jnp.asarray(acc_n, dtype=dtype),
        )

    # exact-state initialisation (reference main_sim.cpp:103, VIOFilter.cpp:43-56)
    true0 = sim.full_state(jnp.asarray(t0, dtype=dtype))
    state = F.init_state(settings, capacity, dtype)
    if full_state:
        # seed with the complete true state: all world landmarks active
        xi0 = true0._replace(
            sensor=true0.sensor._replace(camera_offset=sim.camera_offset)
        )
    else:
        xi0 = state.xi0._replace(
            sensor=true0.sensor._replace(camera_offset=sim.camera_offset)
        )
    state = state._replace(xi0=xi0, t=jnp.asarray(t0, dtype=dtype))

    if initial_noise:
        # perturb through the chart at the origin (VIOSimulator.cpp:300-307)
        D = state.xi0.dim()
        diag = np.concatenate(
            [
                np.asarray(settings.initial_sensor_cov_diag(dtype)),
                np.tile(np.asarray(settings.initial_point_cov_diag(dtype)), capacity),
            ]
        )
        eps = jnp.asarray(nrng.normal(size=D) * np.sqrt(diag), dtype=dtype)
        xi0_pert = settings.suite.chart.chart_inv(eps, state.xi0)
        state = state._replace(xi0=xi0_pert)

    pixel_noise = None
    if output_noise:
        Tn = len(frame_times)
        pixel_noise = jnp.asarray(
            nrng.normal(size=(Tn, capacity, 2)) * settings.measurement_noise,
            dtype=dtype,
        )

    # vectorise the per-frame feature selection and ground truth over the
    # whole sequence — only compact F-sized work remains inside the scan
    ftimes_j = jnp.asarray(frame_times, dtype=dtype)
    sel_ids, sel_pts = jax.jit(
        jax.vmap(lambda t: sim.get_vision_compact(t, camera, max_features))
    )(ftimes_j)
    true_states = jax.jit(jax.vmap(lambda t: sim.full_state(t)))(ftimes_j)
    true_pos = true_states.sensor.pose.x
    true_R = true_states.sensor.pose.R
    true_vel = true_states.sensor.velocity
    true_lm_full = true_states.landmarks if full_state else None

    return SimInputs(
        sim=sim,
        camera=camera,
        state0=state,
        ftimes=jnp.asarray(frame_times, dtype=dtype),
        idx=jnp.asarray(idx_np),
        dts=jnp.asarray(dts_np, dtype=dtype),
        imu_all=imu_all,
        max_features=max_features,
        capacity=capacity,
        pixel_noise=pixel_noise,
        sel_ids=sel_ids,
        sel_pts=sel_pts,
        true_pos=true_pos,
        true_R=true_R,
        true_vel=true_vel,
        true_lm_full=true_lm_full,
    )


def build_sim_runner(
    settings: F.Settings,
    inputs: SimInputs,
    augment_true_landmarks: bool = True,
    compute_nees: bool = True,
    batch: int | None = None,
    mesh=None,
    landmark_reset_every: int = 0,
    consistency: bool = False,
    full_state: bool = False,
):
    """Build a reusable jitted whole-sequence runner ``() -> SimRunResult``.

    ``batch``: run B independent filter instances of the same sequence in one
    vmapped program (outputs gain a leading batch axis).
    ``mesh``: optional ``jax.sharding.Mesh`` with a ``seq`` axis — the batch
    axis is sharded over it so the sequence fleet spans every device.
    ``landmark_reset_every``: if > 0, drop and re-insert every landmark at its
    true position every N frames (reference ``eqvio_sim --landmarkReset``,
    main_sim.cpp:177-183).

    The returned callable reuses one jit cache entry, so repeated invocations
    (benchmarking, Monte-Carlo sweeps) pay zero retrace cost.
    """
    sim, camera = inputs.sim, inputs.camera
    suite = settings.suite
    capacity = inputs.capacity
    max_features = inputs.max_features
    state = inputs.state0
    imu_all = inputs.imu_all
    ftimes, idx, dts = inputs.ftimes, inputs.idx, inputs.dts

    tracker = slot_tracker_init(capacity)

    pixel_noise = inputs.pixel_noise
    sel_ids_all, sel_pts_all = inputs.sel_ids, inputs.sel_pts
    true_pos, true_R, true_vel = inputs.true_pos, inputs.true_R, inputs.true_vel

    def frame_step(carry, scan_in):
        state, tracker = carry
        t_frame, widx, wdts, k_frame = scan_in

        imu_win = jax.tree.map(lambda a: a[widx], imu_all)
        state = F.propagate_window(
            state, imu_win, wdts, settings, suite,
            wide_factor=not full_state and not augment_true_landmarks,
        )

        if full_state:
            # eqvio_sim --fullState: slots are world points (id i == slot i);
            # measurement limited to the frame's maxFeatures selection, no
            # landmark lifecycle (all landmarks always in the state,
            # main_sim.cpp:56-59 + removeLostLandmarks=false semantics)
            sel = sel_ids_all[k_frame]
            match = (state.xi0.ids[:, None] == sel[None, :]) & (sel[None, :] >= 0)
            vis = jnp.any(match, axis=1)
            true_pts = inputs.true_lm_full[k_frame]
            pixels = jnp.where(vis[:, None], camera.project(true_pts), 0.0)
            if pixel_noise is not None:
                pixels = pixels + pixel_noise[k_frame] * vis[:, None]
            if landmark_reset_every > 0:
                # reference --landmarkReset applies in fullState mode too
                # (main_sim.cpp:177-183 -> VIOFilter::setLandmarks): snap every
                # landmark back to truth and reset its covariance block
                reset = (k_frame % landmark_reset_every) == 0
                reset_state = F.set_landmarks(
                    state, true_pts, state.xi0.ids, state.xi0.mask, settings
                )
                state = jax.tree.map(
                    lambda a, b: jnp.where(reset, a, b), reset_state, state
                )
            state = F.update_vision(state, pixels, vis, camera, settings, suite)
            true_slots_lms = true_pts
        else:
            tracker = slot_tracker_step_compact(tracker, sel_ids_all[k_frame])
            pixels, vis, ids, true_pts = gather_slots_compact(
                sel_ids_all[k_frame], sel_pts_all[k_frame], tracker, camera
            )
            if pixel_noise is not None:
                pixels = pixels + pixel_noise[k_frame] * vis[:, None]

        if full_state:
            pass
        elif augment_true_landmarks:
            # main_sim path: lost landmarks removed, new landmarks initialised
            # at their TRUE positions (reference VIOFilter::augmentLandmarkStates,
            # VIOFilter.cpp:112-132)
            same = state.xi0.ids == ids
            lost = state.xi0.mask & (~vis | ~same)
            if landmark_reset_every > 0:
                reset = (k_frame % landmark_reset_every) == 0
                lost = lost | (state.xi0.mask & reset)
            state = F.remove_landmarks(state, lost, settings)
            new = vis & ~state.xi0.mask
            state = _augment_true(state, new, ids, true_pts, settings)
            state = F.update_vision(state, pixels, vis, camera, settings, suite)
            state = F.remove_invalid_landmarks(state, settings)
        else:
            state = F.process_vision(state, pixels, vis, ids, camera, settings, suite)

        # consistency against the true state, slot-aligned from the compact
        # selection (landmark truth = selected camera-frame points)
        true_sensor = state.xi0.sensor._replace(
            pose=SE3(true_R[k_frame], true_pos[k_frame]),
            velocity=true_vel[k_frame],
            bias=jnp.zeros_like(state.xi0.sensor.bias),
            camera_offset=sim.camera_offset,
        )
        true_slots = VIOState(
            sensor=true_sensor,
            landmarks=true_slots_lms if full_state else jnp.where(
                state.xi0.mask[:, None],
                _lookup_true(sel_ids_all[k_frame], sel_pts_all[k_frame], state.xi0.ids),
                jnp.asarray([0.0, 0.0, 1.0], dtype=true_pts.dtype),
            ),
            ids=state.xi0.ids,
            mask=state.xi0.mask,
        )
        extras = ()
        if consistency:
            nees, pose_nees, att_nees, eps, sig_diag, lm_err = F.consistency_outputs(
                state, true_slots, suite, settings
            )
            extras = (pose_nees, att_nees, eps, sig_diag, lm_err)
        elif compute_nees:
            nees = F.compute_nees(state, true_slots, suite, settings)
        else:
            nees = jnp.asarray(jnp.nan, dtype=true_pos.dtype)

        est = F.state_estimate(state)
        out = (
            est.sensor.pose.x,
            est.sensor.pose.R,
            est.sensor.velocity,
            true_pos[k_frame],
            true_R[k_frame],
            true_vel[k_frame],
            nees,
            jnp.sum(state.xi0.mask),
        ) + extras
        return (state, tracker), out

    frame_ids = jnp.arange(ftimes.shape[0])

    @jax.jit
    def run_scan(state, tracker):
        return jax.lax.scan(frame_step, (state, tracker), (ftimes, idx, dts, frame_ids))

    def _cost(fn, *a):
        """XLA cost analysis of the jitted whole-sequence program (flops /
        bytes for utilization reporting; best-effort)."""
        try:
            ca = fn.lower(*a).compile().cost_analysis()
            return dict(ca) if ca else None
        except Exception:  # noqa: BLE001
            return None

    if batch is None:
        def run() -> SimRunResult:
            (_, _), outs = run_scan(state, tracker)
            if consistency:
                return SimRunResult(ftimes, *outs[:8], consistency=tuple(outs[8:]))
            return SimRunResult(ftimes, *outs)

        run.cost_analysis = lambda: _cost(run_scan, state, tracker)
        return run

    # batch-of-sequences mode: the whole scan vmapped over B identical
    # filter instances — the single-chip form of the reference's serial
    # multi-sequence driver (run_and_analyse_dataset.py:46-49); with a mesh,
    # the batch axis shards over devices (sequence-parallel scale-out)
    states_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), state)
    tracker_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), tracker)
    if mesh is not None:
        from .parallel.mesh import shard_batch

        states_b = shard_batch(mesh, jax.tree.map(jnp.asarray, states_b))
        tracker_b = shard_batch(mesh, jax.tree.map(jnp.asarray, tracker_b))
    vrun = jax.jit(jax.vmap(lambda s, tr: run_scan(s, tr)))

    def run_batch() -> SimRunResult:
        (_, _), outs = vrun(states_b, tracker_b)
        if consistency:
            return SimRunResult(ftimes, *outs[:8], consistency=tuple(outs[8:]))
        return SimRunResult(ftimes, *outs)

    run_batch.cost_analysis = lambda: _cost(vrun, states_b, tracker_b)
    return run_batch


def build_fleet_runner(settings: F.Settings, inputs_list: list[SimInputs],
                       augment_true_landmarks: bool = False, mesh=None):
    """Run K genuinely different sequences (worlds/noise per instance) as one
    vmapped program — the single-program form of the reference's serial
    multi-sequence driver, with distinct data per lane.

    All inputs must share frame/IMU shapes (same timing parameters).  Returns
    ``() -> SimRunResult`` with a leading K axis on every output.
    """
    proto = inputs_list[0]
    suite = settings.suite
    capacity = proto.capacity

    def stack(get):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[get(i) for i in inputs_list])

    imu_all_b = stack(lambda i: i.imu_all)
    sel_ids_b = jnp.stack([i.sel_ids for i in inputs_list])
    sel_pts_b = jnp.stack([i.sel_pts for i in inputs_list])
    state_b = stack(lambda i: i.state0)
    if proto.pixel_noise is not None:
        noise_b = jnp.stack([i.pixel_noise for i in inputs_list])
    else:
        T = proto.ftimes.shape[0]
        noise_b = jnp.zeros((len(inputs_list), T, capacity, 2), dtype=proto.true_pos.dtype)
    true_pos_b = jnp.stack([i.true_pos for i in inputs_list])
    true_R_b = jnp.stack([i.true_R for i in inputs_list])
    true_vel_b = jnp.stack([i.true_vel for i in inputs_list])
    ftimes, idx, dts = proto.ftimes, proto.idx, proto.dts
    camera = proto.camera

    def run_one(state, imu_all, sel_ids_all, sel_pts_all, pixel_noise, true_pos,
                true_R, true_vel):
        tracker = slot_tracker_init(capacity)

        def frame_step(carry, scan_in):
            state, tracker = carry
            t_frame, widx, wdts, k_frame = scan_in
            imu_win = jax.tree.map(lambda a: a[widx], imu_all)
            state = F.propagate_window(
                state, imu_win, wdts, settings, suite,
                wide_factor=not augment_true_landmarks,
            )
            tracker = slot_tracker_step_compact(tracker, sel_ids_all[k_frame])
            pixels, vis, ids, true_pts = gather_slots_compact(
                sel_ids_all[k_frame], sel_pts_all[k_frame], tracker, camera
            )
            pixels = pixels + pixel_noise[k_frame] * vis[:, None]
            if augment_true_landmarks:
                same = state.xi0.ids == ids
                lost = state.xi0.mask & (~vis | ~same)
                state = F.remove_landmarks(state, lost, settings)
                new = vis & ~state.xi0.mask
                state = _augment_true(state, new, ids, true_pts, settings)
                state = F.update_vision(state, pixels, vis, camera, settings, suite)
                state = F.remove_invalid_landmarks(state, settings)
            else:
                state = F.process_vision(state, pixels, vis, ids, camera, settings, suite)
            est = F.state_estimate(state)
            out = (
                est.sensor.pose.x, est.sensor.pose.R, est.sensor.velocity,
                true_pos[k_frame], true_R[k_frame], true_vel[k_frame],
                jnp.asarray(jnp.nan, dtype=true_pos.dtype),
                jnp.sum(state.xi0.mask),
            )
            return (state, tracker), out

        frame_ids = jnp.arange(ftimes.shape[0])
        (_, _), outs = jax.lax.scan(
            frame_step, (state, tracker), (ftimes, idx, dts, frame_ids)
        )
        return outs

    args = (state_b, imu_all_b, sel_ids_b, sel_pts_b, noise_b, true_pos_b,
            true_R_b, true_vel_b)
    if mesh is not None:
        from .parallel.mesh import shard_batch

        args = tuple(shard_batch(mesh, a) for a in args)
    vrun = jax.jit(jax.vmap(run_one))

    def run() -> SimRunResult:
        outs = vrun(*args)
        return SimRunResult(ftimes, *outs)

    return run


def run_prepared(
    settings: F.Settings,
    inputs: SimInputs,
    augment_true_landmarks: bool = True,
    compute_nees: bool = True,
    **kwargs,
) -> SimRunResult:
    """Run the jitted whole-sequence scan on prepared inputs."""
    return build_sim_runner(
        settings, inputs, augment_true_landmarks, compute_nees, **kwargs
    )()


def run_simulation(
    settings: F.Settings,
    augment_true_landmarks: bool = True,
    landmark_reset_every: int = 0,
    consistency: bool = False,
    full_state: bool = False,
    **kwargs,
) -> SimRunResult:
    """Prepare inputs and run the full simulated VIO pipeline (convenience)."""
    inputs = prepare_sim_inputs(settings, full_state=full_state, **kwargs)
    return run_prepared(
        settings, inputs, augment_true_landmarks,
        landmark_reset_every=landmark_reset_every,
        consistency=consistency,
        full_state=full_state,
    )


def _lookup_true(sel_ids, sel_pts, slot_ids):
    """Per-slot true camera-frame point by matching slot id in the selection."""
    match = (slot_ids[:, None] == sel_ids[None, :]) & (sel_ids[None, :] >= 0)
    src_idx = jnp.argmax(match, axis=1)
    return sel_pts[src_idx]


def _augment_true(state: F.EqFState, new_mask, ids, true_pts, settings: F.Settings):
    """Insert new landmarks at their true camera-frame positions
    (delegates to the filter's sim-support API)."""
    return F.augment_landmarks(state, new_mask, ids, true_pts, settings)


def _slot_true_state(true_full: VIOState, xi0: VIOState, capacity: int) -> VIOState:
    """Gather the true landmarks into the filter's slots by id."""
    P = true_full.landmarks.shape[0]
    safe = jnp.clip(xi0.ids, 0, P - 1)
    pts = true_full.landmarks[safe]
    dummy = jnp.asarray([0.0, 0.0, 1.0], dtype=pts.dtype)
    pts = jnp.where(xi0.mask[:, None], pts, dummy)
    return VIOState(
        sensor=true_full.sensor,
        landmarks=pts,
        ids=xi0.ids,
        mask=xi0.mask,
    )


# ---------------------------------------------------------------------------
# Trajectory evaluation (reference scripts/analysis_tools.py:85-183)
# ---------------------------------------------------------------------------


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """SIM(3) Umeyama alignment est -> gt. Returns (s, R, t)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    Xe = est - mu_e
    Xg = gt - mu_g
    cov = Xg.T @ Xe / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (Xe**2).sum() / len(est)
    s = np.trace(np.diag(d) @ S) / var_e if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error after SIM(3)/SE(3) alignment.

    Returns ``(rmse, scale)`` as in the reference analysis
    (``analysis_tools.py:274-284``).
    """
    s, R, t = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err**2).sum(axis=-1).mean())), float(s)


def attitude_rmse(est_att: np.ndarray, gt_att: np.ndarray) -> float:
    """Attitude RMSE in degrees after rotation-only alignment of the first pose."""
    R_align = gt_att[0] @ est_att[0].T
    errs = []
    for Re, Rg in zip(est_att, gt_att):
        dR = Rg.T @ (R_align @ Re)
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(errs))))
