"""Real-data VIO entry point: the ``eqvio_opt`` equivalent.

CLI and pipeline mirror the reference main loop (``src/main_opt.cpp:45-277``):
dataset reader -> feature tracking -> EqF filter -> CSV outputs, with
``--start/--stop`` windowing, ``--timing`` rows, and the dataset camera yaml
overriding config extrinsics (``main_opt.cpp:143-147``).

Split: image decode + stream merge stay on the host prefetch thread; the
tracker and filter steps of a chunk of frames run as one jitted device
program (``--chunk 1``: two jitted programs per frame).

Usage:
    python -m eqvio_tpu.app.run_opt <dataset_dir> <config.yaml>
        [--mode asl|uzhfpv] [--output DIR] [--start T] [--stop T] [--timing]
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import filter as F
from ..camera import EquidistantCamera, PinholeCamera, RadTanCamera
from ..data import DataServer, create_dataset_reader
from ..frontend import tracker_init, tracker_step
from ..io import LoopTimer, VIOWriter, load_config, settings_from_config, tracker_config_from_config
from ..io.writer import rotation_to_quaternion
from ..states import IMU

TIMING_LABELS = ["features", "propagation", "preprocessing", "correction", "total vision update", "write output", "total"]


def _build_imu_window(imu_buf, t_prev, stamp, imu_window):
    """Assemble the zero-dt-padded IMU window covering [t_prev, stamp].

    Mirrors the reference's buffered-IMU integration semantics
    (``VIOFilter::integrateUpToTime``, VIOFilter.cpp:134-192): each buffered
    entry contributes its overlap with the window; zero-dt pad entries are
    exact no-ops in every propagation path (design invariant).

    Returns ``((stamps, gyr, acc, dts) numpy arrays, trimmed imu_buf)``.
    """
    kept = []
    for j, (ts, gyr, acc) in enumerate(imu_buf):
        t1 = imu_buf[j + 1][0] if j + 1 < len(imu_buf) else stamp
        dt = max(min(t1, stamp) - max(ts, t_prev), 0.0)
        if dt > 0 or not kept:
            kept.append((ts, gyr, acc, dt))
    kept = kept[-imu_window:]
    K = imu_window
    arr_stamp = np.full(K, kept[-1][0] if kept else stamp)
    arr_gyr = np.zeros((K, 3))
    arr_acc = np.zeros((K, 3))
    arr_dt = np.zeros(K)
    for j, (ts, gyr, acc, dt) in enumerate(kept):
        arr_stamp[j] = ts
        arr_gyr[j] = gyr
        arr_acc[j] = acc
        arr_dt[j] = dt
    for j in range(len(kept), K):
        if kept:
            arr_gyr[j] = kept[-1][1]
            arr_acc[j] = kept[-1][2]
    arr_stamp[len(kept):] = stamp
    # keep every entry still (partially) ahead of the frame: entry j covers
    # [t_j, t_{j+1}), so it is dead only once its successor's stamp <= stamp.
    # No fixed horizon — dropped frames / 10 Hz datasets keep full coverage.
    trimmed = [
        e for j, e in enumerate(imu_buf)
        if j + 1 >= len(imu_buf) or imu_buf[j + 1][0] > stamp
    ]
    return (arr_stamp, arr_gyr, arr_acc, arr_dt), trimmed


def camera_from_info(info, dtype=jnp.float64):
    fx, fy, cx, cy = info.intrinsics
    w, h = info.resolution
    if info.model == "radtan":
        if np.allclose(info.distortion, 0.0):
            return PinholeCamera.create(fx, fy, cx, cy, w, h, dtype=dtype)
        return RadTanCamera.create(fx, fy, cx, cy, info.distortion, w, h, dtype=dtype)
    if info.model == "equidistant":
        return EquidistantCamera.create(fx, fy, cx, cy, info.distortion, w, h, dtype=dtype)
    return PinholeCamera.create(fx, fy, cx, cy, w, h, dtype=dtype)


def _meta_width(imu_window: int) -> int:
    """Per-frame packed-meta width: K stamps + 3K gyr + 3K acc + K dts +
    stamp + valid."""
    return 8 * imu_window + 2


def _out_width(capacity: int) -> int:
    """Per-frame packed-output width: 33 sensor values + searched flag +
    3N landmarks + N est-ids + N est-mask + 2N pixels + N tracker-ids +
    N visibility."""
    return 34 + 9 * capacity


def _unpack_outputs(row: np.ndarray, N: int):
    """Host-side inverse of the device packing in ``_make_chunk_runner``."""
    o = 0

    def take(k, shape=None):
        nonlocal o
        v = row[o:o + k]
        o += k
        return v.reshape(shape) if shape else v

    pR = take(9, (3, 3))
    px = take(3)
    vel = take(3)
    cR = take(9, (3, 3))
    cx = take(3)
    bias = take(6)
    searched = take(1)[0] > 0.5
    lms = take(3 * N, (N, 3))
    lids = take(N).astype(np.int64)
    lmask = take(N) > 0.5
    fpx = take(2 * N, (N, 2))
    fids = take(N).astype(np.int64)
    fvis = take(N) > 0.5
    return pR, px, vel, cR, cx, bias, searched, lms, lids, lmask, fpx, fids, fvis


def _make_frame_fn(tcfg, settings, suite, camera, imu_window, dtype):
    """The per-frame scan body (tracker -> propagate -> vision update) shared
    by the single-sequence chunk runner and the batched (vmapped) runner."""
    from ..frontend.tracker import tracker_step as _tracker_step

    K = imu_window

    def frame_fn(carry, inp):
        state, tracker = carry
        img, meta = inp
        stamps_w = meta[:K]
        gyr_w = meta[K:4 * K].reshape(K, 3)
        acc_w = meta[4 * K:7 * K].reshape(K, 3)
        dts = meta[7 * K:8 * K]
        stamp = meta[8 * K]
        valid = meta[8 * K + 1] > 0.5
        imu_win = IMU(
            stamp=stamps_w,
            gyr=gyr_w,
            acc=acc_w,
            gyr_bias_vel=jnp.zeros((K, 3), dtype=dtype),
            acc_bias_vel=jnp.zeros((K, 3), dtype=dtype),
        )
        if settings.use_feature_predictions:
            # feature predictions stay ON DEVICE: forward-predict the state
            # over the frame's IMU window and project (reference
            # getFeaturePredictions, VIOFilter.cpp:247-252)
            xi_pred = F.predict_state(state, stamp, imu_win, dts)
            pred_px = camera.project(xi_pred.landmarks).astype(jnp.float32)
            predicted = jnp.where(
                xi_pred.mask[:, None], pred_px, tracker.positions
            )
            new_tracker = _tracker_step(tracker, img, tcfg, predicted=predicted)
        else:
            new_tracker = _tracker_step(tracker, img, tcfg)
        pixels = new_tracker.positions.astype(dtype)
        vis = new_tracker.mask
        ids = new_tracker.ids
        # one-QR frame: the Riccati stack feeds the Kailath pre-array directly
        new_state = F.propagate_window(
            state, imu_win, dts, settings, suite, wide_factor=True
        )
        new_state = F.process_vision(
            new_state, pixels, vis, ids, camera, settings, suite
        )
        new_state = new_state._replace(t=stamp)
        state = jax.tree.map(lambda a, b: jnp.where(valid, a, b), new_state, state)
        tracker = jax.tree.map(
            lambda a, b: jnp.where(valid, a, b), new_tracker, tracker
        )
        est = F.state_estimate(state)
        # pack in the filter dtype so f64 CPU runs keep full CSV precision
        out = jnp.concatenate([
            est.sensor.pose.R.reshape(-1).astype(dtype),
            est.sensor.pose.x.astype(dtype),
            est.sensor.velocity.astype(dtype),
            est.sensor.camera_offset.R.reshape(-1).astype(dtype),
            est.sensor.camera_offset.x.astype(dtype),
            est.sensor.bias.astype(dtype),
            jnp.where(valid, new_tracker.searched, False).astype(dtype).reshape(1),
            est.landmarks.reshape(-1).astype(dtype),
            est.ids.astype(dtype),
            est.mask.astype(dtype),
            pixels.reshape(-1).astype(dtype),
            ids.astype(dtype),
            vis.astype(dtype),
        ])
        return (state, tracker), out

    return frame_fn


def _make_chunk_runner(tcfg, settings, suite, camera, imu_window, dtype):
    """One jitted program: scan (tracker -> propagate -> vision update) over a
    fixed-size chunk of frames, in place of the reference's
    per-frame loop (``main_opt.cpp:178-245``): decode->track->filter are fused
    into a single device program, host transfers amortised chunk-size times.

    Padded tail frames carry ``valid=False`` and pass the carry through
    unchanged, so every chunk has one static shape -> exactly one compile.

    Transfer layout: all non-image inputs pack into ONE [C, 8K+2] array and
    all per-frame outputs pack into ONE [C, 34+9N] array, so a chunk is
    exactly two uploads (images uint8 + meta) and one output fetch.
    """
    frame_fn = _make_frame_fn(tcfg, settings, suite, camera, imu_window, dtype)

    def run_chunk(state, tracker, imgs_u8, meta):
        # frames ship as uint8 (4x less host->device traffic than f32) and
        # are normalised on device
        imgs = imgs_u8.astype(jnp.float32) * (1.0 / 255.0)
        return jax.lax.scan(frame_fn, (state, tracker), (imgs, meta))

    # donate the carry: the previous chunk's state/tracker buffers are dead
    # the moment the next chunk is dispatched
    return jax.jit(run_chunk, donate_argnums=(0, 1))


def _make_batch_chunk_runner(tcfg, settings, suite, camera, imu_window, dtype):
    """Batched fused chunk program: vmap the full tracker+filter frame scan
    over B independent sequence instances (SURVEY §2.9 sequence parallelism,
    tracker-INCLUSIVE — the reference runs sequences serially,
    ``run_and_analyse_dataset.py:46-49``).  One chip, B whole pipelines."""
    frame_fn = _make_frame_fn(tcfg, settings, suite, camera, imu_window, dtype)

    def run_chunk_b(state_b, tracker_b, imgs_u8_b, meta_b):
        imgs_b = imgs_u8_b.astype(jnp.float32) * (1.0 / 255.0)

        def one(state, tracker, imgs, meta):
            return jax.lax.scan(frame_fn, (state, tracker), (imgs, meta))

        return jax.vmap(one)(state_b, tracker_b, imgs_b, meta_b)

    return jax.jit(run_chunk_b, donate_argnums=(0, 1))


def _make_stage_runners(tcfg, settings, suite, camera, imu_window, dtype):
    """Jitted per-stage chunk scans for device-time attribution.

    The fused chunk program hides the reference's per-section split
    (``main_opt.cpp:120-121`` labels: features / propagation / preprocessing /
    correction) inside one device program.  These four scans re-run the same
    chunk stage-by-stage with ``block_until_ready`` so ``--timing`` rows carry
    real device costs per section (differences attribute preprocessing vs
    correction).  Used once per run, on one representative full chunk.

    Note: when ``use_feature_predictions`` is on, the calibration's feature
    stage tracks without predictions (the coupled state is not available
    stage-wise); the shipped EuRoC/UZH-FPV configs run with predictions off.
    """
    import dataclasses as _dc

    from ..frontend.tracker import tracker_step as _tracker_step

    K = imu_window

    def _feat_scan_for(cfg):
        def feat_scan(tracker, imgs_u8):
            imgs = imgs_u8.astype(jnp.float32) * (1.0 / 255.0)

            def body(trk, img):
                trk = _tracker_step(trk, img, cfg)
                return trk, (trk.positions, trk.mask, trk.ids)

            return jax.lax.scan(body, tracker, imgs)

        return feat_scan

    feat_scan = _feat_scan_for(tcfg)
    # gated/ungated detector variants: per-frame timing rows select between
    # them by the frame's searched flag (the reference's per-frame timing.csv
    # shows exactly this bimodality, VIOWriter.cpp:97-115)
    feat_scan_full = _feat_scan_for(
        _dc.replace(tcfg, feature_search_threshold=1.0)
    )
    feat_scan_skip = _feat_scan_for(
        _dc.replace(tcfg, feature_search_threshold=0.0)
    )

    def _window(stamps_w, gyr_w, acc_w):
        return IMU(
            stamp=stamps_w,
            gyr=gyr_w,
            acc=acc_w,
            gyr_bias_vel=jnp.zeros((K, 3), dtype=dtype),
            acc_bias_vel=jnp.zeros((K, 3), dtype=dtype),
        )

    def prop_scan(state, stamps_w, gyr_w, acc_w, dts):
        def body(st, inp):
            sw, gw, aw, dt = inp
            st = F.propagate_window(st, _window(sw, gw, aw), dt, settings, suite)
            return st, st.t

        return jax.lax.scan(body, state, (stamps_w, gyr_w, acc_w, dts))

    def _vision_scan(do_update):
        def scan(state, stamps_w, gyr_w, acc_w, dts, pix_seq, vis_seq, ids_seq):
            def body(st, inp):
                sw, gw, aw, dt, pix, vis, ids = inp
                st = F.propagate_window(
                    st, _window(sw, gw, aw), dt, settings, suite, wide_factor=True
                )
                st = F.process_vision(
                    st, pix.astype(dtype), vis, ids, camera, settings, suite,
                    do_update=do_update,
                )
                return st, st.t

            return jax.lax.scan(
                body, state, (stamps_w, gyr_w, acc_w, dts, pix_seq, vis_seq, ids_seq)
            )

        return scan

    return (
        jax.jit(feat_scan),
        jax.jit(feat_scan_full),
        jax.jit(feat_scan_skip),
        jax.jit(prop_scan),
        jax.jit(_vision_scan(do_update=False)),
        jax.jit(_vision_scan(do_update=True)),
    )


def _setup_from_config(dataset_dir, config, mode="asl", camera_yaml=None,
                       camera_lag=None, imu_window=None, dtype=jnp.float64):
    """Shared pipeline setup: reader, settings (with dataset-extrinsics
    override and the f32->sqrt auto-enable), tracker config, camera, initial
    filter/tracker states, IMU-window sizing.  Used by :func:`run_dataset`
    and the batched throughput bench (:func:`bench_batch_full_frame`)."""
    if camera_lag is None:
        camera_lag = float((config.get("main", {}) or {}).get("cameraLag", 0.0))
    reader = create_dataset_reader(mode, dataset_dir, camera_yaml, camera_lag)

    if imu_window is None:
        # size the padded IMU window to the dataset's IMU-per-frame ratio:
        # every pad entry is a scan iteration the device still executes
        # (a no-op by the zero-dt invariant, but not free)
        ist, fst = reader.imu.stamps, reader.images.stamps
        if len(ist) > 2 and len(fst) > 2:
            ratio = float(np.median(np.diff(fst)) / np.median(np.diff(ist)))
            imu_window = max(8, (int(np.ceil(ratio * 1.25)) + 6) // 4 * 4)
        else:
            imu_window = 32

    settings = settings_from_config(config)
    tcfg = tracker_config_from_config(config)

    # dataset camera extrinsics override the config (main_opt.cpp:143-147)
    T_BS = reader.camera.T_BS
    quat = rotation_to_quaternion(T_BS[:3, :3])
    settings = F.Settings(
        **{
            **settings.__dict__,
            "camera_offset_quat": tuple(quat.tolist()),
            "camera_offset_pos": tuple(T_BS[:3, 3].tolist()),
        }
    )
    if jnp.dtype(dtype) == jnp.float32 and not settings.sqrt_covariance:
        # f32 cannot Cholesky the tuned configs' covariance spread (~1e13);
        # the sqrt filter carries the factor instead (condition = sqrt of the
        # covariance's).  Auto-enable unless the config asked explicitly.
        from ..io.config import safe_get

        explicit = safe_get(config.get("eqf", {}) or {},
                            "settings:useSqrtCovariance", None, warn=False)
        if explicit is None:
            settings = F.Settings(**{**settings.__dict__, "sqrt_covariance": True})

    camera = camera_from_info(reader.camera, dtype)
    capacity = tcfg.max_features
    w, h = reader.camera.resolution

    state = F.init_state(settings, capacity, dtype)
    tracker = tracker_init(tcfg, (h, w), dtype=jnp.float32)
    suite = settings.suite
    return reader, settings, tcfg, camera, capacity, state, tracker, suite, imu_window


def run_dataset(
    dataset_dir: str,
    config: dict,
    mode: str = "asl",
    output_dir: str | None = None,
    start: float | None = None,
    stop: float | None = None,
    camera_yaml: str | None = None,
    timing: bool = False,
    imu_window: int | None = None,
    dtype=jnp.float64,
    limit_frames: int | None = None,
    simvis: bool = False,
    simimu: bool = False,
    limit_rate: float | None = None,
    profile_dir: str | None = None,
    camera_lag: float | None = None,
    chunk_size: int = 16,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    resume: str | None = None,
    live_port: int | None = None,
):
    """Run the full real-data pipeline; returns (writer, summary dict).

    ``start``/``stop`` are offsets from the first data time, matching the
    reference (``main_opt.cpp:124-130``), so batch YAMLs carry portable
    per-sequence windows instead of absolute epoch stamps.

    ``checkpoint_every=N`` saves the complete pipeline state (filter, tracker,
    IMU buffer, stream cursor) to ``checkpoint_path`` (default
    ``output_dir/checkpoint.npz``) every ~N frames at chunk boundaries;
    ``resume=PATH`` restarts from such a checkpoint, reproducing the
    uninterrupted run exactly (SURVEY §5.4 — no reference equivalent, the
    closest is one-shot CSV serialisation at ``VIO_eqf.cpp:247``).
    """
    reader, settings, tcfg, camera, capacity, state, tracker, suite, imu_window = \
        _setup_from_config(dataset_dir, config, mode, camera_yaml, camera_lag,
                           imu_window, dtype)

    first_stamps = [s[0] for s in (reader.imu.stamps, reader.images.stamps) if len(s)]
    t0_data = float(min(first_stamps)) if first_stamps else 0.0
    start = t0_data + start if start and start > 0 else None
    stop = t0_data + stop if stop and stop > 0 else None

    resume_cursor = None
    if resume:
        from ..checkpoint import load_checkpoint

        state, trk_saved, resume_cursor, _ = load_checkpoint(resume, dtype=dtype)
        if trk_saved is not None:
            tracker = trk_saved
    if checkpoint_path is None and checkpoint_every and output_dir:
        import os

        checkpoint_path = os.path.join(output_dir, "checkpoint.npz")

    sim = None
    sim_tracker = None
    if simvis or simimu:
        # replace real vision and/or IMU with simulated measurements generated
        # around the dataset ground truth (reference --simvis/--simimu,
        # main_opt.cpp:194-198,249-253 via DataServerBase::getSimVision/getSimIMU)
        from ..analysis import quat_to_rot
        from ..lie import SE3 as _SE3
        from ..sim import Simulator, slot_tracker_init

        gt = reader.groundtruth
        if gt is None:
            raise ValueError("--simvis/--simimu need dataset ground truth")
        poses = _SE3(
            jnp.asarray(quat_to_rot(gt.quaternion), dtype=dtype),
            jnp.asarray(gt.position, dtype=dtype),
        )
        sim = Simulator.from_poses(
            gt.stamps, poses, settings.camera_offset_se3(dtype), dtype=dtype
        )
        if simvis:
            sim_tracker = slot_tracker_init(capacity)

    jit_tracker = jax.jit(lambda ts, img: tracker_step(ts, img, tcfg))
    # one persistent jit for the predicted-feature tracker path: constructing
    # the closure per frame would retrace and recompile every frame
    jit_tracker_pred = jax.jit(
        lambda ts, img, pr: tracker_step(ts, img, tcfg, predicted=pr)
    )

    @jax.jit
    def jit_filter(state, imu_win, dts, pixels, vis, ids):
        state = F.propagate_window(
            state, imu_win, dts, settings, suite, wide_factor=True
        )
        state = F.process_vision(state, pixels, vis, ids, camera, settings, suite)
        return state

    server = DataServer(reader, start_time=start, stop_time=stop)

    writer = VIOWriter(output_dir) if output_dir else None
    loop_timer = LoopTimer(TIMING_LABELS)

    if chunk_size > 1 and not simvis:
        return _run_fused(
            server, state, tracker, tcfg, settings, suite, camera, writer,
            timing, imu_window, dtype, chunk_size, limit_frames, limit_rate,
            profile_dir, simimu, sim,
            checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
            resume_cursor=resume_cursor, live_port=live_port,
        )
    if checkpoint_every or resume_cursor:
        raise ValueError(
            "checkpoint/resume is wired into the fused chunk path; "
            "run with chunk_size > 1 (and without --simvis)"
        )

    imu_buf: list[tuple[float, np.ndarray, np.ndarray]] = []
    initialised = False
    n_frames = 0
    t_prev_host = -1.0  # host-tracked filter time: avoids a device sync per frame
    t_begin = time.perf_counter()

    if profile_dir:
        # device-level kernel attribution (roadmap: host wall-time sections
        # can't see inside the fused jit programs): XLA trace viewable in
        # TensorBoard / xprof
        jax.profiler.start_trace(profile_dir)

    rate_mark = time.perf_counter()
    for meas in server:
        if meas.kind == "imu":
            gyr, acc = meas.data
            if simimu:
                sim_imu = sim.get_imu(jnp.asarray(meas.stamp, dtype=dtype))
                gyr = np.asarray(sim_imu.gyr)
                acc = np.asarray(sim_imu.acc)
            if not initialised:
                state = F.initialize_attitude_from_imu(
                    state,
                    IMU.create(
                        jnp.asarray(meas.stamp, dtype=dtype),
                        jnp.asarray(gyr, dtype=dtype),
                        jnp.asarray(acc, dtype=dtype),
                    ),
                )
                initialised = True
            imu_buf.append((meas.stamp, gyr, acc))
            continue

        # ---- image measurement ----
        if not initialised:
            continue
        loop_timer.start_loop()
        loop_timer.start_timing("total")

        loop_timer.start_timing("features")
        img = np.asarray(meas.data)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) * (1.0 / 255.0)
        img = jnp.asarray(img, dtype=jnp.float32)
        if simvis:
            from ..sim import gather_slots_compact, slot_tracker_step_compact

            sel_ids, sel_pts = sim.get_vision_compact(
                jnp.asarray(meas.stamp, dtype=dtype), camera, tcfg.max_features
            )
            sim_tracker = slot_tracker_step_compact(sim_tracker, sel_ids)
            pixels, vis, ids, _ = gather_slots_compact(sel_ids, sel_pts, sim_tracker, camera)
        elif settings.use_feature_predictions:
            # predict feature pixels from the current state, all on device
            # (reference getFeaturePredictions, VIOFilter.cpp:247-252)
            est = F.state_estimate(state)
            predicted = jnp.where(
                est.mask[:, None],
                camera.project(est.landmarks).astype(jnp.float32),
                tracker.positions,
            )
            tracker = jit_tracker_pred(tracker, img, predicted)
        else:
            tracker = jit_tracker(tracker, img)
        if not simvis:
            pixels = jnp.asarray(tracker.positions, dtype=dtype)
            vis = tracker.mask
            ids = tracker.ids
        loop_timer.end_timing("features")

        # build the padded IMU window for [prev_t, stamp]
        loop_timer.start_timing("propagation")
        t_prev = t_prev_host if t_prev_host >= 0 else float(state.t)
        (arr_stamp, arr_gyr, arr_acc, arr_dt), imu_buf = _build_imu_window(
            imu_buf, t_prev, meas.stamp, imu_window
        )
        K = imu_window
        imu_win = IMU(
            stamp=jnp.asarray(arr_stamp, dtype=dtype),
            gyr=jnp.asarray(arr_gyr, dtype=dtype),
            acc=jnp.asarray(arr_acc, dtype=dtype),
            gyr_bias_vel=jnp.zeros((K, 3), dtype=dtype),
            acc_bias_vel=jnp.zeros((K, 3), dtype=dtype),
        )
        loop_timer.end_timing("propagation")

        loop_timer.start_timing("total vision update")
        state = jit_filter(
            state, imu_win, jnp.asarray(arr_dt, dtype=dtype), pixels, vis, ids
        )
        state = state._replace(t=jnp.asarray(meas.stamp, dtype=dtype))
        t_prev_host = meas.stamp
        loop_timer.end_timing("total vision update")

        loop_timer.start_timing("write output")
        if writer is not None:
            est = F.state_estimate(state)
            writer.write_states(
                meas.stamp,
                np.asarray(est.sensor.pose.R),
                np.asarray(est.sensor.pose.x),
                np.asarray(est.sensor.velocity),
                np.asarray(est.sensor.camera_offset.R),
                np.asarray(est.sensor.camera_offset.x),
                np.asarray(est.sensor.bias),
                landmarks=np.asarray(est.landmarks),
                landmark_ids=np.asarray(est.ids),
                landmark_mask=np.asarray(est.mask),
            )
            writer.write_features(meas.stamp, np.asarray(pixels), np.asarray(ids), np.asarray(vis))
        loop_timer.end_timing("write output")
        loop_timer.end_timing("total")

        if writer is not None and timing:
            t0_row, row = loop_timer.frame_row()
            writer.write_timing(t0_row, row)

        n_frames += 1
        if limit_frames and n_frames >= limit_frames:
            break
        if limit_rate and limit_rate > 0:
            # pace the loop to at most limit_rate frames/s (main_opt.cpp:241-244)
            sleep_for = rate_mark + 1.0 / limit_rate - time.perf_counter()
            if sleep_for > 0:
                time.sleep(sleep_for)
            rate_mark = time.perf_counter()

    elapsed = time.perf_counter() - t_begin
    if profile_dir:
        jax.profiler.stop_trace()
    if writer is not None:
        writer.flush()
    est = F.state_estimate(state)
    health = {k: bool(v) for k, v in F.health_check(state, settings).items()}
    summary = {
        "frames": n_frames,
        "fps": n_frames / max(elapsed, 1e-9),
        "final_position": np.asarray(est.sensor.pose.x).tolist(),
        "landmarks": int(np.asarray(est.mask).sum()),
        "nan": health["nan"],
        "healthy": health["nan"] is False and health["scales_valid"],
    }
    return state, summary


def _run_fused(
    server, state, tracker, tcfg, settings, suite, camera, writer,
    timing, imu_window, dtype, chunk_size, limit_frames, limit_rate,
    profile_dir, simimu, sim,
    checkpoint_every: int = 0, checkpoint_path: str | None = None,
    resume_cursor: dict | None = None, live_port: int | None = None,
):
    """Chunked device loop: K frames per dispatch, outputs pulled once per
    chunk (replaces the reference's per-frame loop with a fused scan).

    Timing semantics (``--timing``): the per-frame sections
    features/propagation/preprocessing/correction are DEVICE times calibrated
    once per run by re-running one representative chunk stage-by-stage
    (:func:`_make_stage_runners`); "total vision update" is the measured
    fused-chunk device time per frame; "total" is wall time per frame
    including dispatch/transfer overhead; "write output" is host CSV time.
    """
    run_chunk = _make_chunk_runner(tcfg, settings, suite, camera, imu_window, dtype)
    C = chunk_size

    live = None
    if live_port is not None:
        from ..visualisation import LiveDisplayServer

        live = LiveDisplayServer(port=live_port)
        print(f"live map view: http://127.0.0.1:{live.port}/", flush=True)

    imu_buf: list[tuple[float, np.ndarray, np.ndarray]] = []
    initialised = False
    t_prev_host = -1.0
    n_frames = 0
    skip_imu_until = -np.inf
    skip_img_until = -np.inf
    if resume_cursor:
        initialised = True
        t_prev_host = float(resume_cursor["t_prev"])
        n_frames = int(resume_cursor["frames"])
        imu_buf = [
            (float(t), np.asarray(g, dtype=float), np.asarray(a, dtype=float))
            for t, g, a in resume_cursor.get("imu_buf", [])
        ]
        skip_imu_until = float(resume_cursor.get("last_imu_stamp", t_prev_host))
        skip_img_until = t_prev_host
    last_ckpt_frames = n_frames
    pend: list[tuple] = []  # (stamp, img, w_stamp, w_gyr, w_acc, w_dt, asm_time)
    t_begin = time.perf_counter()
    rate_mark = time.perf_counter()

    # wall decomposition accumulators: dispatch vs device vs host
    disp_s = 0.0  # async dispatch call, blocking portion
    up_s = 0.0  # host->device input transfer (jnp.asarray of imgs + meta)
    get_s = 0.0  # device->host output fetch (blocks on chunk completion)
    wr_s = 0.0  # host CSV writing
    iter_s = 0.0  # main thread blocked on the data server (decode wait)
    asm_s = 0.0  # per-frame IMU-window assembly + uint8 conversion
    pack_s = 0.0  # per-chunk numpy packing
    srch_frames = 0  # frames on which the detector cond-gate actually fired
    cost_flops = [0.0]  # XLA cost-analysis flops per frame (fused chunk)
    cost_bytes = [0.0]  # XLA cost-analysis HBM bytes per frame
    device_ms_per_frame = None  # fused-chunk device time, measured once
    calib = None  # per-frame device section times, calibrated once

    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    # Output fetch runs on a dedicated thread, which drains completed chunks
    # in FIFO order and writes the CSVs while the next chunk computes.
    import queue as _queue
    import threading

    fetchq: _queue.Queue = _queue.Queue()
    fetch_errors: list[Exception] = []

    def _consume(stamps, n, outs, t_disp, t_get):
        nonlocal n_frames, rate_mark, wr_s, srch_frames
        t_get0 = time.perf_counter()
        t_wr0 = time.perf_counter()
        searched_flags = []
        if writer is not None:
            N = (outs.shape[1] - 34) // 9  # invert _out_width: W = 34 + 9N
            for i in range(n):
                (pR, px, vel, cR, cx, bias, srch, lms, lids, lmask, fpx, fids, fvis) = \
                    _unpack_outputs(outs[i], N)
                searched_flags.append(bool(srch))
                srch_frames += bool(srch)
                writer.write_states(
                    stamps[i], pR, px, vel, cR, cx, bias,
                    landmarks=lms, landmark_ids=lids, landmark_mask=lmask,
                )
                writer.write_features(stamps[i], fpx, fids, fvis)
                if live is not None:
                    # the estimated camera offset ships in the output row
                    live.update(stamps[i], pR, px, cR, cx,
                                lms, lids.astype(np.int64), lmask > 0.5)
        t_wr = time.perf_counter() - t_wr0
        wr_s += t_wr
        if writer is not None and timing:
            for i in range(n):
                row = {lab: 0.0 for lab in TIMING_LABELS}
                if calib is not None:
                    srch = searched_flags[i] if i < len(searched_flags) else True
                    # per-frame device attribution: the detector cond-gate is
                    # the dominant per-frame variation (reference timing.csv
                    # shows it as the "features" bimodality)
                    row["features"] = (
                        calib["features_full"] if srch else calib["features_skip"]
                    )
                    row["propagation"] = calib["propagation"]
                    row["preprocessing"] = calib["preprocessing"]
                    row["correction"] = calib["correction"]
                    row["total vision update"] = (
                        calib["propagation"] + calib["preprocessing"] + calib["correction"]
                    )
                else:
                    row["total vision update"] = (t_disp + t_get) / n
                row["write output"] = t_wr / n
                row["total"] = (t_disp + t_get + t_wr) / n
                writer.write_timing(t_get0, row)
        n_frames += n
        if limit_rate and limit_rate > 0:
            sleep_for = rate_mark + n / limit_rate - time.perf_counter()
            if sleep_for > 0:
                time.sleep(sleep_for)
            rate_mark = time.perf_counter()

    def _fetch_worker():
        nonlocal get_s
        while True:
            item = fetchq.get()
            try:
                if item is not None:
                    outs, stamps_i, n_i, t_disp_i = item
                    t0 = time.perf_counter()
                    arr = np.asarray(jax.device_get(outs)) if writer is not None else None
                    t_get = time.perf_counter() - t0
                    get_s += t_get
                    _consume(stamps_i, n_i, arr, t_disp_i, t_get)
            except Exception as e:  # noqa: BLE001 — surfaced after join
                fetch_errors.append(e)
            finally:
                fetchq.task_done()
            if item is None:
                return

    fetcher = threading.Thread(target=_fetch_worker, daemon=True)
    fetcher.start()
    enqueued_frames = n_frames  # main-thread view; n_frames is the fetcher's tally

    def drain():
        fetchq.join()
        if fetch_errors:
            raise fetch_errors[0]

    def _measure_chunk(dev_inputs, host_arrays):
        """Measure fused-chunk device time (and optionally per-stage times)
        by re-running the already-compiled chunk program on state snapshots."""
        nonlocal device_ms_per_frame, calib
        state_h = jax.device_get(state)
        tracker_h = jax.device_get(tracker)

        def once():
            st = jax.device_put(state_h)
            trk = jax.device_put(tracker_h)
            jax.block_until_ready((st, trk))
            t0 = time.perf_counter()
            (s2, t2), o2 = run_chunk(st, trk, *dev_inputs)
            jax.block_until_ready(o2)
            return time.perf_counter() - t0

        once()  # ensures the program is compiled (shared with the real flush)
        device_ms_per_frame = min(once(), once()) * 1e3 / C

        # XLA cost analysis of the fused chunk (utilization denominators)
        try:
            ca = (
                run_chunk.lower(
                    jax.device_put(state_h), jax.device_put(tracker_h), *dev_inputs
                )
                .compile()
                .cost_analysis()
            )
            if ca:
                cost_flops[0] = float(ca.get("flops", 0.0)) / C
                cost_bytes[0] = float(ca.get("bytes accessed", 0.0)) / C
        except Exception:  # noqa: BLE001 — cost analysis is best-effort
            pass

        if not timing:
            return
        # stage-by-stage calibration: extra (subset) programs, compiled once
        (feat_scan, feat_full, feat_skip, prop_scan, pre_scan, corr_scan) = \
            _make_stage_runners(tcfg, settings, suite, camera, imu_window, dtype)
        imgs_np, stamps_w_np, gyr_np, acc_np, dts_np = host_arrays
        imgs_d = dev_inputs[0]
        stamps_w_d = jnp.asarray(stamps_w_np, dtype=dtype)
        gyr_d = jnp.asarray(gyr_np, dtype=dtype)
        acc_d = jnp.asarray(acc_np, dtype=dtype)
        dts_d = jnp.asarray(dts_np, dtype=dtype)

        def timed(fn, *a):
            jax.block_until_ready(fn(*a))  # compile
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                out = fn(*a)
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - t0)
            return best, out

        trk0 = jax.device_put(tracker_h)
        t_feat, (_, (pix_seq, vis_seq, ids_seq)) = timed(feat_scan, trk0, imgs_d)
        t_full, _ = timed(feat_full, jax.device_put(tracker_h), imgs_d)
        t_skip, _ = timed(feat_skip, jax.device_put(tracker_h), imgs_d)
        st0 = jax.device_put(state_h)
        t_prop, _ = timed(prop_scan, st0, stamps_w_d, gyr_d, acc_d, dts_d)
        t_pre, _ = timed(
            pre_scan, st0, stamps_w_d, gyr_d, acc_d, dts_d, pix_seq, vis_seq, ids_seq
        )
        t_corr, _ = timed(
            corr_scan, st0, stamps_w_d, gyr_d, acc_d, dts_d, pix_seq, vis_seq, ids_seq
        )
        calib = {
            "features": t_feat / C,
            "features_full": t_full / C,
            "features_skip": t_skip / C,
            "propagation": t_prop / C,
            "preprocessing": max(t_pre - t_prop, 0.0) / C,
            "correction": max(t_corr - t_pre, 0.0) / C,
        }

    def _save_ckpt():
        from ..checkpoint import save_checkpoint

        cursor = {
            "t_prev": t_prev_host,
            "frames": n_frames,
            "imu_buf": [[t, list(map(float, g)), list(map(float, a))]
                        for t, g, a in imu_buf],
            "last_imu_stamp": imu_buf[-1][0] if imu_buf else t_prev_host,
        }
        save_checkpoint(checkpoint_path, state, tracker, cursor)

    def flush():
        nonlocal state, tracker, disp_s, up_s, pack_s, asm_s, enqueued_frames, steady_mark
        if not pend:
            return
        n = len(pend)
        K = imu_window
        t_pk0 = time.perf_counter()
        img0 = pend[0][1]
        imgs = np.zeros((C,) + img0.shape, dtype=np.uint8)
        stamps_w = np.zeros((C, K))
        gyr_w = np.zeros((C, K, 3))
        acc_w = np.zeros((C, K, 3))
        dts = np.zeros((C, K))
        stamps = np.zeros(C)
        meta = np.zeros((C, _meta_width(K)))
        for i, (st, im, ws, wg, wa, wd, t_asm) in enumerate(pend):
            imgs[i] = im
            stamps_w[i] = ws
            gyr_w[i] = wg
            acc_w[i] = wa
            dts[i] = wd
            stamps[i] = st
            meta[i, :K] = ws
            meta[i, K:4 * K] = wg.reshape(-1)
            meta[i, 4 * K:7 * K] = wa.reshape(-1)
            meta[i, 7 * K:8 * K] = wd
            meta[i, 8 * K] = st
            meta[i, 8 * K + 1] = 1.0
            asm_s += t_asm
        pack_s += time.perf_counter() - t_pk0
        t_up0 = time.perf_counter()
        dev_inputs = (jnp.asarray(imgs), jnp.asarray(meta, dtype=dtype))
        up_s += time.perf_counter() - t_up0
        if n == C and device_ms_per_frame is None:
            _measure_chunk(dev_inputs, (imgs, stamps_w, gyr_w, acc_w, dts))
        t_disp0 = time.perf_counter()
        (state, tracker), outs = run_chunk(state, tracker, *dev_inputs)
        t_disp = time.perf_counter() - t_disp0
        disp_s += t_disp
        pend.clear()
        enqueued_frames += n
        if writer is not None:
            outs.copy_to_host_async()
        fetchq.put((outs, stamps.copy(), n, t_disp))
        if steady_mark is None:
            # the first chunk carries tracing, compilation and the device-time
            # measurement: the steady rate is taken over the chunks after it
            steady_mark = (time.perf_counter(), enqueued_frames)

    steady_mark = None  # (time, frames enqueued) once the first chunk is out
    _it = iter(server)
    while True:
        t_it0 = time.perf_counter()
        meas = next(_it, None)
        iter_s += time.perf_counter() - t_it0
        if meas is None:
            break
        if meas.kind == "imu":
            if meas.stamp <= skip_imu_until:
                continue
            gyr, acc = meas.data
            if simimu:
                sim_imu = sim.get_imu(jnp.asarray(meas.stamp, dtype=dtype))
                gyr = np.asarray(sim_imu.gyr)
                acc = np.asarray(sim_imu.acc)
            if not initialised:
                state = F.initialize_attitude_from_imu(
                    state,
                    IMU.create(
                        jnp.asarray(meas.stamp, dtype=dtype),
                        jnp.asarray(gyr, dtype=dtype),
                        jnp.asarray(acc, dtype=dtype),
                    ),
                )
                initialised = True
                t_prev_host = meas.stamp
            imu_buf.append((meas.stamp, gyr, acc))
            continue
        if not initialised:
            continue
        if meas.stamp <= skip_img_until:
            continue
        t_asm0 = time.perf_counter()
        (ws, wg, wa, wd), imu_buf = _build_imu_window(
            imu_buf, t_prev_host, meas.stamp, imu_window
        )
        t_prev_host = meas.stamp
        im = np.asarray(meas.data)
        if im.dtype != np.uint8:
            # round, don't truncate: decoded f32 pixels are k/255 +- eps;
            # clip so out-of-range floats can't wrap modulo 256 on the cast
            im = np.clip(im * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        pend.append(
            (
                meas.stamp,
                im,
                ws, wg, wa, wd,
                time.perf_counter() - t_asm0,
            )
        )
        if len(pend) == C:
            flush()
            if checkpoint_every and checkpoint_path and (
                enqueued_frames - last_ckpt_frames >= checkpoint_every
            ):
                drain()  # the CSVs must cover every saved frame
                _save_ckpt()
                last_ckpt_frames = enqueued_frames
        if limit_frames and enqueued_frames + len(pend) >= limit_frames:
            break
    flush()
    drain()
    fetchq.put(None)
    fetchq.join()

    t_end = time.perf_counter()
    elapsed = t_end - t_begin
    if profile_dir:
        jax.profiler.stop_trace()
    if writer is not None:
        writer.flush()
    est = F.state_estimate(state)
    health = {k: bool(v) for k, v in F.health_check(state, settings).items()}
    done_frames = n_frames - (int(resume_cursor["frames"]) if resume_cursor else 0)
    summary = {
        "frames": n_frames,  # total incl. pre-resume frames
        "fps": done_frames / max(elapsed, 1e-9),
        "final_position": np.asarray(est.sensor.pose.x).tolist(),
        "landmarks": int(np.asarray(est.mask).sum()),
        "nan": health["nan"],
        "healthy": health["nan"] is False and health["scales_valid"],
        "dispatch_ms_per_frame": round((disp_s + up_s) * 1e3 / max(done_frames, 1), 3),
        "fetch_ms_per_frame": round(get_s * 1e3 / max(done_frames, 1), 3),
        "write_ms_per_frame": round(wr_s * 1e3 / max(done_frames, 1), 3),
        # host-side wall decomposition of the main thread
        "host_ms_per_frame": {
            "iter_wait": round(iter_s * 1e3 / max(done_frames, 1), 3),
            "imu_window_asm": round(asm_s * 1e3 / max(done_frames, 1), 3),
            "chunk_pack": round(pack_s * 1e3 / max(done_frames, 1), 3),
            "upload": round(up_s * 1e3 / max(done_frames, 1), 3),
            "dispatch": round(disp_s * 1e3 / max(done_frames, 1), 3),
        },
    }
    if steady_mark is not None and n_frames > steady_mark[1]:
        # wall rate after the first chunk, and the time until it was out
        summary["setup_s"] = round(steady_mark[0] - t_begin, 3)
        summary["steady_fps"] = (n_frames - steady_mark[1]) / max(t_end - steady_mark[0], 1e-9)
    if writer is not None:
        # fraction of frames on which the featureSearchThreshold cond-gate ran
        # the corner detector (flags are only unpacked when outputs are
        # fetched, i.e. with a writer)
        summary["searched_frame_fraction"] = round(srch_frames / max(done_frames, 1), 3)
    if device_ms_per_frame is not None:
        summary["device_ms_per_frame"] = round(device_ms_per_frame, 3)
        if cost_flops[0] > 0:
            # achieved rates vs the XLA-estimated work of the fused program
            summary["flops_per_frame"] = cost_flops[0]
            summary["hbm_bytes_per_frame"] = cost_bytes[0]
            summary["achieved_gflops"] = round(
                cost_flops[0] / (device_ms_per_frame * 1e6), 2
            )
            summary["achieved_hbm_gbps"] = round(
                cost_bytes[0] / (device_ms_per_frame * 1e6), 2
            )
    if calib is not None:
        summary["device_sections_ms"] = {
            k: round(v * 1e3, 3) for k, v in calib.items()
        }
    if live is not None:
        live.close()
    return state, summary


def collect_fused_inputs(dataset_dir, config, limit_frames, mode="asl",
                         dtype=jnp.float32):
    """Replay the data-server loop on the host ONCE, returning the fused
    pipeline's exact per-frame device inputs (uint8 images + packed meta) and
    the attitude-initialised filter/tracker states.  Feeds the batched
    throughput bench so its frames are device-resident (the 2-vCPU host and
    host decode and upload are excluded from the measurement)."""
    (reader, settings, tcfg, camera, capacity, state, tracker, suite,
     imu_window) = _setup_from_config(dataset_dir, config, mode, dtype=dtype)
    K = imu_window
    server = DataServer(reader)
    imu_buf: list = []
    initialised = False
    t_prev = -1.0
    imgs, metas = [], []
    for meas in server:
        if meas.kind == "imu":
            gyr, acc = meas.data
            if not initialised:
                state = F.initialize_attitude_from_imu(
                    state,
                    IMU.create(
                        jnp.asarray(meas.stamp, dtype=dtype),
                        jnp.asarray(gyr, dtype=dtype),
                        jnp.asarray(acc, dtype=dtype),
                    ),
                )
                initialised = True
                t_prev = meas.stamp
            imu_buf.append((meas.stamp, gyr, acc))
            continue
        if not initialised:
            continue
        (ws, wg, wa, wd), imu_buf = _build_imu_window(
            imu_buf, t_prev, meas.stamp, K
        )
        t_prev = meas.stamp
        im = np.asarray(meas.data)
        if im.dtype != np.uint8:
            im = np.clip(im * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        row = np.zeros(_meta_width(K))
        row[:K] = ws
        row[K:4 * K] = wg.reshape(-1)
        row[4 * K:7 * K] = wa.reshape(-1)
        row[7 * K:8 * K] = wd
        row[8 * K] = meas.stamp
        row[8 * K + 1] = 1.0
        imgs.append(im)
        metas.append(row)
        if len(imgs) >= limit_frames:
            break
    return (np.stack(imgs), np.stack(metas), state, tracker,
            settings, tcfg, camera, suite, K)


def bench_batch_full_frame(dataset_dir, config, batch, dtype=jnp.float32,
                           limit_frames=240, chunk_size=32, noise_seed=7,
                           reps=3):
    """Tracker-INCLUSIVE aggregate throughput: B concurrent full pipelines
    (KLT tracker + EqF filter) vmapped in one device program over
    device-resident frames.

    Each sequence instance gets independent uint8 pixel noise, so tracking,
    lifecycle and filter work genuinely diverge per instance — this is B real
    pipelines, not one pipeline broadcast.  The reference runs sequences
    serially on a CPU (``run_and_analyse_dataset.py:46-49``); this measures
    how many it runs at once on one chip.  Returns a dict of aggregate fps,
    per-sequence fps, and health.
    """
    T0 = limit_frames - (limit_frames % chunk_size)
    imgs_np, meta_np, state, tracker, settings, tcfg, camera, suite, K = \
        collect_fused_inputs(dataset_dir, config, T0, dtype=dtype)
    T = imgs_np.shape[0] - (imgs_np.shape[0] % chunk_size)
    imgs_np, meta_np = imgs_np[:T], meta_np[:T]

    rng = np.random.default_rng(noise_seed)
    imgs_b = np.stack([
        np.clip(
            imgs_np.astype(np.int16) + rng.integers(-3, 4, imgs_np.shape, dtype=np.int16),
            0, 255,
        ).astype(np.uint8)
        for _ in range(batch)
    ])  # [B, T, H, W]
    meta_b = np.broadcast_to(meta_np[None], (batch,) + meta_np.shape)

    run_chunk_b = _make_batch_chunk_runner(tcfg, settings, suite, camera, K, dtype)
    state_h = jax.device_get(state)
    tracker_h = jax.device_get(tracker)

    def rep_states():
        sb = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a, dtype=a.dtype)[None],
                                       (batch,) + a.shape).copy(), state_h)
        tb = jax.tree.map(
            lambda a: jnp.broadcast_to(jnp.asarray(a)[None],
                                       (batch,) + a.shape).copy(), tracker_h)
        return sb, tb

    # upload once, pre-split per chunk (slices on host; device arrays resident)
    img_chunks = [
        jax.device_put(imgs_b[:, c:c + chunk_size]) for c in range(0, T, chunk_size)
    ]
    meta_chunks = [
        jax.device_put(np.ascontiguousarray(meta_b[:, c:c + chunk_size]).astype(
            np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32))
        for c in range(0, T, chunk_size)
    ]

    def one_pass():
        sb, tb = rep_states()
        outs = None
        for ic, mc in zip(img_chunks, meta_chunks):
            (sb, tb), outs = run_chunk_b(sb, tb, ic, mc)
        jax.block_until_ready(outs)
        return outs

    outs = one_pass()  # compile + warm
    finite = bool(np.isfinite(np.asarray(outs[:, -1, :21])).all())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        one_pass()
        best = min(best, time.perf_counter() - t0)

    result = {
        "full_frame_batch_fps": round(batch * T / best, 1),
        "full_frame_batch_per_seq_fps": round(T / best, 1),
        "full_frame_batch_B": batch,
        "full_frame_batch_frames": T,
        "full_frame_batch_finite": finite,
    }
    try:
        ca = run_chunk_b.lower(
            *rep_states(), img_chunks[0], meta_chunks[0]
        ).compile().cost_analysis()
        if ca and ca.get("flops"):
            n_chunks = T // chunk_size
            result["full_frame_batch_gflops_per_s"] = round(
                float(ca["flops"]) * n_chunks / best / 1e9, 2
            )
    except Exception:  # noqa: BLE001 — cost analysis is best-effort
        pass
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="EqVIO on a real dataset")
    ap.add_argument("dataset")
    ap.add_argument("config")
    ap.add_argument("--mode", default="asl")
    ap.add_argument("--output", default=None)
    ap.add_argument("--camera", default=None)
    ap.add_argument("--start", type=float, default=None)
    ap.add_argument("--stop", type=float, default=None)
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--simvis", action="store_true",
                    help="replace vision with simulated measurements around ground truth")
    ap.add_argument("--simimu", action="store_true",
                    help="replace IMU with simulated measurements around ground truth")
    ap.add_argument("--limitRate", type=float, default=0.0, dest="limit_rate",
                    help="maximum image processing rate in Hz (0 = unlimited)")
    ap.add_argument("--profile", default=None,
                    help="write an XLA profiler trace to this directory")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per fused device dispatch (1 = per-frame loop)")
    ap.add_argument("--f64", action="store_true",
                    help="f64 filter math on every backend (accuracy validation; "
                         "the image front end stays f32)")
    ap.add_argument("--checkpointEvery", type=int, default=0, dest="checkpoint_every",
                    help="save a resumable checkpoint every ~N frames "
                         "(to --checkpointPath or <output>/checkpoint.npz)")
    ap.add_argument("--checkpointPath", default=None, dest="checkpoint_path")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint.npz written by --checkpointEvery")
    ap.add_argument("--display", action="store_true", help="accepted for parity; no GUI")
    ap.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve a live map view at http://127.0.0.1:PORT/ "
                         "(the reference --display equivalent for headless "
                         "hosts; needs --output)")
    args = ap.parse_args(argv)

    from ._env import configure_runtime

    dtype = configure_runtime(force_x64=args.f64)

    config = load_config(args.config)
    # config main: section supplies defaults the CLI can override
    main_cfg = config.get("main", {}) or {}
    if args.start is None and float(main_cfg.get("startTime", 0.0)) > 0:
        args.start = float(main_cfg["startTime"])
    if not args.limit_rate and float(main_cfg.get("limitRate", 0.0)) > 0:
        args.limit_rate = float(main_cfg["limitRate"])
    _, summary = run_dataset(
        args.dataset,
        config,
        mode=args.mode,
        output_dir=args.output,
        start=args.start,
        stop=args.stop,
        camera_yaml=args.camera,
        timing=args.timing,
        simvis=args.simvis,
        simimu=args.simimu,
        limit_rate=args.limit_rate,
        profile_dir=args.profile,
        dtype=dtype,
        chunk_size=args.chunk,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=args.checkpoint_path,
        resume=args.resume,
        live_port=args.live,
    )
    status = "OK" if summary.get("healthy") else "UNHEALTHY (NaN/scale)"
    print(f"Processed {summary['frames']} frames at {summary['fps']:.1f} fps; "
          f"{summary['landmarks']} landmarks live; filter {status}.")
    return summary


if __name__ == "__main__":
    main()
