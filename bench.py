"""Benchmark: single-sequence FULL-FRAME throughput (tracker + filter) on one GPU.

Prints ONE JSON line:
``{"metric", "value", "unit", "value_spread", "healthy", "device", "card",
"secondary"}``

Headline metric: frames/s of the real-data pipeline on a hermetic EuRoC-scale
sequence (752x480 frames, 200 Hz IMU, 20 Hz vision, 30 features) — dataset
reader + prefetch decode + fused KLT-tracker+EqF device chunks + CSV writer,
i.e. the same workload the reference times per frame (``main_opt.cpp:120-121``:
"features" + "total vision update" + "write output").

Secondary fields:
- ``filter_only_fps``: the jitted sim pipeline (vision precomputed) — the
  reference's filter-side cost, no tracker.
- ``sim_batch_aggregate_fps``: BENCH_BATCH concurrent filter instances vmapped
  in one program (the reference runs sequences serially,
  run_and_analyse_dataset.py:46-49); per-card multi-sequence throughput.
- ``full_frame_batch_*``: BENCH_FF_BATCH tracker-inclusive pipelines vmapped
  in one program over device-resident frames.

The reference commits no timing numbers (BASELINE.md), so there is no
baseline ratio; runs are compared through the ledger. The bench needs a GPU
and fails without one.
"""

import json
import os
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DATASET = os.path.join(HERE, ".data", "bench_asl")
BENCH_SECONDS = 30.0

# Published peaks per device_kind: (f32 FLOP/s outside the tensor cores — the
# precision the filter runs at — and device-memory bytes/s).  Source: NVIDIA
# H100 data sheet, SXM part (67 TFLOP/s FP32, 3.35 TB/s HBM3), at the full
# 700 W power limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def chip_peaks(kind: str):
    """(peak f32 FLOP/s, peak bytes/s) of ``device_kind``; raises for a
    device not in the table."""
    if kind not in CHIP_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return CHIP_PEAKS[kind]


def _utilization(flops_per_s, bytes_per_s, kind):
    """(f32 FLOP share %, memory-bandwidth share %) of the published peaks."""
    peak_f, peak_b = chip_peaks(kind)
    return 100.0 * flops_per_s / peak_f, 100.0 * bytes_per_s / peak_b


def _ensure_dataset():
    """Generate (once) a hermetic EuRoC-scale ASL tree for the bench."""
    marker = os.path.join(BENCH_DATASET, ".complete_v3")
    if os.path.exists(marker):
        return
    import shutil

    import jax

    from eqvio_tpu.data import generate_asl_dataset

    shutil.rmtree(BENCH_DATASET, ignore_errors=True)
    # thousands of tiny per-frame ops: cheaper on the host than on the card
    with jax.default_device(jax.devices("cpu")[0]):
        generate_asl_dataset(
            BENCH_DATASET,
            end_time=BENCH_SECONDS,
            imu_freq=200.0,
            frame_freq=20.0,
            width=752,
            height=480,
            num_points=600,
            seed=4,
            kind="room",  # stationary start: the filter self-init assumes rest
        )
    with open(marker, "w") as f:
        f.write("ok\n")


def _bench_config():
    """Template config with the algorithm switches of the reference's SHIPPED
    EuRoC config (EQVIO_config_EuRoC_stationary.yaml:43-51) rather than the
    template defaults: fastRiccati engages the mean-IMU single Riccati step
    (and with it the one-QR frame fusion)."""
    from eqvio_tpu.io import load_config

    cfg = load_config(os.path.join(HERE, "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 30
    cfg["GIFT"]["winSize"] = 21
    cfg["eqf"]["initialValue"]["sceneDepth"] = 4.3  # measured bench-scene start median depth
    cfg["eqf"]["settings"] = {
        **(cfg["eqf"].get("settings") or {}),
        "fastRiccati": True,
        "coordinateChoice": "InvDepth",
        "useDiscreteInnovationLift": False,
        "useMedianDepth": False,
    }
    return cfg


def bench_full_frame(dtype, kind):
    """Single-sequence full-frame fps: reader -> prefetch -> fused
    tracker+filter chunks -> writer, exactly the ``run_opt`` product path.

    Returns ``(fps, healthy, decomposition)`` where decomposition carries the
    dispatch-vs-device split per frame."""
    import tempfile

    from eqvio_tpu.app.run_opt import run_dataset

    _ensure_dataset()
    cfg = _bench_config()
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))

    def once():
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            _, summary = run_dataset(
                BENCH_DATASET, cfg, output_dir=out, dtype=dtype, chunk_size=chunk
            )
            return summary, time.perf_counter() - t0

    once()  # warm-up / compile
    # median-of-N with spread: a single best-of run hides run-to-run variance
    reps = max(3, int(os.environ.get("BENCH_REPS", "5")))
    times, steady, summary = [], [], {}
    for _ in range(reps):
        summary, dt = once()
        times.append(dt)
        steady.append(summary.get("steady_fps", float("nan")))
    n_frames = max(summary["frames"], 1)
    fps_reps = sorted(n_frames / t for t in times)
    best = min(times)
    decomp = {
        "chunk_size": chunk,
        "fps_reps": [round(v, 1) for v in fps_reps],
        # wall rate after each run's first chunk (tracing, compile-cache
        # load and the device-time measurement excluded)
        "steady_fps_reps": sorted(round(v, 1) for v in steady),
        "setup_s": summary.get("setup_s"),
        "device_ms_per_frame": summary.get("device_ms_per_frame"),
        "dispatch_ms_per_frame": summary.get("dispatch_ms_per_frame"),
        "fetch_ms_per_frame": summary.get("fetch_ms_per_frame"),
        "write_ms_per_frame": summary.get("write_ms_per_frame"),
        "wall_ms_per_frame": round(best * 1e3 / max(summary["frames"], 1), 3),
        "searched_frame_fraction": summary.get("searched_frame_fraction"),
        "host_ms_per_frame": summary.get("host_ms_per_frame"),
    }
    # peak shares of the fused chunk program (XLA cost analysis / device time)
    if summary.get("achieved_gflops"):
        dev_s = summary["device_ms_per_frame"] * 1e-3
        flops_pct, bw_pct = _utilization(
            summary["flops_per_frame"] / dev_s, summary["hbm_bytes_per_frame"] / dev_s, kind
        )
        decomp["fused_achieved_gflops"] = summary["achieved_gflops"]
        decomp["fused_achieved_hbm_gbps"] = summary["achieved_hbm_gbps"]
        decomp["fused_f32_peak_pct"] = round(flops_pct, 4)
        decomp["fused_hbm_peak_pct"] = round(bw_pct, 4)
    fps_median = float(np.median(fps_reps))
    decomp["fps_median"] = round(fps_median, 1)
    decomp["fps_best"] = round(n_frames / best, 1)
    return fps_median, bool(summary.get("healthy", False)), decomp


def bench_filter_only(kind):
    """Filter-only fps of the jitted sim pipeline and the vmapped fleet
    aggregate, with the algorithm switches of the reference's shipped EuRoC
    config (InvDepth + fastRiccati + continuous innovation lift)."""
    import jax
    import jax.numpy as jnp

    from eqvio_tpu import filter as F
    from eqvio_tpu.runner import build_sim_runner, prepare_sim_inputs

    out = {}
    settings = F.Settings(
        measurement_noise=0.5,
        coordinate_choice="invdepth",
        fast_riccati=True,
        use_discrete_innovation_lift=False,
        use_median_depth=False,
        initial_scene_depth=2.5,
    )
    inputs = prepare_sim_inputs(
        settings, capacity=32, max_features=30, end_time=30.0, imu_freq=200.0,
        frame_freq=20.0, num_walls=4, dtype=jnp.float32,
    )
    run = build_sim_runner(settings, inputs, augment_true_landmarks=False, compute_nees=False)
    res = run()
    jax.block_until_ready(res.est_position)
    n_frames = int(res.times.shape[0])
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        res = run()
        jax.block_until_ready(res.est_position)
        best = min(best, time.perf_counter() - t0)
    out["filter_only_fps"] = round(n_frames / best, 1)
    out["filter_only_finite"] = bool(np.isfinite(np.asarray(res.est_position)).all())

    B = int(os.environ.get("BENCH_BATCH", "128"))
    if B > 1:
        run_b = build_sim_runner(
            settings, inputs, augment_true_landmarks=False, compute_nees=False, batch=B,
        )
        res_b = run_b()
        jax.block_until_ready(res_b.est_position)
        best_b = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res_b = run_b()
            jax.block_until_ready(res_b.est_position)
            best_b = min(best_b, time.perf_counter() - t0)
        out["sim_batch_aggregate_fps"] = round(B * n_frames / best_b, 1)
        out["sim_batch_finite"] = bool(np.isfinite(np.asarray(res_b.est_position)).all())
        ca = run_b.cost_analysis()
        if ca and ca.get("flops"):
            flops_s = float(ca["flops"]) / best_b
            bytes_s = float(ca.get("bytes accessed", 0.0)) / best_b
            flops_pct, bw_pct = _utilization(flops_s, bytes_s, kind)
            out["batch_achieved_gflops"] = round(flops_s / 1e9, 2)
            out["batch_achieved_hbm_gbps"] = round(bytes_s / 1e9, 2)
            out["batch_f32_peak_pct"] = round(flops_pct, 4)
            out["batch_hbm_peak_pct"] = round(bw_pct, 4)
    return out


def main():
    import jax
    import jax.numpy as jnp

    from eqvio_tpu.app._env import configure_runtime, gpu_name_and_power_limit, require_gpu

    configure_runtime()
    dev = require_gpu()
    kind = dev.device_kind
    chip_peaks(kind)  # an unknown card fails before any work
    # BENCH_DTYPE=f64 runs the reference-parity numerics (C++ double)
    dtype = jnp.float64 if os.environ.get("BENCH_DTYPE") == "f64" else jnp.float32

    full_frame_fps, healthy, secondary = bench_full_frame(dtype, kind)

    B_ff = int(os.environ.get("BENCH_FF_BATCH", "8"))
    if B_ff > 1:
        from eqvio_tpu.app.run_opt import bench_batch_full_frame

        secondary.update(bench_batch_full_frame(
            BENCH_DATASET, _bench_config(), B_ff, dtype=dtype,
            limit_frames=int(os.environ.get("BENCH_FF_FRAMES", "224")),
            chunk_size=int(os.environ.get("BENCH_FF_CHUNK", "32")),
        ))
        healthy = healthy and secondary["full_frame_batch_finite"]

    secondary.update(bench_filter_only(kind))
    healthy = healthy and secondary["filter_only_finite"] and secondary.get(
        "sim_batch_finite", True)

    out = {
        "metric": "full_frame_fps_single_seq",
        "value": round(full_frame_fps, 1),  # MEDIAN of BENCH_REPS timed runs
        "unit": "frames/s",
        "value_spread": {
            "min": secondary["fps_reps"][0],
            "max": secondary["fps_reps"][-1],
            "reps": len(secondary["fps_reps"]),
        },
        "healthy": healthy,
        "device": {"platform": dev.platform, "kind": kind, "count": len(jax.devices())},
        "card": gpu_name_and_power_limit(),
        "secondary": secondary,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
