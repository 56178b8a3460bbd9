"""Smoke test of the EqVIO main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below, in order
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one card):

1. device   -- JAX's first device must be a GPU; prints its kind, the card's
               name and power limit, the compile cache and host codecs in use;
2. main     -- a 300-frame EuRoC-scale sequence (752x480, 20 Hz camera,
               200 Hz IMU) through ``eqvio_tpu.app.run_opt.main`` with
               ``configs/config_EuRoC.yaml``: health, frames, NaN, tracked
               features and ATE against ground truth;
3. reference -- the first 100 frames again on the CPU backend with the f64
               dense filter and the gather tracker; per-frame positions must
               agree with the GPU run;
4. sim      -- ``eqvio_tpu.app.run_sim.main``: position RMSE under 1 cm.

Everything runs in this one process: JAX reserves most of the card's memory
when it starts, so a second process could not open the card. Any failure
exits non-zero before the last line, which is the JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_ROOT = os.path.join(REPO, ".data", "chip_smoke")
EUROC_CONFIG = os.path.join(REPO, "configs", "config_EuRoC.yaml")

# the bench's EuRoC-scale sequence, 15 s long (300 frames at 20 Hz)
SEQUENCE = dict(end_time=15.225, imu_freq=200.0, frame_freq=20.0, width=752,
                height=480, num_points=600, seed=4, kind="room")
REFERENCE_FRAMES = 100
# config_EuRoC's 79.8 px detector NMS radius admits about 16 tracks per frame
# on this scene, on the CPU reference and the GPU alike (PERF.md, section 5)
MIN_MEAN_TRACKED = 12.0
ATE_BOUND_M = 0.02  # 5x the first GPU reading (3.6 mm, CHANGES.md)
REF_FLOOR_M = 0.005
SIM_RMSE_BOUND_M = 0.01


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


# --------------------------------------------------------------------------
# device


def phase_device():
    import jax

    from eqvio_tpu.app._env import compile_cache_dir, gpu_name_and_power_limit, require_gpu
    from eqvio_tpu.data import native_loader
    from eqvio_tpu.io import native

    dev = require_gpu()
    say("device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()), jax=jax.__version__)
    print(f"[device] nvidia-smi: {gpu_name_and_power_limit()}", flush=True)
    say("device", compile_cache=compile_cache_dir(),
        png_decoder="native" if native_loader.available() else "python",
        csv_writer="native" if native.available() else "python")
    return dev


# --------------------------------------------------------------------------
# data


def ensure_sequence(root: str = DATA_ROOT, **overrides) -> str:
    """Generate (once per parameter set) the hermetic ASL sequence."""
    from eqvio_tpu.data import generate_asl_dataset

    params = {**SEQUENCE, **overrides}
    tag = "_".join(f"{k}{params[k]}" for k in sorted(params))
    path = os.path.join(root, tag)
    marker = os.path.join(path, ".complete")
    if not os.path.exists(marker):
        import jax

        shutil.rmtree(path, ignore_errors=True)
        # thousands of tiny per-frame ops: cheaper on the host than launched
        # one by one on a card
        with jax.default_device(jax.devices("cpu")[0]):
            generate_asl_dataset(path, **params)
        with open(marker, "w") as f:
            f.write("ok\n")
    return path


# --------------------------------------------------------------------------
# main path


def load_positions(out_dir: str):
    data = np.genfromtxt(os.path.join(out_dir, "IMUState.csv"), delimiter=",",
                         skip_header=1, ndmin=2)
    return data[:, 0], data[:, 1:4]


def tracked_counts(out_dir: str, frames: int | None = None) -> np.ndarray:
    """Features per row of ``features.csv`` (first ``frames`` rows when
    given)."""
    counts = []
    with open(os.path.join(out_dir, "features.csv")) as f:
        next(f)
        for line in f:
            fields = [x for x in line.strip().split(",") if x.strip()]
            counts.append((len(fields) - 1) // 3)
    return np.asarray(counts[:frames], dtype=float)


def mean_tracked(out_dir: str, frames: int | None = None) -> float:
    counts = tracked_counts(out_dir, frames)
    return float(counts.mean()) if counts.size else 0.0


def phase_main(dataset: str, out_dir: str, frames: int, chunk: int = 16):
    """Run the dataset through ``run_opt.main`` twice (cold, then with the
    compile cache warm) and check the second run's outputs."""
    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app import run_opt

    argv = [dataset, EUROC_CONFIG, "--output", out_dir, "--chunk", str(chunk)]
    t0 = time.perf_counter()
    cold_summary = run_opt.main(argv)
    cold = time.perf_counter() - t0
    shutil.rmtree(out_dir)
    t0 = time.perf_counter()
    summary = run_opt.main(argv)
    warm = time.perf_counter() - t0
    stamps, pos = load_positions(out_dir)
    counts = tracked_counts(out_dir)
    tracked = float(counts.mean()) if counts.size else 0.0
    res = analyse_output_dir(
        out_dir, os.path.join(dataset, "mav0", "state_groundtruth_estimate0", "data.csv")
    )
    ate = float(res["position (m)"]["rmse"])
    say("main", frames=summary["frames"], rows=len(stamps), healthy=summary["healthy"],
        mean_tracked=f"{tracked:.2f}", ate_m=f"{ate:.5f}", ate_bound_m=ATE_BOUND_M)
    if counts.size:
        thirds = [f"{part.mean():.2f}" for part in np.array_split(counts, 3)]
        say("main", tracked_min_p10_p50_p90_max=",".join(
            f"{q:g}" for q in np.percentile(counts, [0, 10, 50, 90, 100])),
            tracked_mean_by_third=",".join(thirds))
    say("main", cold_setup_s=cold_summary.get("setup_s"), warm_setup_s=summary.get("setup_s"),
        cold_run_s=f"{cold:.3f}", warm_run_s=f"{warm:.3f}",
        steady_fps=f"{summary.get('steady_fps', float('nan')):.2f}",
        device_ms_per_frame=summary.get("device_ms_per_frame"))
    say("main", dispatch_ms_per_frame=summary["dispatch_ms_per_frame"],
        fetch_ms_per_frame=summary["fetch_ms_per_frame"],
        write_ms_per_frame=summary["write_ms_per_frame"],
        host_ms_per_frame=json.dumps(summary["host_ms_per_frame"], separators=(",", ":")))
    check(summary["healthy"], "main: filter unhealthy")
    check(summary["frames"] == frames and len(stamps) == frames,
          f"main: {summary['frames']} frames processed, {len(stamps)} written, want {frames}")
    check(np.isfinite(pos).all(), "main: NaN in the trajectory")
    check(tracked > MIN_MEAN_TRACKED, f"main: mean tracked {tracked:.2f} <= {MIN_MEAN_TRACKED}")
    check(ate < ATE_BOUND_M, f"main: ATE {ate:.4f} m >= {ATE_BOUND_M}")
    return summary


# --------------------------------------------------------------------------
# plain reference


def run_reference(dataset: str, out_dir: str, frames: int, dtype_name: str = "float64"):
    """The first ``frames`` frames on the CPU backend: f64 dense filter (or
    f32 with the square-root covariance) and the gather tracker."""
    import jax
    import jax.numpy as jnp

    from eqvio_tpu.app._env import configure_runtime
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.io import load_config

    configure_runtime()
    with jax.default_device(jax.devices("cpu")[0]):
        _, summary = run_dataset(dataset, load_config(EUROC_CONFIG), output_dir=out_dir,
                                 dtype=getattr(jnp, dtype_name), limit_frames=frames)
    return summary


def max_position_gap(out_a: str, out_b: str, frames: int) -> float:
    """Largest per-frame position difference (m) over the first ``frames``
    frames of two runs, matched by stamp."""
    ta, pa = load_positions(out_a)
    tb, pb = load_positions(out_b)
    check(len(ta) >= frames and len(tb) >= frames,
          f"reference: {len(ta)} and {len(tb)} rows, want {frames}")
    check(np.allclose(ta[:frames], tb[:frames]), "reference: frame stamps differ")
    return float(np.abs(pa[:frames] - pb[:frames]).max())


def phase_reference(dataset: str, gpu_out: str, ref_out: str, frames: int, d_cpu: float):
    t0 = time.perf_counter()
    run_reference(dataset, ref_out, frames)
    gap = max_position_gap(gpu_out, ref_out, frames)
    tol = max(2.0 * d_cpu, REF_FLOOR_M)
    say("reference", frames=frames, cpu_f64_s=f"{time.perf_counter() - t0:.3f}",
        max_dpos_m=f"{gap:.6f}", tol_m=f"{tol:.6f}", d_cpu_m=d_cpu,
        mean_tracked_gpu=f"{mean_tracked(gpu_out, frames):.2f}",
        mean_tracked_cpu=f"{mean_tracked(ref_out, frames):.2f}")
    check(gap <= tol, f"reference: GPU vs CPU f64 gap {gap:.5f} m > {tol:.5f} m")
    return gap


# --------------------------------------------------------------------------
# simulation entry


def phase_sim(out_dir: str, seconds: float = 10.0, extra=()):
    from eqvio_tpu.app import run_sim

    res = run_sim.main(["--time", str(seconds), "--consistency", "--output", out_dir, *extra])
    say("sim", frames=res["frames"], rmse_m=f"{res['rmse']:.5f}", bound_m=SIM_RMSE_BOUND_M)
    check(res["rmse"] < SIM_RMSE_BOUND_M, f"sim: RMSE {res['rmse']:.4f} m")
    return res


# --------------------------------------------------------------------------
# four cards


def _device_spread(arrays, n_devices: int):
    import jax

    for a in arrays:
        check(len(a.sharding.device_set) == n_devices,
              f"multi: result on {len(a.sharding.device_set)} devices, want {n_devices}")
    if jax.devices()[0].platform == "cpu":  # host devices keep no memory stats
        return
    used = [d.memory_stats()["bytes_in_use"] for d in jax.devices()]
    say("multi", bytes_in_use=used)
    check(all(u > 0 for u in used), "multi: a card holds no data")


def phase_multi(n_devices: int = 4, batch: int = 64, seconds: float = 30.0,
                lm_capacity: int = 256, lm_frames: int = 4):
    """Sequence-parallel fleet over ``seq`` and the landmark-sharded sqrt
    update over ``lm``, each against its unsharded run on one device."""
    import jax
    import jax.numpy as jnp

    from eqvio_tpu import filter as F
    from eqvio_tpu.parallel import make_mesh, sharded_vision_update
    from eqvio_tpu.runner import (
        build_sim_runner,
        default_sim_camera,
        example_frame_inputs,
        prepare_sim_inputs,
    )

    check(len(jax.devices()) == n_devices,
          f"multi: {len(jax.devices())} devices, want {n_devices}")
    settings = F.Settings(
        measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
        use_discrete_innovation_lift=False, use_median_depth=False,
        initial_scene_depth=2.5,
    )
    inputs = prepare_sim_inputs(settings, capacity=32, max_features=30, end_time=seconds,
                                imu_freq=200.0, frame_freq=20.0, num_walls=4,
                                dtype=jnp.float32)
    kw = dict(augment_true_landmarks=False, compute_nees=False, batch=batch)
    t0 = time.perf_counter()
    res_s = build_sim_runner(settings, inputs, mesh=make_mesh({"seq": n_devices}), **kw)()
    jax.block_until_ready(res_s.est_position)
    t_s = time.perf_counter() - t0
    with jax.default_device(jax.devices()[0]):
        t0 = time.perf_counter()
        res_l = build_sim_runner(settings, inputs, **kw)()
        jax.block_until_ready(res_l.est_position)
        t_l = time.perf_counter() - t0
    est_s, est_l = np.asarray(res_s.est_position), np.asarray(res_l.est_position)
    check(np.isfinite(est_s).all(), "multi: NaN in the sharded fleet")
    err_seq = float(np.abs(est_s - est_l).max())
    say("multi", path="seq_fleet", batch=batch, frames=est_s.shape[1],
        max_dpos_m=f"{err_seq:.3e}", tol_m=1e-3,
        sharded_s_incl_compile=f"{t_s:.3f}", single_s_incl_compile=f"{t_l:.3f}")
    check(err_seq < 1e-3, f"multi: sharded fleet diverged by {err_seq:.3e} m")

    # landmark-sharded square-root update inside a frame scan
    sq = F.Settings(measurement_noise=0.5, sqrt_covariance=True)
    camera = default_sim_camera(jnp.float32)
    state0 = F.init_state(sq, lm_capacity, jnp.float32)
    imu_win, dts, pix, vis, ids = example_frame_inputs(lm_capacity, dtype=jnp.float32)
    state0 = F.add_landmarks(state0, pix, vis, ids, camera, sq)
    rng = np.random.default_rng(1)
    pix_seq = pix[None] + jnp.asarray(rng.normal(size=(lm_frames, lm_capacity, 2)) * 0.5,
                                      dtype=jnp.float32)
    suite = sq.suite

    def scan_with(update):
        def body(state, p):
            state = F.propagate_window(state, imu_win, dts, sq, suite)
            state = update(state, p, vis)
            return state, state.X.A.x

        return jax.jit(lambda s: jax.lax.scan(body, s, pix_seq))

    upd_sh = sharded_vision_update(make_mesh({"lm": n_devices}), sq, camera)
    end_s, traj_s = scan_with(upd_sh)(state0)
    jax.block_until_ready(traj_s)
    with jax.default_device(jax.devices()[0]):
        end_l, traj_l = scan_with(
            lambda s, p, v: F.update_vision(s, p, v, camera, sq)
        )(jax.device_put(state0, jax.devices()[0]))
    check(np.isfinite(np.asarray(end_s.Sigma)).all(), "multi: NaN in the sharded update")
    err_lm = float(np.abs(np.asarray(traj_s) - np.asarray(traj_l)).max())
    say("multi", path="lm_sharded_sqrt_update", capacity=lm_capacity, frames=lm_frames,
        max_dpos_m=f"{err_lm:.3e}", tol_m=1e-3)
    check(err_lm < 1e-3, f"multi: landmark-sharded update diverged by {err_lm:.3e} m")
    _device_spread([res_s.est_position, end_s.Sigma], n_devices)
    return err_seq, err_lm


# --------------------------------------------------------------------------


def fresh_dir(name: str) -> str:
    path = os.path.join(DATA_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {"platform": platform, "kind": kind,
                                              "count": count}})


def rehearse_d_cpu(dataset: str, work: str, frames: int = REFERENCE_FRAMES) -> float:
    """Spread due to numerics alone: f32 + sqrt covariance vs f64 dense, both
    on the CPU with the gather tracker, over the first ``frames`` frames."""
    a, b = os.path.join(work, "cpu_f32"), os.path.join(work, "cpu_f64")
    run_reference(dataset, a, frames, "float32")
    run_reference(dataset, b, frames, "float64")
    return max_position_gap(a, b, frames)


# d_cpu: ``python chip_smoke.py --rehearse-d-cpu`` on a CPU host (CHANGES.md)
D_CPU_M = 7.7e-5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded paths")
    ap.add_argument("--rehearse-d-cpu", action="store_true",
                    help="print d_cpu (f32+sqrt vs f64 dense on the CPU) and exit")
    args = ap.parse_args(argv)

    import jax

    from eqvio_tpu.app._env import configure_runtime

    configure_runtime()
    if args.rehearse_d_cpu:
        dataset = ensure_sequence()
        print(f"d_cpu_m={rehearse_d_cpu(dataset, fresh_dir('runs')):.7f}")
        return

    dev = phase_device()
    work = fresh_dir("runs")
    if args.multi:
        phase_multi()
    else:
        dataset = ensure_sequence()
        gpu_out = os.path.join(work, "gpu")
        n_frames = len(np.arange(0.2 + 1.0 / SEQUENCE["frame_freq"], SEQUENCE["end_time"],
                                 1.0 / SEQUENCE["frame_freq"]))
        phase_main(dataset, gpu_out, n_frames)
        phase_reference(dataset, gpu_out, os.path.join(work, "cpu_f64"),
                        REFERENCE_FRAMES, D_CPU_M)
        phase_sim(os.path.join(work, "sim"))
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
