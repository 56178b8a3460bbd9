"""Pure-simulation entry point: the ``eqvio_sim`` equivalent.

Mirrors the reference CLI (``src/main_sim.cpp:37-192``): synthetic trajectory
+ world, ground-truth landmark augmentation (``--fullState`` disables it in
the reference; here ``--selfInit`` enables the self-initialising pipeline),
NEES printout and consistency CSV outputs.

Usage:
    python -m eqvio_tpu.app.run_sim [config.yaml] [--output DIR]
        [--trajectory wave|square|line|sine] [--time T] [--selfInit]
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from .. import filter as F
from ..io import VIOWriter, load_config, settings_from_config
from ..runner import ate_rmse, attitude_rmse, run_simulation


def main(argv=None):
    ap = argparse.ArgumentParser(description="EqVIO simulation")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--time", type=float, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--maxFeatures", type=int, default=None)
    ap.add_argument("--selfInit", action="store_true",
                    help="initialise landmarks from measurements, not ground truth")
    ap.add_argument("--fullState", action="store_true",
                    help="all world landmarks are always part of the state "
                         "(reference eqvio_sim --fullState, main_sim.cpp:56-59)")
    ap.add_argument("--inputNoise", action="store_true")
    ap.add_argument("--outputNoise", action="store_true")
    ap.add_argument("--initialNoise", action="store_true")
    ap.add_argument("--landmarkReset", type=int, default=0,
                    help="reset all landmarks to truth every N frames")
    ap.add_argument("--consistency", action="store_true",
                    help="write pose/bias consistency, NEES breakdown and "
                         "landmark-error CSVs (reference eqvio_sim outputs)")
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)

    from ._env import configure_runtime

    preferred = configure_runtime(prefer_x64=not args.f32)

    sim_params = {}
    if args.config:
        cfg = load_config(args.config)
        settings = settings_from_config(cfg)
        # sim: section defaults (SimulationDataServer.cpp:148,224-232);
        # explicit CLI flags override below
        from ..io import sim_params_from_config

        sim_params = sim_params_from_config(cfg)
    else:
        settings = F.Settings(measurement_noise=0.5)

    if args.trajectory is not None:
        sim_params["kind"] = args.trajectory
    if args.time is not None:
        sim_params["end_time"] = args.time
    if args.maxFeatures is not None:
        sim_params["max_features"] = args.maxFeatures
    for flag, name in (("inputNoise", "input_noise"), ("outputNoise", "output_noise"),
                       ("initialNoise", "initial_noise")):
        if getattr(args, flag):
            sim_params[name] = True
    sim_params.setdefault("kind", "wave")
    sim_params.setdefault("end_time", 30.0)
    sim_params.setdefault("max_features", 30)
    if args.fullState:
        # the whole world enters the state: keep it tractable by default
        sim_params.setdefault("num_points", 120)
    capacity = args.capacity if args.capacity is not None else max(
        32, sim_params["max_features"]
    )

    dtype = jnp.float32 if args.f32 else preferred
    res = run_simulation(
        settings,
        capacity=capacity,
        augment_true_landmarks=not args.selfInit,
        landmark_reset_every=args.landmarkReset,
        consistency=args.consistency,
        full_state=args.fullState,
        dtype=dtype,
        **sim_params,
    )

    est = np.asarray(res.est_position)
    gt = np.asarray(res.true_position)
    rmse, scale = ate_rmse(est, gt)
    att = attitude_rmse(np.asarray(res.est_attitude), np.asarray(res.true_attitude))
    nees = np.asarray(res.nees)
    print(f"frames: {len(est)}")
    print(f"position RMSE (SIM3-aligned): {rmse:.4f} m   scale: {scale:.4f}")
    print(f"attitude RMSE: {att:.3f} deg")
    print(f"NEES median: {np.nanmedian(nees):.3f}  mean: {np.nanmean(nees):.3f}")

    if args.output:
        with VIOWriter(args.output) as writer:
            times = np.asarray(res.times)
            for k in range(len(times)):
                writer.write_states(
                    times[k],
                    np.asarray(res.est_attitude[k]),
                    est[k],
                    np.asarray(res.est_velocity[k]),
                    np.eye(3), np.zeros(3), np.zeros(6),
                )
                writer.write_true_state(
                    times[k],
                    np.asarray(res.true_attitude[k]),
                    gt[k],
                    np.asarray(res.true_velocity[k]),
                    np.zeros(6),
                )
                if res.consistency is not None:
                    pose_nees, att_nees, eps, sig_diag, lm_err = [
                        np.asarray(a) for a in res.consistency
                    ]
                    writer.write_nees(
                        times[k], nees[k], 21 + 3 * int(res.num_landmarks[k]),
                        pose_nees[k], att_nees[k],
                    )
                    writer.write_pose_consistency(
                        times[k], eps[k, 6:12], sig_diag[k, 6:12]
                    )
                    writer.write_bias_consistency(
                        times[k], eps[k, 0:6], sig_diag[k, 0:6]
                    )
                    writer.write_landmark_error(
                        times[k], lm_err[k], ~np.isnan(lm_err[k])
                    )
                else:
                    writer.write_nees(times[k], nees[k], 21 + 3 * int(res.num_landmarks[k]))
        print(f"wrote outputs to {args.output}")
    return {"frames": len(est), "rmse": float(rmse), "scale": float(scale),
            "attitude_rmse_deg": float(att)}


if __name__ == "__main__":
    main()
