"""Run one full-length proxy sequence in a chosen numerics mode, print ATE.

The accuracy-bisection workhorse: compares f32+sqrt (the production mode
off the CPU), f64 dense (reference-parity mode), and mixed modes on the
committed proxy sequences.  CPU example:

    JAX_PLATFORMS=cpu python scripts/run_proxy.py racing --dtype f32 --out /tmp/x

On a GPU run one such process per card (JAX reserves most of the card's
memory at start-up).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROXIES = {
    "racing": dict(
        ds="/tmp/eqvio_proxies/racing",
        cfg="configs/config_racing_proxy.yaml",
        mode="uzhfpv",
        camera="/tmp/eqvio_proxies/racing/camchain-imucam.yaml",
        gt="/tmp/eqvio_proxies/racing/groundtruth.txt",
        gt_format="uzhfpv",
    ),
    "v101": dict(
        ds="/tmp/eqvio_proxies/v101",
        cfg="configs/config_v101_proxy.yaml",
        mode="asl",
        camera=None,
        gt="/tmp/eqvio_proxies/v101/mav0/state_groundtruth_estimate0/data.csv",
        gt_format="asl",
    ),
    "mh03": dict(
        ds="/tmp/eqvio_proxies/mh03",
        cfg="configs/config_mh03_proxy.yaml",
        mode="asl",
        camera=None,
        gt="/tmp/eqvio_proxies/mh03/mav0/state_groundtruth_estimate0/data.csv",
        gt_format="asl",
    ),
    "distractor": dict(
        ds="/tmp/eqvio_proxies/distractor",
        cfg="configs/config_v101_proxy.yaml",
        mode="asl",
        camera=None,
        gt="/tmp/eqvio_proxies/distractor/mav0/state_groundtruth_estimate0/data.csv",
        gt_format="asl",
    ),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("proxy", choices=sorted(PROXIES))
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--dense", action="store_true",
                    help="force dense covariance (default: sqrt when f32)")
    ap.add_argument("--sqrt", action="store_true",
                    help="force sqrt covariance even with f64")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="limit the number of frames (quick bisection)")
    ap.add_argument("--noRansac", action="store_true",
                    help="disable the tracker RANSAC gate (gate-attribution runs)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from eqvio_tpu.app._env import configure_runtime

    configure_runtime()

    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32

    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.io import load_config

    p = PROXIES[args.proxy]
    cfg = load_config(os.path.join(ROOT, p["cfg"]))
    if args.dense or args.sqrt:
        cfg.setdefault("eqf", {}).setdefault("settings", {})[
            "useSqrtCovariance"
        ] = bool(args.sqrt)
    if args.noRansac:
        cfg.setdefault("GIFT", {}).setdefault("ransacParams", {})[
            "inlierThreshold"
        ] = 0.0
    out = args.out or f"/tmp/proxy_{args.proxy}_{args.dtype}" + (
        "_dense" if args.dense else "_sqrt" if args.sqrt else ""
    )
    t0 = time.time()
    _, summary = run_dataset(
        p["ds"], cfg, mode=p["mode"], output_dir=out,
        camera_yaml=p["camera"], dtype=dtype, limit_frames=args.frames,
    )
    wall = time.time() - t0
    res = analyse_output_dir(out, p["gt"], gt_format=p["gt_format"])
    line = {
        "proxy": args.proxy,
        "dtype": args.dtype,
        "mode": ("dense" if args.dense else "sqrt" if (args.sqrt or args.dtype == "f32") else "default"),
        "frames": summary["frames"],
        "fps": round(summary["fps"], 1),
        "wall_s": round(wall, 1),
        "healthy": summary["healthy"],
        "pos_rmse_m": round(float(res["position (m)"]["rmse"]), 4),
        "att_rmse_deg": round(float(res["attitude (d)"]["rmse"]), 3),
        "scale": round(float(res["scale"]), 4),
        "length_m": round(float(res["length (m)"]), 1),
        "flags": res["flags"],
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
