"""Batch dataset runner + analysis: the ``run_and_analyse_dataset.py`` equivalent.

Reads a dataset-list YAML (same shape as the reference's
``scripts/euroc_sequences.yaml``: name/location/mode/camera/start per entry),
runs the full pipeline over each sequence, analyses each output directory
against its ground truth, and writes the roll-up summary
(``summarise_results.py`` equivalent).

Usage:
    python -m eqvio_tpu.app.batch datasets.yaml config.yaml --output out/
"""

from __future__ import annotations

import argparse
import os

from ..analysis import analyse_output_dir, make_report, summarise_results
from ..io import load_config
from ..io.yaml_lite import safe_dump, safe_load
from .run_opt import run_dataset


def run_batch(dataset_list: str, config_path: str, output_root: str, dtype=None,
              plots: bool = True, timing: bool = True, checkpoint_every: int = 0,
              config_path_by_entry: bool = True):
    if dtype is None:
        from ._env import configure_runtime

        dtype = configure_runtime()
    with open(dataset_list) as f:
        datasets = safe_load(f)
    config = load_config(config_path)

    result_files = []
    for entry in datasets.get("datasets", datasets if isinstance(datasets, list) else []):
        name = entry["name"]
        out_dir = os.path.join(output_root, name)
        print(f"=== {name} ===", flush=True)
        # per-entry config override (the reference's batch YAML pairs each
        # dataset list with one config; ours allows per-sequence configs so
        # EuRoC- and UZHFPV-tuned sequences can share one batch run)
        cfg = load_config(entry["config"]) if (config_path_by_entry and entry.get("config")) else config
        ckpt = os.path.join(out_dir, "checkpoint.npz")
        resume = ckpt if (checkpoint_every and os.path.exists(ckpt)) else None
        if resume:
            print(f"  resuming from {ckpt}", flush=True)
        _, summary = run_dataset(
            entry["location"],
            cfg,
            mode=entry.get("mode", "asl"),
            output_dir=out_dir,
            start=entry.get("start"),
            stop=entry.get("stop"),
            camera_yaml=entry.get("camera"),
            timing=timing,
            dtype=dtype,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
        print(f"  {summary['frames']} frames @ {summary['fps']:.1f} fps "
              f"(device {summary.get('device_ms_per_frame', '?')} ms/frame, "
              f"dispatch {summary.get('dispatch_ms_per_frame', '?')} ms/frame)",
              flush=True)
        gt = entry.get("groundtruth") or os.path.join(
            entry["location"], "mav0", "state_groundtruth_estimate0", "data.csv"
        )
        gt_format = entry.get("gt_format", "asl")
        if os.path.exists(gt):
            res = analyse_output_dir(out_dir, gt, gt_format=gt_format)
            print(f"  position rmse: {res['position (m)']['rmse']:.4f} m  "
                  f"scale: {res['scale']:.4f}", flush=True)
            result_files.append(os.path.join(out_dir, "results.yaml"))
            if plots:
                make_report(out_dir, gt, gt_format=gt_format)

    # merge with any per-sequence results already on disk so a partial rerun
    # (single-sequence dataset list) updates the roll-up instead of clobbering
    # it with a completed:1 file
    import glob

    all_results = sorted(
        set(result_files) | set(glob.glob(os.path.join(output_root, "*", "results.yaml")))
    )
    summary = summarise_results(all_results)
    with open(os.path.join(output_root, "summary.yaml"), "w") as f:
        safe_dump(summary, f)
    print(f"mean position rmse: {summary['mean position rmse']:.4f} m "
          f"({summary['completed']} sequences)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("datasets")
    ap.add_argument("config")
    ap.add_argument("--output", default="batch_out")
    ap.add_argument("--noPlots", action="store_true")
    ap.add_argument("--noTiming", action="store_true")
    ap.add_argument("--checkpointEvery", type=int, default=0, dest="checkpoint_every")
    args = ap.parse_args(argv)
    run_batch(args.datasets, args.config, args.output, plots=not args.noPlots,
              timing=not args.noTiming, checkpoint_every=args.checkpoint_every)


if __name__ == "__main__":
    main()
