"""Chunk-size sweep of the full-frame pipeline on one GPU.

Runs the bench sequence at several ``--chunk`` values and prints wall fps
plus the dispatch/device/fetch decomposition per frame.

    python scripts/chunk_sweep.py [chunks...]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax.numpy as jnp

    from bench import BENCH_DATASET, _ensure_dataset
    from eqvio_tpu.app._env import configure_runtime, require_gpu
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.io import load_config

    configure_runtime()
    require_gpu()

    _ensure_dataset()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "config_template.yaml"))
    cfg["GIFT"]["maxFeatures"] = 30
    cfg["GIFT"]["winSize"] = 21
    cfg["eqf"]["initialValue"]["sceneDepth"] = 2.2

    chunks = [int(a) for a in sys.argv[1:]] or [16, 32, 64, 128]
    rows = []
    for C in chunks:
        def once():
            with tempfile.TemporaryDirectory() as out:
                t0 = time.perf_counter()
                _, summary = run_dataset(
                    BENCH_DATASET, cfg, output_dir=out, dtype=jnp.float32,
                    chunk_size=C,
                )
                return summary, time.perf_counter() - t0

        once()  # compile
        best, summary = float("inf"), {}
        for _ in range(3):
            summary, dt = once()
            best = min(best, dt)
        row = {
            "chunk": C,
            "fps": round(summary["frames"] / best, 1),
            "wall_ms_per_frame": round(best * 1e3 / summary["frames"], 2),
            "device_ms_per_frame": summary.get("device_ms_per_frame"),
            "dispatch_ms_per_frame": summary.get("dispatch_ms_per_frame"),
            "fetch_ms_per_frame": summary.get("fetch_ms_per_frame"),
            "write_ms_per_frame": summary.get("write_ms_per_frame"),
            "healthy": summary.get("healthy"),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": rows}), flush=True)


if __name__ == "__main__":
    main()
