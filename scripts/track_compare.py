"""Tracker platform-divergence probe: run the frontend alone over the first
N racing-proxy frames and dump per-frame tracks, so CPU and GPU runs can be
diffed frame by frame.

    # CPU:
    JAX_PLATFORMS=cpu python scripts/track_compare.py dump /tmp/tracks_cpu.npz
    # GPU (default env):
    python scripts/track_compare.py dump /tmp/tracks_gpu.npz
    # diff:
    python scripts/track_compare.py diff /tmp/tracks_cpu.npz /tmp/tracks_gpu.npz
"""

import sys

import numpy as np


def dump(out_path: str, frames: int = 120):
    import jax
    import jax.numpy as jnp

    from eqvio_tpu.app._env import configure_runtime

    configure_runtime()

    from eqvio_tpu.data import create_dataset_reader
    from eqvio_tpu.frontend import tracker_init, tracker_step
    from eqvio_tpu.io import load_config, tracker_config_from_config

    cfg = load_config("configs/config_racing_proxy.yaml")
    tcfg = tracker_config_from_config(cfg)
    reader = create_dataset_reader(
        "uzhfpv", "/tmp/eqvio_proxies/racing",
        "/tmp/eqvio_proxies/racing/camchain-imucam.yaml",
    )
    trk = tracker_init(tcfg, tuple(reversed(reader.camera.resolution)), dtype=jnp.float32)
    step = jax.jit(lambda t, im: tracker_step(t, im, tcfg))
    P, I, M, S = [], [], [], []
    for k in range(min(frames, len(reader.images.stamps))):
        img = jnp.asarray(reader.load_image(k), jnp.float32)
        trk = step(trk, img)
        P.append(np.asarray(trk.positions))
        I.append(np.asarray(trk.ids))
        M.append(np.asarray(trk.mask))
        S.append(bool(np.asarray(trk.searched)))
    np.savez(out_path, pos=np.stack(P), ids=np.stack(I), mask=np.stack(M),
             searched=np.asarray(S), backend=jax.default_backend())
    print(f"dumped {len(P)} frames from {jax.default_backend()} -> {out_path}")


def diff(a_path: str, b_path: str):
    a, b = np.load(a_path), np.load(b_path)
    T = min(len(a["pos"]), len(b["pos"]))
    print(f"comparing {T} frames: {a['backend']} vs {b['backend']}")
    first_div = None
    for t in range(T):
        ma, mb = a["mask"][t], b["mask"][t]
        same_slots = ma & mb & (a["ids"][t] == b["ids"][t])
        if same_slots.any():
            d = np.linalg.norm(a["pos"][t][same_slots] - b["pos"][t][same_slots], axis=-1)
            dmax = float(d.max())
        else:
            dmax = np.nan
        id_mismatch = int((ma != mb).sum() + ((a["ids"][t] != b["ids"][t]) & ma & mb).sum())
        if first_div is None and (id_mismatch > 0 or (dmax == dmax and dmax > 0.5)):
            first_div = t
        if t < 10 or t % 20 == 0 or id_mismatch > 0:
            print(f"  t={t:3d} live {ma.sum():2d}/{mb.sum():2d} "
                  f"id/mask-mismatch {id_mismatch:2d} max|dpos| {dmax:.4f} "
                  f"searched {bool(a['searched'][t])}/{bool(b['searched'][t])}")
    print(f"first divergence at frame {first_div}")


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 120)
    else:
        diff(sys.argv[2], sys.argv[3])
