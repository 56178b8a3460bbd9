"""Sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eqvio_tpu import filter as F
from eqvio_tpu import states as S
from eqvio_tpu.parallel import (
    batch_sim_step,
    make_batched_states,
    make_mesh,
    shard_batch,
    sharded_vision_update,
)
from eqvio_tpu.runner import default_sim_camera

from .utils import reasonable_state


def test_mesh_creation():
    mesh = make_mesh()
    assert mesh.shape["seq"] == len(jax.devices())


def test_sharded_vision_update_matches_reference():
    """Landmark-sharded update == single-device update bit-for-bit-ish."""
    rng = np.random.default_rng(21)
    cam = default_sim_camera()
    settings = F.Settings(measurement_noise=0.5)
    N = 16
    xi0 = reasonable_state(rng, N, n_active=12)
    state = F.init_state(settings, N)
    state = state._replace(xi0=xi0)

    pix_true, _ = S.measure_system(xi0, cam)
    pixels = pix_true + jnp.asarray(rng.normal(size=(N, 2)) * 0.5)
    vis = jnp.asarray(np.concatenate([np.ones(12, bool), np.zeros(4, bool)]))

    ref = F.update_vision(state, pixels, vis, cam, settings)

    mesh = make_mesh({"lm": 8})
    upd = sharded_vision_update(mesh, settings, cam)
    out = jax.jit(upd)(state, pixels, vis)

    np.testing.assert_allclose(np.asarray(out.Sigma), np.asarray(ref.Sigma), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.X.A.R), np.asarray(ref.X.A.R), atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.X.Q.a), np.asarray(ref.X.Q.a), atol=1e-10)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sharded_sqrt_update_matches_reference(dtype):
    """Square-root mode + landmark-sharded update == local sqrt update.

    Guards the production-numerics (f32 + sqrt, auto-enabled in run_opt)
    against the scale-out path: the Kailath array QR with its ``C L``
    pre-array block assembled over landmark shards must match the local
    factor bit-for-bit-ish."""
    rng = np.random.default_rng(22)
    cam = default_sim_camera(dtype)
    settings = F.Settings(measurement_noise=0.5, sqrt_covariance=True)
    N = 16
    xi0 = reasonable_state(rng, N, n_active=12)
    xi0 = jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype.kind == "f" else a, xi0
    )
    state = F.init_state(settings, N, dtype)
    state = state._replace(xi0=xi0)

    pix_true, _ = S.measure_system(xi0, cam)
    pixels = (pix_true + jnp.asarray(rng.normal(size=(N, 2)) * 0.5)).astype(dtype)
    vis = jnp.asarray(np.concatenate([np.ones(12, bool), np.zeros(4, bool)]))

    ref = F.update_vision(state, pixels, vis, cam, settings)

    mesh = make_mesh({"lm": 8})
    upd = sharded_vision_update(mesh, settings, cam)
    out = jax.jit(upd)(state, pixels, vis)

    tol = 1e-4 if dtype == jnp.float32 else 1e-9
    np.testing.assert_allclose(np.asarray(out.Sigma), np.asarray(ref.Sigma), atol=tol)
    np.testing.assert_allclose(np.asarray(out.X.A.R), np.asarray(ref.X.A.R), atol=tol)
    np.testing.assert_allclose(np.asarray(out.X.Q.a), np.asarray(ref.X.Q.a), atol=tol)
    # the factor reconstructs the same covariance as the dense-mode update
    dense = F.Settings(measurement_noise=0.5)
    ref_dense = F.update_vision(
        state._replace(Sigma=(state.Sigma @ state.Sigma.T).astype(dtype)),
        pixels, vis, cam, dense,
    )
    np.testing.assert_allclose(
        np.asarray(out.Sigma @ out.Sigma.T),
        np.asarray(ref_dense.Sigma),
        atol=(5e-3 if dtype == jnp.float32 else 1e-8),
    )


def test_two_process_distributed_step():
    """A real 2-process jax.distributed run (gloo CPU collectives) of one
    batched VIO frame step over the GLOBAL mesh — the multi-host path
    (``parallel/dist_worker.py``)."""
    import os
    import socket
    import subprocess
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "eqvio_tpu.parallel.dist_worker", str(p), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for p in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert any("DIST_OK" in out for out in outs)


def test_batched_sharded_step_runs():
    """A batch of sequences steps under jit with the batch axis sharded."""
    n_dev = len(jax.devices())
    settings = F.Settings(measurement_noise=0.5)
    cam = default_sim_camera()
    B, N, K = n_dev, 8, 4
    mesh = make_mesh({"seq": n_dev})
    states = make_batched_states(settings, B, N, dtype=jnp.float64)
    states = shard_batch(mesh, states)

    rng = np.random.default_rng(3)
    imu_win = S.IMU(
        stamp=jnp.zeros((B, K)),
        gyr=jnp.asarray(rng.normal(size=(B, K, 3)) * 0.01),
        acc=jnp.asarray(rng.normal(size=(B, K, 3)) * 0.01 + np.array([0, 0, 9.81])),
        gyr_bias_vel=jnp.zeros((B, K, 3)),
        acc_bias_vel=jnp.zeros((B, K, 3)),
    )
    dts = jnp.full((B, K), 0.005)
    pixels = jnp.asarray(rng.uniform(100, 500, size=(B, N, 2)))
    vis = jnp.ones((B, N), dtype=bool)
    ids = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N))

    step = jax.jit(batch_sim_step(settings, cam))
    out = step(states, imu_win, dts, pixels, vis, ids)
    assert not np.any(np.isnan(np.asarray(out.Sigma)))
    assert np.asarray(out.xi0.mask).sum() > 0
