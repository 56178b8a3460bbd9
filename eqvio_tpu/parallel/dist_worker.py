"""Multi-process worker: one full VIO frame step over a global multi-host mesh.

The reference is a single process (SURVEY.md §2.9); this is the
``jax.distributed`` path — each process contributes its local devices, the
sequence-batch axis is sharded over the GLOBAL mesh, and GSPMD emits the
cross-process collectives (gloo on CPU).

Run as::

    python -m eqvio_tpu.parallel.dist_worker <process_id> <num_processes> <port>

with ``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=K``
for a virtual multi-host run (K local devices per process). Process 0 prints
``DIST_OK ...`` on success.

Exercised by ``__graft_entry__.dryrun_multichip`` and
``tests/test_parallel.py::test_two_process_distributed_step``.
"""

from __future__ import annotations

import sys


def main(process_id: int, num_processes: int, port: str) -> None:
    import os

    import jax

    jax.config.update("jax_default_matmul_precision", "float32")
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        # cross-process collectives on the CPU client ride gloo; must be set
        # before the backend is initialised (i.e. before any device query)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from eqvio_tpu.parallel import init_distributed

    init_distributed(
        coordinator=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )

    import jax.numpy as jnp
    import numpy as np

    from eqvio_tpu import filter as F
    from eqvio_tpu.parallel import batch_sim_step, make_batched_states, make_mesh, shard_batch
    from eqvio_tpu.runner import default_sim_camera
    from eqvio_tpu.states import IMU

    n_global = len(jax.devices())
    assert n_global == num_processes * jax.local_device_count()

    dtype = jnp.float32
    settings = F.Settings(measurement_noise=0.5)
    camera = default_sim_camera(dtype)
    capacity, window = 16, 8
    B = n_global

    # global mesh spanning every device of every process
    mesh = make_mesh({"seq": n_global})
    states = shard_batch(mesh, make_batched_states(settings, B, capacity, dtype))

    rng = np.random.default_rng(0)
    imu_win = IMU(
        stamp=jnp.asarray(
            np.broadcast_to(np.linspace(0.0, 0.035, window), (B, window)), dtype=dtype
        ),
        gyr=jnp.asarray(rng.normal(size=(B, window, 3)) * 0.01, dtype=dtype),
        acc=jnp.asarray(
            rng.normal(size=(B, window, 3)) * 0.01 + np.array([0.0, 0.0, 9.81]),
            dtype=dtype,
        ),
        gyr_bias_vel=jnp.zeros((B, window, 3), dtype=dtype),
        acc_bias_vel=jnp.zeros((B, window, 3), dtype=dtype),
    )
    pixels = jnp.asarray(rng.uniform(100, 500, size=(B, capacity, 2)), dtype=dtype)
    batch_inputs = shard_batch(
        mesh,
        (
            imu_win,
            jnp.full((B, window), 0.005, dtype=dtype),
            pixels,
            jnp.ones((B, capacity), dtype=bool),
            jnp.broadcast_to(jnp.arange(capacity, dtype=jnp.int32), (B, capacity)).copy(),
        ),
    )

    step = jax.jit(batch_sim_step(settings, camera))
    out = step(states, *batch_inputs)
    jax.block_until_ready(out)

    # NaN check on the GLOBAL array via a replicated jitted reduction
    # (out.Sigma is not fully addressable in any single process)
    bad = jax.jit(lambda s: jnp.any(jnp.isnan(s)))(out.Sigma)
    n_active = jax.jit(lambda m: jnp.sum(m))(out.xi0.mask)
    assert not bool(bad)
    assert int(n_active) == B * capacity

    if process_id == 0:
        print(
            f"DIST_OK processes={num_processes} global_devices={n_global} "
            f"batch={B} active_landmarks={int(n_active)}"
        )


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
