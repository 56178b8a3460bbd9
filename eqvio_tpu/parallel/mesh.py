"""Device mesh helpers for multi-chip/multi-host VIO.

The reference is single-process (SURVEY.md §2.9); the axes of scale here
are the sequence-batch axis (many dataset sequences in parallel) and
the landmark-block axis of Sigma (sharded Gram reduction in the update).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialise multi-host JAX (jax.distributed) for a multi-process run.

    No-op for single-process runs.  After this, :func:`make_mesh` sees every
    device across hosts and the `seq`-sharded batch runner + landmark-sharded
    update use cross-process collectives transparently (GSPMD inserts them
    from the shardings).
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(axis_sizes: dict[str, int] | None = None) -> Mesh:
    """Build a mesh over all available devices.

    Default: 1-D ``("seq",)`` mesh over every device — sequence-batch data
    parallelism. Pass e.g. ``{"seq": 2, "lm": 4}`` for a 2-D mesh with a
    landmark-shard axis.
    """
    devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = {"seq": len(devices)}
    names = tuple(axis_sizes.keys())
    shape = tuple(axis_sizes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, names)


def shard_batch(mesh: Mesh, tree, axis: str = "seq"):
    """Place a pytree with a leading batch axis onto the mesh, sharded over it."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)
