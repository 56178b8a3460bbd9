"""Runtime configuration shared by every entry point.

- Matmul precision is pinned to float32 ("highest"). On a GPU an f32 matmul
  may otherwise run in TF32, which keeps about three decimal digits: too few
  for the filter's Riccati and QR math.
- x64 is enabled on every backend, so the optional f64-island
  re-triangularisation (``EQVIO_TRIA=f64``, a validation mode) can engage;
  the hot-path dtypes are pinned, so nothing silently promotes.
- The filter dtype is f64 on the CPU (the reference numerics) and f32 with
  the square-root covariance on any other backend. That split is inherited
  from the accelerator the code was first written for, which had no native
  f64; ROADMAP speed item 7 decides it on the GPU by measurement.
- The persistent compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
  says, or else in ``<repo>/.jax_cache``, a fixed path (it is part of the
  cache key) that ``.gitignore`` lists.
"""

from __future__ import annotations

import os
import subprocess

import jax
import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The persistent compile-cache directory in use: the environment's
    ``JAX_COMPILATION_CACHE_DIR`` when set (and non-empty), else the repo's
    fixed ``.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def require_gpu():
    """Return JAX's first device; raise unless it is a GPU.

    JAX falls back to the CPU with only a warning when its CUDA plugin fails
    to initialise, so a measurement that must run on the card checks here.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports
    them, read by a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def configure_runtime(prefer_x64: bool = True, force_x64: bool = False):
    """Set the global precision and cache settings; return the filter dtype.

    ``force_x64`` (CLI ``--f64``) selects f64 filter math on every backend;
    the image front end stays f32 either way.

    ``EQVIO_DEBUG_NANS=1`` turns on jax NaN-checking in every entry point —
    the runtime analogue of the reference's sanitizer builds + pervasive
    ``assert(!hasNaN())`` (SURVEY.md section 5.3).
    """
    jax.config.update("jax_default_matmul_precision", "float32")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # when the variable is set, JAX reads it itself
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    if os.environ.get("EQVIO_DEBUG_NANS"):
        jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_enable_x64", True)
    if force_x64 or (prefer_x64 and jax.default_backend() == "cpu"):
        return jnp.float64
    return jnp.float32
