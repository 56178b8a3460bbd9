#!/bin/bash
# Test runner: CPU-only JAX with an 8-device virtual mesh (tests/conftest.py).
# The tests marked `gpu` skip here; on a machine with a GPU run them with
#   EQVIO_TEST_GPU=1 python -m pytest tests/ -m gpu
export JAX_PLATFORMS=cpu
exec python -m pytest "${@:-tests/}" -q
