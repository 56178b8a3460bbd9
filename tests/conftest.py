import os

import pytest

# Tests run on a virtual 8-device CPU mesh so sharding logic is exercised
# without several cards; filter math is validated in float64.  With
# EQVIO_TEST_GPU=1 (on a machine with a GPU) JAX keeps its default backend,
# so the tests marked ``gpu`` run on the card.
if not os.environ.get("EQVIO_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """JAX's first device, when it is a GPU; the test is skipped otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `EQVIO_TEST_GPU=1 python -m pytest -m gpu` on the card")
    return dev
