"""Test configuration.

By default the suite runs on the CPU: JAX is held to a virtual 8-device
CPU mesh (xla_force_host_platform_device_count), which the sharding
tests need. Tests that need a GPU are marked ``chip`` and take the
``gpu`` fixture, which skips them when the first JAX device is not a
GPU. To run them on a GPU machine, keep the GPU visible:

    FRAVE_TEST_GPU=1 python -m pytest tests/ -m chip

(``chip_smoke.py`` runs them inside its own process the same way.)
"""

import os

import pytest

if os.environ.get("FRAVE_TEST_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX found {dev.platform}); run with "
            "FRAVE_TEST_GPU=1 on a GPU machine"
        )
    return dev
