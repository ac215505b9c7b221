"""Test configuration: the tests run on the CPU backend with an 8-device
virtual mesh, so sharding tests run anywhere.  Tests marked ``gpu`` need
a card: run them with JAX_PLATFORMS=cuda (README, "Tests")."""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")
