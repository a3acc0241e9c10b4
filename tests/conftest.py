"""Test configuration: give the CPU backend 8 virtual devices.

Sharding logic is validated on fake CPU devices via
``--xla_force_host_platform_device_count`` (same pattern as the
``dryrun_multichip`` check).  The flag must be set before the first
``import jax`` anywhere in the test session.  The platform itself comes
from ``JAX_PLATFORMS``: the CPU suite runs with ``JAX_PLATFORMS=cpu``;
tests marked ``chip`` need a GPU and skip without one.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from slam_eslam_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform})")
    return dev
