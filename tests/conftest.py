"""Test harness: 8 host devices for the distributed unit tests.

(The 512-device flag is reserved for launch/dryrun.py per its contract;
8 is enough for every collective test here and keeps smoke tests fast.)

Meshes are built via repro.compat.make_mesh (routed through
repro.launch.mesh) so the suite collects on JAX builds without
jax.sharding.AxisType.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

try:
    import hypothesis  # noqa: F401
except ImportError:  # container image has no hypothesis; use the stub
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub

import jax  # noqa: E402
import pytest  # noqa: E402

from repro.compat import make_mesh  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture(scope="session")
def mesh8():
    return make_mesh((8,), ("data",))


@pytest.fixture(scope="session")
def mesh4x2():
    return make_mesh((4, 2), ("data", "model"))


@pytest.fixture(scope="session")
def mesh2x2x2():
    return make_mesh((2, 2, 2), ("pod", "data", "model"))
