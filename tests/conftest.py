import os
import sys

import pytest

# The suite runs on the CPU with a virtual 8-device mesh, so multi-device
# sharding logic is exercised without several cards.  Tests marked `gpu`
# need an NVIDIA GPU and skip elsewhere; on a machine with one, run them
# with:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other platforms)")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, never
    at import: every xdist worker must collect the same tests)."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX platform is {platform!r}")


@pytest.fixture
def eight_devices():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
