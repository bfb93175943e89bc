import os
import sys

import pytest

# Tests run on a virtual 8-device CPU mesh, so multi-device sharding paths
# run without accelerators.  Both settings must precede the first jax
# import.  Tests marked `gpu` run on the card when JAX_PLATFORMS names it.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU (decided when
    the test runs, never at import)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
