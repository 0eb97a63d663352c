"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so the multi-device sharding paths
compile and execute without accelerator hardware.  Tests that need the GPU
carry the ``gpu`` marker and take the ``gpu_device`` fixture, which decides
at run time (never at import) whether a card is present; on the card the
same paths run end to end through ``python chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def reference_file():
    """Path getter into a checkout of the reference repository, named by
    PCS_REFERENCE_DIR (this repo carries only configs/ from it); skips the
    test with a reason when the checkout or the file is absent."""

    def get(*parts):
        root = os.environ.get("PCS_REFERENCE_DIR")
        if not root:
            pytest.skip("reference checkout not available: set "
                        "PCS_REFERENCE_DIR to run this test")
        path = os.path.join(root, *parts)
        if not os.path.exists(path):
            pytest.skip(f"{path} not found in the reference checkout")
        return path

    return get


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU, else skip with a reason."""
    import jax

    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA GPU (run on the card via chip_smoke.py)")
    return dev
