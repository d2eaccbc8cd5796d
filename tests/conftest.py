"""Test fixtures. Backend selection lives in the ROOT conftest.py
(repo root) so doctest runs share it; see there for LMC_TEST_PLATFORM.
"""

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def eight_device_mesh():
    from jax.sharding import Mesh

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip(
            f"needs 8 devices for the virtual mesh, backend has {len(devices)}"
        )
    return Mesh(np.array(devices[:8]), ("chains",))


@pytest.fixture
def gpu_devices():
    """The GPUs JAX sees; skips the test when there are none.

    Decided here, when the test runs, never at import: every xdist worker
    must collect the same tests.
    """
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `LMC_TEST_PLATFORM=gpu python -m "
                    f"pytest -m gpu` on the card (JAX platform here: "
                    f"{devices[0].platform})")
    return devices


def std_normal_logp_grad(q):
    """The shared test model: iid standard normal (reference tests/test_utils.py:19-28)."""
    import jax.numpy as jnp

    return -0.5 * jnp.sum(q ** 2), -q
