"""Root pytest config: select the JAX backend for all collected tests.

It lives at the repo root (not only ``tests/``) so that doctest runs
(``make doctest`` → ``pytest --doctest-modules littlemcmc_tpu``) get the
same backend as the unit suite.

The default is the local CPU with an 8-device virtual mesh. With
``LMC_TEST_PLATFORM=gpu`` (``make test-gpu``, on a machine with an
NVIDIA GPU) JAX keeps its GPU backend, and the tests marked ``gpu`` run.
"""

import os

_PLATFORM = os.environ.get("LMC_TEST_PLATFORM", "cpu").lower()

if _PLATFORM == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
