"""littlemcmc_tpu: an accelerator-native HMC/NUTS inference engine.

A from-scratch re-design of littlemcmc (the reference package) for
accelerators: pure-function transition kernels over immutable pytree
states, compiled once by XLA, ``vmap``-ed over thousands of chains,
driven by ``lax.scan``, and sharded over a ``chains`` mesh axis for
multi-device / multi-host runs.

Public API mirrors the reference's ``littlemcmc/__init__.py:19-29``.

Quickstart (the reference's ``docs/tutorials/quickstart.rst:64-90``, on
device):

>>> import jax.numpy as jnp
>>> import littlemcmc_tpu as lmc
>>> def logp_grad(x):
...     return -0.5 * jnp.sum(x ** 2), -x
>>> trace, stats = lmc.sample(
...     logp_dlogp_func=logp_grad, model_ndim=2, chains=4,
...     tune=100, draws=100, random_seed=0, progressbar=False)
>>> trace.shape
(4, 100, 2)
>>> sorted(stats)[:3]
['depth', 'diverging', 'energy']
"""

__version__ = "0.1.0"

from .sampling import sample, init_nuts, NUTS, HamiltonianMC
from .quadpotential import (
    quad_potential,
    isquadpotential,
    QuadPotentialDiag,
    QuadPotentialFull,
    QuadPotentialFullInv,
    QuadPotentialDiagAdapt,
    QuadPotentialFullAdapt,
    QuadPotentialLowRankAdapt,
    PositiveDefiniteError,
)
from .base import NUTSConfig, HMCConfig, ChainState, init_chain_state
from .nuts import build_nuts_kernel, NUTSInfo
from .hmc import build_hmc_kernel, HMCInfo
from .model import as_logp_grad, from_logp_fn, from_numpy_callable, from_torch_callable
from .report import SamplerWarning, WarningType, warnings_from_stats
from .exceptions import SamplingError, IntegrationError, ParallelSamplingError
from . import models
from . import parallel
from . import utils

__all__ = [
    "__version__",
    "sample",
    "init_nuts",
    "NUTS",
    "HamiltonianMC",
    "quad_potential",
    "isquadpotential",
    "PositiveDefiniteError",
    "QuadPotentialDiag",
    "QuadPotentialFull",
    "QuadPotentialFullInv",
    "QuadPotentialDiagAdapt",
    "QuadPotentialFullAdapt",
    "QuadPotentialLowRankAdapt",
    "NUTSConfig",
    "HMCConfig",
    "ChainState",
    "init_chain_state",
    "build_nuts_kernel",
    "build_hmc_kernel",
    "NUTSInfo",
    "HMCInfo",
    "as_logp_grad",
    "from_logp_fn",
    "from_numpy_callable",
    "from_torch_callable",
    "SamplerWarning",
    "WarningType",
    "warnings_from_stats",
    "SamplingError",
    "IntegrationError",
    "ParallelSamplingError",
    "models",
    "parallel",
    "utils",
]
