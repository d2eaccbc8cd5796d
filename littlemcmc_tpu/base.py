"""Shared HMC machinery: configs, per-chain state, and kernel scaffolding.

Functional counterpart of the reference's ``littlemcmc/base_hmc.py``. The
reference's mutable ``BaseHMC`` object becomes (a) a frozen, hashable
config dataclass closed over by the jitted kernel and (b) a ``ChainState``
pytree threaded through ``lax.scan``. One ``kernel(state, tuning)`` call
is the counterpart of one ``BaseHMC._astep`` (``base_hmc.py:140-190``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from . import pytree

from .integration import IntegratorState, recompute_with_momentum
from .step_sizes import DualAverageState, dual_average_init, dual_average_update

__all__ = ["NUTSConfig", "HMCConfig", "ChainState", "init_chain_state"]

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


@dataclasses.dataclass(frozen=True)
class _BaseConfig:
    """Common HMC options (defaults from reference ``nuts.py:110-120``)."""

    target_accept: float = 0.8
    Emax: float = 1000.0
    adapt_step_size: bool = True
    step_scale: float = 0.25
    gamma: float = 0.05
    k: float = 0.75
    t0: float = 10.0
    # Optional traceable step-size jitter, ``(step_size, key) -> step_size``
    # (reference's host-side ``step_rand`` callback, ``base_hmc.py:154-155``).
    step_rand: object = None
    # Symplectic scheme: "leapfrog" (reference parity), "two_stage", or
    # "three_stage" minimal-norm splittings (see integration.py).
    integrator: str = "leapfrog"


@dataclasses.dataclass(frozen=True)
class NUTSConfig(_BaseConfig):
    """NUTS options (reference ``nuts.py:103-120``)."""

    max_treedepth: int = 10
    early_max_treedepth: int = 8
    # Number of initial tuning iterations that use ``early_max_treedepth``
    # (reference hardcodes 200 at ``nuts.py:205``).
    early_window: int = 200


@dataclasses.dataclass(frozen=True)
class HMCConfig(_BaseConfig):
    """Classic HMC options (reference ``hmc.py:52-68``)."""

    path_length: float = 2.0
    max_steps: int = 1024


@pytree.dataclass
class ChainState:
    """Everything one chain carries between draws.

    The union of the reference's mutable sampler attributes: position +
    cached model eval (so the per-draw re-evaluation at ``base_hmc.py:143``
    is avoided), the adaptive potential, dual-averaging state, the PRNG
    key, and the iteration counter used by NUTS's early-treedepth schedule.
    """

    rng_key: jax.Array
    q: jax.Array
    q_grad: jax.Array
    logp: jax.Array
    potential: object  # one of the quadpotential pytrees
    da: DualAverageState
    iter_count: jax.Array  # int32


def init_chain_state(
    rng_key: jax.Array,
    q0: jax.Array,
    potential,
    config: _BaseConfig,
    logp_grad_fn: LogpGradFn,
) -> ChainState:
    """Initialize one chain at position ``q0``.

    Initial step size is ``step_scale / ndim**0.25`` (``base_hmc.py:102``).
    """
    logp, grad = logp_grad_fn(q0)
    ndim = q0.shape[-1]
    step0 = config.step_scale / (ndim ** 0.25)
    return ChainState(
        rng_key=rng_key,
        q=q0,
        q_grad=grad,
        logp=logp,
        potential=potential,
        da=dual_average_init(step0, dtype=q0.dtype),
        iter_count=jnp.asarray(0, jnp.int32),
    )


def start_of_trajectory(state: ChainState, k_momentum: jax.Array) -> IntegratorState:
    """Draw a fresh momentum and assemble the trajectory start state.

    Counterpart of ``base_hmc.py:142-143``; reuses the cached ``(logp,
    grad)`` instead of re-evaluating the model.
    """
    p0 = state.potential.sample_momentum(k_momentum)
    return recompute_with_momentum(state.potential, state.q, state.q_grad, state.logp, p0)


def finish_step(
    state: ChainState,
    new_key: jax.Array,
    proposal_q: jax.Array,
    proposal_grad: jax.Array,
    proposal_logp: jax.Array,
    accept_stat: jax.Array,
    tuning: jax.Array,
    config: _BaseConfig,
) -> ChainState:
    """Adaptation updates shared by HMC and NUTS (``base_hmc.py:161-162``)."""
    adapting = jnp.logical_and(tuning, config.adapt_step_size)
    da = dual_average_update(
        state.da,
        accept_stat,
        adapting,
        target=config.target_accept,
        gamma=config.gamma,
        k=config.k,
        t0=config.t0,
    )
    potential = state.potential.update(proposal_q, proposal_grad, tuning)
    return ChainState(
        rng_key=new_key,
        q=proposal_q,
        q_grad=proposal_grad,
        logp=proposal_logp,
        potential=potential,
        da=da,
        iter_count=state.iter_count + 1,
    )
