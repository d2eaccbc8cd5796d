"""Classic Hamiltonian Monte Carlo transition kernel (fixed-shape, XLA-ready).

Counterpart of the reference's ``littlemcmc/hmc.py``. The
jittered-path-length trajectory loop (``hmc.py:140-150``) becomes a
``lax.while_loop`` with a data-dependent (but bounded) step count;
divergence detection (``hmc.py:151-162``) is mask-based.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .math import tree_select

from .base import ChainState, HMCConfig, finish_step, start_of_trajectory
from .integration import IntegratorState, leapfrog

__all__ = ["HMCConfig", "HMCInfo", "build_hmc_kernel"]

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


class HMCInfo(NamedTuple):
    """Per-draw sampler statistics; names match reference ``hmc.py:36-50``."""

    step_size: jax.Array
    n_steps: jax.Array
    tune: jax.Array
    step_size_bar: jax.Array
    accept: jax.Array
    diverging: jax.Array
    energy_error: jax.Array
    energy: jax.Array
    path_length: jax.Array
    accepted: jax.Array
    model_logp: jax.Array


def run_hmc_trajectory(
    key: jax.Array,
    start: IntegratorState,
    step_size: jax.Array,
    potential,
    logp_grad_fn: LogpGradFn,
    config: HMCConfig,
):
    """Integrate one jittered-length trajectory and Metropolis-accept.

    Equivalent of ``HamiltonianMC._hamiltonian_step`` (``hmc.py:140-182``):
    ``path_length ~ U(0,1) * config.path_length``; ``n_steps =
    clamp(floor(path/ε), 1, max_steps)``; divergence on non-finite energy
    or ``|ΔE| > Emax``; accept w.p. ``min(1, exp(E_start - E_end))``.
    """
    k_path, k_accept = jax.random.split(key)
    dtype = start.energy.dtype

    path_length = jax.random.uniform(k_path, dtype=dtype) * config.path_length
    n_steps = jnp.clip(
        (path_length / step_size).astype(jnp.int32), 1, config.max_steps
    )

    def cond(carry):
        i, state = carry
        return i < n_steps

    def body(carry):
        i, state = carry
        return i + 1, leapfrog(
            potential, logp_grad_fn, step_size, state, config.integrator
        )

    _, end = lax.while_loop(cond, body, (jnp.asarray(0, jnp.int32), start))

    energy_change = start.energy - end.energy
    energy_change = jnp.where(jnp.isnan(energy_change), -jnp.inf, energy_change)
    diverging = (~jnp.isfinite(end.energy)) | (
        jnp.abs(energy_change) > jnp.asarray(config.Emax, dtype)
    )

    accept_stat = jnp.minimum(1.0, jnp.exp(energy_change))
    u = jax.random.uniform(k_accept, dtype=dtype)
    accepted = (~diverging) & (u < accept_stat)
    final = tree_select(accepted, end, start)

    return final, end, accept_stat, accepted, diverging, energy_change, path_length, n_steps


@functools.lru_cache(maxsize=512)
def build_hmc_kernel(logp_grad_fn: LogpGradFn, config: HMCConfig = HMCConfig()):
    """Build the chain-batched HMC transition ``kernel(states, tuning)``.

    The per-chain transition (below) is batched with ``vmap`` — HMC's
    trajectory loop has no stack machinery, so ``vmap``'s masked
    while-loop batching is already the right lowering. Memoized on
    ``(logp_grad_fn, config)`` — see ``build_nuts_kernel``.
    """

    def kernel(state: ChainState, tuning: jax.Array) -> Tuple[ChainState, HMCInfo]:
        key, k_momentum, k_traj, k_sr = jax.random.split(state.rng_key, 4)
        start = start_of_trajectory(state, k_momentum)

        adapting = jnp.logical_and(tuning, config.adapt_step_size)
        step_size = state.da.current(adapting)
        if config.step_rand is not None:
            step_size = config.step_rand(step_size, k_sr)

        (
            final,
            end,
            accept_stat,
            accepted,
            diverging,
            energy_change,
            path_length,
            n_steps,
        ) = run_hmc_trajectory(k_traj, start, step_size, state.potential, logp_grad_fn, config)

        new_state = finish_step(
            state,
            key,
            final.q,
            final.q_grad,
            final.model_logp,
            accept_stat,
            tuning,
            config,
        )

        info = HMCInfo(
            step_size=jnp.exp(new_state.da.log_step),
            n_steps=n_steps,
            tune=tuning,
            step_size_bar=jnp.exp(new_state.da.log_bar),
            accept=accept_stat,
            diverging=diverging,
            energy_error=energy_change,
            energy=end.energy,
            path_length=path_length,
            accepted=accepted,
            model_logp=end.model_logp,
        )
        return new_state, info

    return jax.vmap(kernel, in_axes=(0, None))
