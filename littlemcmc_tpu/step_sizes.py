"""Dual-averaging step-size adaptation as a pure functional state machine.

Counterpart of the reference's ``littlemcmc/step_sizes.py``
(Nesterov dual averaging, Hoffman & Gelman Algorithm 5). The update math
matches ``step_sizes.py:71-92`` exactly; the post-tune acceptance-rate
warning check (``step_sizes.py:101-121``) is computed post-hoc from the
gathered stats arrays in :mod:`littlemcmc_tpu.report` instead of being
accumulated in a Python list.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .math import tree_select
from . import pytree

__all__ = ["DualAverageState", "dual_average_init", "dual_average_update"]




@pytree.dataclass
class DualAverageState:
    """Per-chain dual-averaging state (reference ``step_sizes.py:49-56``)."""

    log_step: jax.Array
    log_bar: jax.Array
    hbar: jax.Array
    count: jax.Array  # starts at 1
    mu: jax.Array

    def current(self, adapting) -> jax.Array:
        """Step size to use this draw (reference ``step_sizes.py:58-69``)."""
        return jnp.where(adapting, jnp.exp(self.log_step), jnp.exp(self.log_bar))


def dual_average_init(initial_step, dtype=jnp.float32) -> DualAverageState:
    log_step = jnp.log(jnp.asarray(initial_step, dtype))
    return DualAverageState(
        log_step=log_step,
        log_bar=log_step,
        hbar=jnp.asarray(0.0, dtype),
        count=jnp.asarray(1, jnp.int32),
        mu=jnp.log(10.0 * jnp.asarray(initial_step, dtype)),
    )


def dual_average_update(
    state: DualAverageState,
    accept_stat: jax.Array,
    adapting,
    *,
    target: float,
    gamma: float,
    k: float,
    t0: float,
) -> DualAverageState:
    """One dual-averaging update; no-op unless ``adapting``.

    Math from reference ``step_sizes.py:85-92``:
    ``w = 1/(count+t0)``; ``hbar ← (1-w)·hbar + w·(target-accept)``;
    ``log_step = mu - hbar·sqrt(count)/gamma``;
    ``log_bar ← count^{-k}·log_step + (1-count^{-k})·log_bar``.
    """
    count = state.count.astype(state.log_step.dtype)
    w = 1.0 / (count + t0)
    hbar = (1.0 - w) * state.hbar + w * (target - accept_stat)
    log_step = state.mu - hbar * jnp.sqrt(count) / gamma
    mk = count ** (-k)
    log_bar = mk * log_step + (1.0 - mk) * state.log_bar
    updated = DualAverageState(
        log_step=log_step,
        log_bar=log_bar,
        hbar=hbar,
        count=state.count + 1,
        mu=state.mu,
    )
    return tree_select(adapting, updated, state)
