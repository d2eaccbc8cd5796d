"""Hierarchical eight-schools, non-centered (BASELINE config 5).

The classic dataset (Rubin 1981): treatment-effect estimates and standard
errors for eight schools. Non-centered parameterization:
``q = [mu, log_tau, theta_tilde_1..8]`` (10 params),
``theta_i = mu + exp(log_tau) * theta_tilde_i``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["EightSchools"]

_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


class EightSchools:
    """Non-centered eight schools with N(0,5) prior on mu, N(0,5) on log_tau."""

    ndim = 10

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype
        self._y = jnp.asarray(_Y, dtype)
        self._sigma = jnp.asarray(_SIGMA, dtype)
        self.true_mean = None  # no closed form; checked via self-consistency

    def logp(self, q: jax.Array) -> jax.Array:
        mu, log_tau, tt = q[0], q[1], q[2:]
        tau = jnp.exp(log_tau)
        theta = mu + tau * tt
        lp = -0.5 * (mu / 5.0) ** 2
        lp += -0.5 * (log_tau / 5.0) ** 2
        lp += -0.5 * jnp.sum(tt * tt)
        lp += jnp.sum(-0.5 * ((self._y - theta) / self._sigma) ** 2)
        return lp

    def logp_grad(self, q: jax.Array):
        mu, log_tau, tt = q[0], q[1], q[2:]
        tau = jnp.exp(log_tau)
        theta = mu + tau * tt
        resid = (self._y - theta) / (self._sigma ** 2)  # d loglik / d theta
        lp = (
            -0.5 * (mu / 5.0) ** 2
            - 0.5 * (log_tau / 5.0) ** 2
            - 0.5 * jnp.sum(tt * tt)
            + jnp.sum(-0.5 * ((self._y - theta) / self._sigma) ** 2)
        )
        dmu = -mu / 25.0 + jnp.sum(resid)
        dlog_tau = -log_tau / 25.0 + tau * jnp.sum(resid * tt)
        dtt = -tt + tau * resid
        return lp, jnp.concatenate([dmu[None], dlog_tau[None], dtt])

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        return jax.vmap(self.logp_grad)(q)
