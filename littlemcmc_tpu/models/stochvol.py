"""Stochastic volatility: the classic T-latent-state finance model.

The standard hard target from the Stan/PyMC example corpus (the
reference itself ships no models — its docs say "bring your own logp",
``docs/tutorials/quickstart.rst:37-49``): daily returns
``y_t ~ N(0, exp(h_t/2)²)`` with an AR(1) log-volatility process
``h_t = mu + phi (h_{t-1} - mu) + sigma ε_t``. The parameter vector is
``q = [phi_raw, log_sigma, mu, h_1..h_T]`` (``ndim = T + 3``), so it
exercises the large-``ndim`` axis with realistic funnel-like coupling
between ``sigma`` and the latent states.

Notes: the AR(1) prior is evaluated with *shifted arrays* —
``h[1:] - mu - phi (h[:-1] - mu)`` — one vectorized residual row, no
``lax.scan`` over time inside the log-density, so the whole model is
elementwise + reductions and batches perfectly over chains. Gradients
come from ``jax.value_and_grad`` (the expression graph is cheap either
way).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["StochasticVolatility"]


class StochasticVolatility:
    """Centered-parameterization stochastic volatility on synthetic returns.

    Priors follow Stan's user's-guide example: ``(phi+1)/2 ~ Beta(20,
    1.5)`` (persistence concentrated near 1), ``sigma ~ HalfCauchy(5)``,
    ``mu ~ Cauchy(0, 10)``; ``phi = tanh(phi_raw)`` and ``sigma =
    exp(log_sigma)`` keep the sampled space unconstrained, with the
    usual change-of-variables jacobians in the log-density.
    """

    def __init__(self, T: int = 128, phi: float = 0.97, sigma: float = 0.25,
                 mu: float = -1.0, dtype=jnp.float32, seed: int = 0):
        self.T = int(T)
        self.ndim = self.T + 3
        self.dtype = dtype
        self.true_phi = float(phi)
        self.true_sigma = float(sigma)
        self.true_mu = float(mu)
        rng = np.random.RandomState(seed)
        h = np.empty(self.T)
        h[0] = mu + sigma / np.sqrt(1 - phi ** 2) * rng.standard_normal()
        for t in range(1, self.T):
            h[t] = mu + phi * (h[t - 1] - mu) + sigma * rng.standard_normal()
        y = np.exp(h / 2) * rng.standard_normal(self.T)
        self.h_true = h
        self.y = y
        self._y2 = jnp.asarray(y * y, dtype)

    def logp(self, q: jax.Array) -> jax.Array:
        phi_raw, log_sigma, mu = q[0], q[1], q[2]
        h = q[3:]
        phi = jnp.tanh(phi_raw)
        sigma = jnp.exp(log_sigma)
        T = self.T

        # priors (with unconstraining jacobians):
        # (phi+1)/2 ~ Beta(20, 1.5); d((phi+1)/2)/dphi_raw = (1-phi²)/2
        lp = (19.0 * jnp.log((1.0 + phi) / 2.0)
              + 0.5 * jnp.log((1.0 - phi) / 2.0)
              + jnp.log(1.0 - phi ** 2))
        # sigma ~ HalfCauchy(5); jacobian dsigma/dlog_sigma = sigma
        lp = lp - jnp.log(1.0 + (sigma / 5.0) ** 2) + log_sigma
        # mu ~ Cauchy(0, 10)
        lp = lp - jnp.log(1.0 + (mu / 10.0) ** 2)

        # AR(1) prior on h (stationary init), one vectorized residual row
        e1 = (h[0] - mu) * jnp.sqrt(1.0 - phi ** 2) / sigma
        et = (h[1:] - mu - phi * (h[:-1] - mu)) / sigma
        lp = lp - 0.5 * (e1 ** 2 + jnp.sum(et ** 2)) \
            - T * log_sigma + 0.5 * jnp.log(1.0 - phi ** 2)

        # returns likelihood: y_t ~ N(0, exp(h_t/2)²)
        lp = lp - 0.5 * jnp.sum(h) - 0.5 * jnp.sum(self._y2 * jnp.exp(-h))
        return lp

    def logp_grad(self, q: jax.Array):
        return jax.value_and_grad(self.logp)(q)
