"""Group-indexed hierarchical regression (random intercepts).

The most common real Bayesian model shape — observations indexed into
groups (``theta[groups]``) with partial pooling. The reference's "bring
your own logp" contract (``docs/tutorials/quickstart.rst:37-49``) covers
exactly this kind of user model: its gradient is plain autodiff, with the
group gather's scatter-add in the backward pass.

Non-centered parameterization (the production form for hierarchical
geometry): ``q = [mu, log_tau, b (p), z (J)]`` with group intercepts
``a_j = mu + tau * z_j``, ``tau = exp(log_tau)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["HierarchicalRegression"]


class HierarchicalRegression:
    """Random-intercept Gaussian regression on synthetic grouped data.

    ``y_i ~ N(mu + tau * z[g_i] + x_i . b, sigma)`` with ``z_j ~ N(0,1)``
    (non-centered intercepts), ``b ~ N(0,1)``, ``mu ~ N(0, 5)``,
    ``log_tau ~ N(0, 1)``. The log-density uses ``jnp.take`` for the
    group gather — deliberately written the way a user would write it,
    so its gradient contains the scatter-add VJP.
    """

    def __init__(self, n_groups: int = 32, n_rows: int = 512,
                 n_features: int = 8, sigma: float = 0.5, seed: int = 11,
                 dtype=jnp.float32):
        rng = np.random.RandomState(seed)
        g = rng.randint(0, n_groups, n_rows)
        X = rng.randn(n_rows, n_features)
        X = (X - X.mean(0)) / X.std(0)
        self.true_mu = 0.4
        self.true_tau = 0.8
        self.true_b = rng.randn(n_features) * 0.5
        self.true_z = rng.randn(n_groups)
        y = (self.true_mu + self.true_tau * self.true_z[g]
             + X @ self.true_b + sigma * rng.randn(n_rows))

        self._g = jnp.asarray(g)
        self._X = jnp.asarray(X, dtype)
        self._y = jnp.asarray(y, dtype)
        self.sigma = float(sigma)
        self.n_groups = int(n_groups)
        self.n_features = int(n_features)
        self.ndim = 2 + n_features + n_groups
        self.dtype = dtype

    # parameter unpacking: [mu, log_tau, b(p), z(J)]
    def _split(self, q):
        p = self.n_features
        return q[0], q[1], q[2:2 + p], q[2 + p:]

    def logp(self, q: jax.Array) -> jax.Array:
        mu, log_tau, b, z = self._split(q)
        tau = jnp.exp(log_tau)
        pred = mu + tau * jnp.take(z, self._g) + self._X @ b
        inv_s2 = 1.0 / self.sigma ** 2
        loglik = -0.5 * inv_s2 * jnp.sum((self._y - pred) ** 2)
        logprior = (-0.5 * jnp.sum(z ** 2) - 0.5 * jnp.sum(b ** 2)
                    - 0.5 * (mu / 5.0) ** 2 - 0.5 * log_tau ** 2)
        return loglik + logprior

    def logp_grad(self, q: jax.Array):
        return jax.value_and_grad(self.logp)(q)

    def batched_logp_grad(self, q: jax.Array):
        return jax.vmap(self.logp_grad)(q)
