"""Bayesian logistic regression (BASELINE config 4).

The canonical benchmark is German credit (~25 params). This container has
zero egress, so :func:`german_credit_synthetic` generates a fixed-seed
synthetic design matrix with the same shape (1000 rows, 24 features +
intercept = 25 params) and realistic feature correlations; the model
itself is dataset-agnostic.

``logp_grad`` is analytic: the gradient reuses the forward logits, so one
evaluation costs a single ``(N, p)`` matvec pair — batched over chains,
two matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["LogisticRegression", "german_credit_synthetic"]


def german_credit_synthetic(n_rows: int = 1000, n_features: int = 24, seed: int = 7):
    """Fixed-seed synthetic stand-in for the German-credit design matrix."""
    rng = np.random.RandomState(seed)
    # correlated features, standardized like the usual preprocessing
    L = np.tril(rng.randn(n_features, n_features) * 0.3) + np.eye(n_features)
    X = rng.randn(n_rows, n_features) @ L.T
    X = (X - X.mean(0)) / X.std(0)
    beta_true = rng.randn(n_features) * 0.5
    logits = X @ beta_true + 0.3
    y = (rng.rand(n_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return X, y


class LogisticRegression:
    """Bayesian logistic regression with a N(0, prior_scale²) prior.

    Parameters are ``q = [intercept, beta...]`` (``n_features + 1`` dims).
    """

    def __init__(self, X=None, y=None, prior_scale: float = 10.0, dtype=jnp.float32):
        if X is None:
            X, y = german_credit_synthetic()
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n, p = X.shape
        # fold the intercept into the design matrix
        self._Xb = jnp.asarray(np.concatenate([np.ones((n, 1)), X], axis=1), dtype)
        self._y = jnp.asarray(y, dtype)
        self.ndim = p + 1
        self.prior_scale = float(prior_scale)
        self.dtype = dtype

    def logp(self, q: jax.Array) -> jax.Array:
        logits = jnp.dot(self._Xb, q, precision="highest",
                         preferred_element_type=self._Xb.dtype)
        # sum log sigmoid(±logits), stable form
        loglik = jnp.sum(self._y * logits - jax.nn.softplus(logits))
        logprior = -0.5 * jnp.sum(q * q) / self.prior_scale ** 2
        return loglik + logprior

    def logp_grad(self, q: jax.Array):
        logits = jnp.dot(self._Xb, q, precision="highest",
                         preferred_element_type=self._Xb.dtype)
        mu = jax.nn.sigmoid(logits)
        loglik = jnp.sum(self._y * logits - jax.nn.softplus(logits))
        logprior = -0.5 * jnp.sum(q * q) / self.prior_scale ** 2
        grad = (
            jnp.dot(self._y - mu, self._Xb, precision="highest",
                    preferred_element_type=self._Xb.dtype)
            - q / self.prior_scale ** 2
        )
        return loglik + logprior, grad

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        return jax.vmap(self.logp_grad)(q)
