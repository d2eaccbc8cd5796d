"""Neal's funnel (BASELINE config 3): the divergence / step-size stress test."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NealsFunnel", "NonCenteredFunnel"]


class NealsFunnel:
    """Neal's funnel: ``v ~ N(0, scale^2)``, ``x_i | v ~ N(0, exp(v/2)^2)``.

    ``q[0] = v``, ``q[1:] = x``. Centered parameterization — NUTS at the
    default ``target_accept=0.8`` should produce divergences in the neck,
    which is exactly what this config stresses (tree depth, step-size
    adaptation, divergence accounting).
    """

    def __init__(self, ndim: int = 10, scale: float = 3.0, dtype=jnp.float32):
        assert ndim >= 2
        self.ndim = int(ndim)
        self.scale = float(scale)
        self.dtype = dtype
        # Exact marginals: v ~ N(0, scale^2); x_i has var E[exp(v)] = exp(scale^2/2)
        self.true_mean = np.zeros(ndim)
        self.true_var = np.concatenate(
            [[scale ** 2], np.full(ndim - 1, np.exp(scale ** 2 / 2.0))]
        )

    def logp(self, q: jax.Array) -> jax.Array:
        v, x = q[0], q[1:]
        n_x = self.ndim - 1
        logp_v = -0.5 * (v / self.scale) ** 2
        # x_i ~ N(0, exp(v/2)^2): logpdf = -v/2 per dim - x^2 exp(-v) / 2
        logp_x = -0.5 * n_x * v - 0.5 * jnp.sum(x * x) * jnp.exp(-v)
        return logp_v + logp_x

    def logp_grad(self, q: jax.Array):
        v, x = q[0], q[1:]
        n_x = self.ndim - 1
        e = jnp.exp(-v)
        sq = jnp.sum(x * x)
        logp = -0.5 * (v / self.scale) ** 2 - 0.5 * n_x * v - 0.5 * sq * e
        dv = -v / self.scale ** 2 - 0.5 * n_x + 0.5 * sq * e
        dx = -x * e
        return logp, jnp.concatenate([dv[None], dx])

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        return jax.vmap(self.logp_grad)(q)


class NonCenteredFunnel:
    """Neal's funnel, non-centered: ``q = [v_tilde, x_tilde...]``.

    ``v = scale * v_tilde`` and ``x = exp(v/2) * x_tilde``, so the
    *sampled* density is iid standard normal (trivial geometry, no
    divergences) and the funnel shape is recovered deterministically by
    :meth:`transform`. This is the reparameterization the centered
    :class:`NealsFunnel` docs recommend when divergences appear — kept in
    the zoo so the two parameterizations can be compared on the same
    figure-of-merit.
    """

    def __init__(self, ndim: int = 10, scale: float = 3.0, dtype=jnp.float32):
        assert ndim >= 2
        self.ndim = int(ndim)
        self.scale = float(scale)
        self.dtype = dtype
        self.true_mean = np.zeros(ndim)  # in the sampled (tilde) space
        self.true_var = np.ones(ndim)

    def logp(self, q: jax.Array) -> jax.Array:
        return -0.5 * jnp.sum(q * q)

    def logp_grad(self, q: jax.Array):
        return -0.5 * jnp.sum(q * q), -q

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        return -0.5 * jnp.sum(q * q, axis=-1), -q

    def transform(self, q):
        """Map sampled tilde-space draws to the funnel's (v, x) space.

        Accepts any leading batch shape; last axis is the parameter axis.
        """
        v = self.scale * q[..., :1]
        x = jnp.exp(v / 2.0) * q[..., 1:]
        return jnp.concatenate([v, x], axis=-1)
