"""Gaussian targets: the 1-D quickstart model and the 100-d correlated Gaussian.

BASELINE configs 1 and 2. The correlated Gaussian's ``logp_grad`` computes
the gradient and the log-density in a *single* matrix-vector product
(``grad = -Λ(q-μ)``, ``logp = ½ (q-μ)·grad + const``): one matvec per
evaluation instead of the forward+backward pair ``jax.value_and_grad``
would issue. Batched over chains this is a single ``(C, n) @ (n, n)``
matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["StandardNormal", "CorrelatedGaussian", "SpikedGaussian"]


class StandardNormal:
    """iid standard normal in ``ndim`` dimensions (BASELINE config 1)."""

    def __init__(self, ndim: int = 1, dtype=jnp.float32):
        self.ndim = int(ndim)
        self.dtype = dtype
        # exact posterior moments, for tests/benchmarks
        self.true_mean = np.zeros(ndim)
        self.true_var = np.ones(ndim)

    def logp(self, q: jax.Array) -> jax.Array:
        return -0.5 * jnp.sum(q * q)

    def logp_grad(self, q: jax.Array):
        return -0.5 * jnp.sum(q * q), -q

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        return -0.5 * jnp.sum(q * q, axis=-1), -q


def _ar1_correlation(ndim: int, rho: float) -> np.ndarray:
    idx = np.arange(ndim)
    return rho ** np.abs(idx[:, None] - idx[None, :])


class CorrelatedGaussian:
    """Zero-mean Gaussian with AR(1)-correlated covariance (BASELINE config 2).

    ``cov[i, j] = scales[i] * scales[j] * rho^|i-j|`` — strong off-diagonal
    structure plus a range of scales, so diag vs full mass-matrix
    adaptation behave measurably differently.
    """

    def __init__(self, ndim: int = 100, rho: float = 0.9, scale_range=(0.1, 10.0),
                 dtype=jnp.float32, seed: int = 0):
        self.ndim = int(ndim)
        self.dtype = dtype
        rng = np.random.RandomState(seed)
        log_scales = rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]), ndim)
        scales = np.exp(np.sort(log_scales))
        corr = _ar1_correlation(ndim, rho)
        cov = corr * scales[:, None] * scales[None, :]
        self.cov = np.asarray(cov, np.float64)
        self.prec = np.linalg.inv(self.cov)
        self.true_mean = np.zeros(ndim)
        self.true_var = np.diag(self.cov).copy()
        self._prec_dev = jnp.asarray(self.prec, dtype)

    def logp(self, q: jax.Array) -> jax.Array:
        g = -jnp.dot(self._prec_dev, q, precision="highest",
                     preferred_element_type=self._prec_dev.dtype)
        return 0.5 * jnp.dot(q, g)

    def logp_grad(self, q: jax.Array):
        # one matvec yields both the gradient and the quadratic form
        g = -jnp.dot(self._prec_dev, q, precision="highest",
                     preferred_element_type=self._prec_dev.dtype)
        return 0.5 * jnp.dot(q, g), g

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``: one matmul."""
        g = -jnp.dot(q, self._prec_dev, precision="highest",
                     preferred_element_type=self._prec_dev.dtype)
        return 0.5 * jnp.sum(q * g, axis=-1), g


class SpikedGaussian:
    """Zero-mean Gaussian with spiked covariance ``S(I + V(Λ−I)Vᵀ)S``.

    The adversary for diagonal mass matrices: after standardization the
    covariance keeps ``k`` spike eigenvalues ``λᵢ ≫ 1`` while the bulk
    deflates well below 1, so ``adapt_diag`` needs trees
    ``~log2(sqrt(λmax/α))`` deeper than a metric that models the spikes.
    This is the geometry ``QuadPotentialLowRankAdapt``
    (``init="adapt_lowrank"``) is built for; the dense metric fixes it
    too at O(n²) cost. No reference counterpart (its docs ship no
    models; the closest is our ``CorrelatedGaussian`` — BASELINE
    config 2).

    ``logp_grad`` uses the structured precision
    ``Σ⁻¹ = S⁻¹(I + V(λ⁻¹−1)Vᵀ)S⁻¹`` — exact in O(nk), never
    materializing an ``n×n`` matrix, so large-``ndim`` benchmarks stay
    cheap and every product is a ``(C, n) @ (n, k)`` panel.
    """

    def __init__(self, ndim: int = 100, rank: int = 4,
                 spikes=(400.0, 100.0, 25.0, 9.0), scale_range=(0.1, 10.0),
                 dtype=jnp.float32, seed: int = 7):
        self.ndim = int(ndim)
        self.rank = int(rank)
        self.dtype = dtype
        rng = np.random.RandomState(seed)
        V = np.linalg.qr(rng.standard_normal((ndim, self.rank)))[0]
        lam = np.asarray(spikes[: self.rank], np.float64)
        s = np.exp(np.sort(rng.uniform(np.log(scale_range[0]),
                                       np.log(scale_range[1]), ndim)))
        self.V = V
        self.lam = lam
        self.scales = s
        self.true_mean = np.zeros(ndim)
        # diag(Σ) = s² (1 + Σᵢ (λᵢ−1) Vᵢ²)
        self.true_var = s ** 2 * (1.0 + ((lam - 1.0) * V ** 2).sum(axis=1))
        self._V = jnp.asarray(V, dtype)
        self._ilam_m1 = jnp.asarray(1.0 / lam - 1.0, dtype)
        self._inv_s = jnp.asarray(1.0 / s, dtype)

    def _neg_prec_matvec(self, q: jax.Array) -> jax.Array:
        x = q * self._inv_s
        c = jnp.dot(x, self._V, precision="highest",
                    preferred_element_type=x.dtype)
        y = x + jnp.dot(self._ilam_m1 * c, self._V.T, precision="highest",
                        preferred_element_type=x.dtype)
        return -y * self._inv_s

    def logp(self, q: jax.Array) -> jax.Array:
        return 0.5 * jnp.dot(q, self._neg_prec_matvec(q))

    def logp_grad(self, q: jax.Array):
        g = self._neg_prec_matvec(q)
        return 0.5 * jnp.dot(q, g), g

    def batched_logp_grad(self, q: jax.Array):
        """Chain-batched ``(logp, grad)`` for ``q: (chains, n)``."""
        g = self._neg_prec_matvec(q)
        return 0.5 * jnp.sum(q * g, axis=-1), g
