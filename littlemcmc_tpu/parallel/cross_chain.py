"""Cross-chain mass-matrix adaptation: pool Welford statistics over chains.

A strict extension over the reference (whose chains adapt in isolation,
one process each): with hundreds-to-thousands of vectorized chains, the
pooled position statistics give a far lower-variance metric estimate per
tuning window. Each chain keeps its own Welford accumulators (so window
swaps stay exact); only the *metric* (``var``/``stds`` or ``cov``/
``chol``) is recomputed from the cross-chain pooled moments each tuning
step. Under a ``chains``-sharded mesh the pooling reductions become XLA
collectives automatically.

Pooled moments use the standard parallel Welford combination
(Chan et al.): ``W = Σ w_c``, ``M = Σ w_c m_c / W``,
``raw = Σ raw_c + Σ w_c (m_c - M)²`` (outer products in the dense case).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..quadpotential import (QuadPotentialDiagAdapt, QuadPotentialFullAdapt,
                             QuadPotentialLowRankAdapt,
                             _effective_eigenvalues, _orthonormal_columns)

__all__ = ["cross_chain_potential_pool"]


def _pooled_diag_moments(pot):
    """Pooled ``(mean, var)`` from chain-batched diag Welford foregrounds."""
    w = pot.fg.w_sum  # (C,)
    W = jnp.sum(w)
    M = jnp.sum(w[:, None] * pot.fg.mean, axis=0) / W
    raw = jnp.sum(pot.fg.raw_var, axis=0) + jnp.sum(
        w[:, None] * (pot.fg.mean - M) ** 2, axis=0
    )
    return M, raw / W  # biased (divide-by-W), matching the per-chain estimator


def _pooled_diag(pot: QuadPotentialDiagAdapt):
    return _pooled_diag_moments(pot)[1]


def _pooled_cov(pot: QuadPotentialFullAdapt):
    n = pot.fg.n_samples  # (C,)
    N = jnp.sum(n)
    M = jnp.sum(n[:, None] * pot.fg.mean, axis=0) / N
    d = pot.fg.mean - M  # (C, n)
    raw = jnp.sum(pot.fg.raw_cov, axis=0) + jnp.einsum("c,ci,cj->ij", n, d, d)
    return raw / (N - 1.0)


def _pooled_lowrank(pot: QuadPotentialLowRankAdapt, samples, inner: int = 1):
    """Pooled low-rank metric: batch subspace iteration + pooled moments.

    With ``C`` chains contributing one standardized sample each per
    tuning step, one *shifted* subspace-iteration step
    ``V ← orth(V + Zᵀ(ZV)/C)`` (the shift ``+V`` preserves eigenvector
    order and keeps the step stable when the batch estimate is noisy)
    converges to the top-``k`` eigendirections within a few steps —
    far faster than any single chain's rank-1 Oja stream. Eigenvalue
    accumulators are averaged across chains: each chain's last
    ``update`` added its own squared projections, so the average is the
    pooled second-moment estimate.
    """
    M, var = _pooled_diag_moments(pot)
    stds = jnp.sqrt(var)
    inv_stds = 1.0 / stds
    Z = (samples - M) * inv_stds  # (C, n)
    C = samples.shape[0]
    # per-chain bases are one Oja step past the previous pooled basis;
    # the orthonormalized mean re-synchronizes them (exact when identical)
    V = _orthonormal_columns(jnp.mean(pot.vecs, axis=0))
    for _ in range(max(1, int(inner))):
        V = _orthonormal_columns(
            V + jnp.dot(Z.T, jnp.dot(Z, V, precision="highest",
                                     preferred_element_type=Z.dtype) / C,
                        precision="highest", preferred_element_type=Z.dtype))
    lam_w = jnp.mean(pot.lam_w)
    lam_s2 = jnp.mean(pot.lam_s2, axis=0)
    lam = _effective_eigenvalues(lam_s2, lam_w, pot.lam_clip)
    alpha_s2 = jnp.mean(pot.alpha_s2)
    n_resid = max(samples.shape[1] - pot.rank, 1)
    alpha = _effective_eigenvalues(alpha_s2 / n_resid, lam_w, pot.lam_clip)
    Cn = pot.var.shape[0]

    def b(x):
        return jnp.broadcast_to(x, (Cn,) + x.shape)

    return pot.replace(
        var=b(var), stds=b(stds), inv_stds=b(inv_stds),
        vecs=b(V), lam=b(lam), alpha=b(alpha),
        lam_w=b(lam_w), lam_s2=b(lam_s2), alpha_s2=b(alpha_s2),
    )


def cross_chain_potential_pool(potential, tuning, samples=None):
    """Overwrite each chain's metric with the cross-chain pooled estimate.

    ``potential`` is a chain-batched metric pytree (leading axis = chains).
    No-op for static metrics and when ``tuning`` is False. ``samples``
    (the chain-batched positions after this step, ``(C, n)``) feeds the
    low-rank metric's batch subspace iteration; without it the low-rank
    branch pools only the diagonal part.
    """
    if isinstance(potential, QuadPotentialLowRankAdapt):
        if samples is not None:
            pooled = _pooled_lowrank(potential, samples)
        else:
            M, var = _pooled_diag_moments(potential)
            stds = jnp.sqrt(var)
            C = potential.var.shape[0]
            bvar = jnp.broadcast_to(var, (C,) + var.shape)
            bstds = jnp.broadcast_to(stds, (C,) + stds.shape)
            pooled = potential.replace(
                var=bvar, stds=bstds, inv_stds=1.0 / bstds)
    elif isinstance(potential, QuadPotentialDiagAdapt):
        var = _pooled_diag(potential)  # (n,)
        stds = jnp.sqrt(var)
        C = potential.var.shape[0]
        bvar = jnp.broadcast_to(var, (C,) + var.shape)
        bstds = jnp.broadcast_to(stds, (C,) + stds.shape)
        pooled = potential.replace(var=bvar, stds=bstds, inv_stds=1.0 / bstds)
    elif isinstance(potential, QuadPotentialFullAdapt):
        cov = _pooled_cov(potential)  # (n, n)
        chol = jnp.linalg.cholesky(cov)
        ok = jnp.all(jnp.isfinite(chol))
        C = potential.cov.shape[0]
        bcov = jnp.broadcast_to(cov, (C,) + cov.shape)
        bchol = jnp.broadcast_to(chol, (C,) + chol.shape)
        pooled = potential.replace(
            cov=jnp.where(ok, bcov, potential.cov),
            chol=jnp.where(ok, bchol, potential.chol),
        )
    else:
        return potential

    return jax.tree.map(lambda p, s: jnp.where(tuning, p, s), pooled, potential)
