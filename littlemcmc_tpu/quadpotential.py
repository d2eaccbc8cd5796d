"""Quadpotentials (mass matrices / metrics) as immutable JAX pytrees.

Re-design of the reference's ``littlemcmc/quadpotential.py``.
The reference implements metrics as mutable Python objects updated in
place per draw; here every metric is a ``pytree.dataclass``
whose ``update`` returns a *new* state, so the whole adaptation loop can
live inside ``jax.lax.scan``, be ``vmap``-ed over thousands of chains, and
be sharded over a ``chains`` mesh axis with ``jax.sharding``.

Semantics parity notes (file:line cites refer to /root/reference):

- ``QuadPotentialDiagAdapt`` — dual-window Welford variance adaptation
  with foreground/background swap every ``adaptation_window`` samples
  (``quadpotential.py:148-245``). The sample variance of the position is
  used directly as the *inverse* mass-matrix diagonal.
- ``QuadPotentialFullAdapt`` — Stan-style dense covariance adaptation with
  Cholesky refresh every ``update_window`` steps and window doubling
  (``quadpotential.py:471-555``). Cholesky failures are latched in a
  ``chol_failed`` flag (surfaced by ``raise_ok``) instead of deferred
  exceptions (``quadpotential.py:521-526``).
- Static metrics ``QuadPotentialDiag`` / ``QuadPotentialFull`` /
  ``QuadPotentialFullInv`` mirror ``quadpotential.py:346-468``.

Unlike the reference (which mixes float32 metric state with float64
chain state, ``quadpotential.py:175-177``), dtype here follows the
position dtype uniformly — float32 by default.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from .math import tree_select
import numpy as np
from . import pytree

__all__ = [
    "quad_potential",
    "QuadPotentialDiag",
    "QuadPotentialFull",
    "QuadPotentialFullInv",
    "QuadPotentialDiagAdapt",
    "QuadPotentialFullAdapt",
    "QuadPotentialLowRankAdapt",
    "PositiveDefiniteError",
    "partial_check_positive_definite",
]


class PositiveDefiniteError(ValueError):
    """Raised when a scaling matrix fails the simple PD check."""

    def __init__(self, msg, idx):
        super().__init__(msg)
        self.idx = idx
        self.msg = msg

    def __str__(self):
        return "Scaling is not positive definite: %s. Check indexes %s." % (
            self.msg,
            self.idx,
        )


def partial_check_positive_definite(C) -> None:
    """Simple partial PD check on the diagonal (reference ``quadpotential.py:68-77``).

    Runs host-side at construction time (outside jit), so it can raise.
    """
    C = np.asarray(C)
    d = C if C.ndim == 1 else np.diag(C)
    (i,) = np.nonzero(np.logical_or(np.isnan(d), d <= 0))
    if len(i):
        raise PositiveDefiniteError("Simple check failed. Diagonal contains negatives", i)




# ---------------------------------------------------------------------------
# Welford accumulators (online mean/variance/covariance) as pytrees.
# ---------------------------------------------------------------------------


@pytree.dataclass
class WelfordVariance:
    """Online weighted mean/variance (reference ``quadpotential.py:294-343``)."""

    w_sum: jax.Array  # scalar
    w_sum2: jax.Array  # scalar
    mean: jax.Array  # (n,)
    raw_var: jax.Array  # (n,)

    @classmethod
    def create(
        cls,
        n: int,
        initial_mean: Optional[jax.Array] = None,
        initial_variance: Optional[jax.Array] = None,
        initial_weight: float = 0.0,
        dtype=jnp.float32,
    ) -> "WelfordVariance":
        w = jnp.asarray(initial_weight, dtype)
        mean = jnp.zeros(n, dtype) if initial_mean is None else jnp.asarray(initial_mean, dtype)
        var = (
            jnp.zeros(n, dtype)
            if initial_variance is None
            else jnp.asarray(initial_variance, dtype)
        )
        return cls(w_sum=w, w_sum2=w * w, mean=mean, raw_var=var * w)

    def add_sample(self, x: jax.Array, weight: float = 1.0) -> "WelfordVariance":
        """One Welford update (reference ``quadpotential.py:324-332``)."""
        w_sum = self.w_sum + weight
        prop = weight / w_sum
        old_diff = x - self.mean
        mean = self.mean + prop * old_diff
        new_diff = x - mean
        return WelfordVariance(
            w_sum=w_sum,
            w_sum2=self.w_sum2 + weight * weight,
            mean=mean,
            raw_var=self.raw_var + weight * old_diff * new_diff,
        )

    def current_variance(self) -> jax.Array:
        """Biased (divide-by-``w_sum``) variance, as the reference uses for the metric."""
        return self.raw_var / self.w_sum

    def current_mean(self) -> jax.Array:
        return self.mean


@pytree.dataclass
class WelfordCovariance:
    """Online mean/covariance, Stan-math style (reference ``quadpotential.py:563-615``)."""

    n_samples: jax.Array  # scalar count (initial weight included)
    mean: jax.Array  # (n,)
    raw_cov: jax.Array  # (n, n)

    @classmethod
    def create(
        cls,
        n: int,
        initial_mean: Optional[jax.Array] = None,
        initial_covariance: Optional[jax.Array] = None,
        initial_weight: float = 0.0,
        dtype=jnp.float32,
    ) -> "WelfordCovariance":
        w = jnp.asarray(initial_weight, dtype)
        mean = jnp.zeros(n, dtype) if initial_mean is None else jnp.asarray(initial_mean, dtype)
        cov = (
            jnp.eye(n, dtype=dtype)
            if initial_covariance is None
            else jnp.asarray(initial_covariance, dtype)
        )
        return cls(n_samples=w, mean=mean, raw_cov=cov * w)

    def add_sample(self, x: jax.Array, weight: float = 1.0) -> "WelfordCovariance":
        """One update; the count always increments by 1 (reference ``:598-604``)."""
        n = self.n_samples + 1.0
        old_diff = x - self.mean
        mean = self.mean + old_diff / n
        new_diff = x - mean
        return WelfordCovariance(
            n_samples=n,
            mean=mean,
            raw_cov=self.raw_cov + weight * jnp.outer(new_diff, old_diff),
        )

    def current_covariance(self) -> jax.Array:
        """Unbiased (divide-by-``n-1``) covariance (reference ``:606-612``)."""
        return self.raw_cov / (self.n_samples - 1.0)

    def current_mean(self) -> jax.Array:
        return self.mean


# ---------------------------------------------------------------------------
# Static metrics.
# ---------------------------------------------------------------------------


@pytree.dataclass
class QuadPotentialDiag:
    """Fixed diagonal metric; ``v`` is the inverse-mass diagonal.

    Mirrors reference ``quadpotential.py:346-387``.
    """

    v: jax.Array
    s: jax.Array
    inv_s: jax.Array

    @classmethod
    def create(cls, v, dtype=None) -> "QuadPotentialDiag":
        v = jnp.asarray(v, dtype)
        s = jnp.sqrt(v)
        return cls(v=v, s=s, inv_s=1.0 / s)

    def velocity(self, p: jax.Array) -> jax.Array:
        return self.v * p

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        return jax.random.normal(key, self.s.shape, self.s.dtype) * self.inv_s

    def update(self, sample, grad, tuning):
        return self

    def raise_ok(self) -> None:
        return None


@pytree.dataclass
class QuadPotentialFull:
    """Fixed dense metric parameterized by a covariance (= inverse mass) matrix.

    ``velocity = cov @ p``; momentum is drawn with the Cholesky transpose
    solve (reference ``quadpotential.py:430-468``).
    """

    cov: jax.Array
    chol: jax.Array  # lower Cholesky of cov

    @classmethod
    def create(cls, cov, dtype=None) -> "QuadPotentialFull":
        cov = jnp.asarray(cov, dtype)
        return cls(cov=cov, chol=jnp.linalg.cholesky(cov))

    def velocity(self, p: jax.Array) -> jax.Array:
        # exact-f32: bf16 matmul inputs bias the sampled density (the kinetic
        # energy would no longer match the momentum-sampling density)
        return jnp.dot(self.cov, p, precision="highest",
                       preferred_element_type=self.cov.dtype)

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        n = jax.random.normal(key, (self.cov.shape[0],), self.cov.dtype)
        return jax.scipy.linalg.solve_triangular(self.chol.T, n, lower=False)

    def update(self, sample, grad, tuning):
        return self

    def raise_ok(self) -> None:
        return None


@pytree.dataclass
class QuadPotentialFullInv:
    """Fixed dense metric parameterized by the mass (precision) matrix itself.

    ``velocity = A^{-1} p`` via Cholesky solves; momentum ``p = L n``
    (reference ``quadpotential.py:390-427``).
    """

    chol: jax.Array  # lower Cholesky of the mass matrix A

    @classmethod
    def create(cls, A, dtype=None) -> "QuadPotentialFullInv":
        A = jnp.asarray(A, dtype)
        return cls(chol=jnp.linalg.cholesky(A))

    def velocity(self, p: jax.Array) -> jax.Array:
        return jax.scipy.linalg.cho_solve((self.chol, True), p)

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        n = jax.random.normal(key, (self.chol.shape[0],), self.chol.dtype)
        return jnp.dot(self.chol, n, precision="highest",
                       preferred_element_type=self.chol.dtype)

    def update(self, sample, grad, tuning):
        return self

    def raise_ok(self) -> None:
        return None


# ---------------------------------------------------------------------------
# Adaptive metrics.
# ---------------------------------------------------------------------------


@pytree.dataclass
class QuadPotentialDiagAdapt:
    """Diagonal metric adapted from sample variances, dual-window Welford.

    Functional rewrite of reference ``quadpotential.py:148-245``. All of the
    reference's mutable attributes are pytree leaves; the window swap is a
    data-dependent ``where`` instead of Python control flow, so the update
    is scan/vmap/pjit-compatible.
    """

    var: jax.Array  # inverse-mass diagonal (the sample variance)
    stds: jax.Array
    inv_stds: jax.Array
    fg: WelfordVariance
    bg: WelfordVariance
    n_samples: jax.Array  # int32 scalar
    window: jax.Array  # int32 scalar, current adaptation window
    window_multiplier: float = pytree.field(pytree_node=False, default=1.0)

    @classmethod
    def create(
        cls,
        n: int,
        initial_mean=None,
        initial_diag=None,
        initial_weight: float = 0.0,
        adaptation_window: int = 101,
        adaptation_window_multiplier: float = 1.0,
        dtype=jnp.float32,
    ) -> "QuadPotentialDiagAdapt":
        if initial_mean is None:
            initial_mean = jnp.zeros(n, dtype)
        if initial_diag is None:
            # Reference defaults to identity with weight 1 (quadpotential.py:178-180).
            initial_diag = jnp.ones(n, dtype)
            initial_weight = 1.0
        initial_diag = jnp.asarray(initial_diag, dtype)
        fg = WelfordVariance.create(n, initial_mean, initial_diag, initial_weight, dtype)
        bg = WelfordVariance.create(n, dtype=dtype)
        return cls(
            var=initial_diag,
            stds=jnp.sqrt(initial_diag),
            inv_stds=1.0 / jnp.sqrt(initial_diag),
            fg=fg,
            bg=bg,
            n_samples=jnp.asarray(0, jnp.int32),
            window=jnp.asarray(adaptation_window, jnp.int32),
            window_multiplier=float(adaptation_window_multiplier),
        )

    def velocity(self, p: jax.Array) -> jax.Array:
        return self.var * p

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        vals = jax.random.normal(key, self.stds.shape, self.stds.dtype)
        return self.inv_stds * vals

    def update(self, sample: jax.Array, grad: jax.Array, tuning) -> "QuadPotentialDiagAdapt":
        """One adaptation step (no-op when ``tuning`` is False).

        Order matches reference ``quadpotential.py:231-245``: add sample to
        both windows, refresh the metric from the foreground, then swap
        windows when ``n_samples % window == 0``.
        """
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)
        var = fg.current_variance()
        stds = jnp.sqrt(var)

        swap = (self.n_samples > 0) & (jnp.mod(self.n_samples, self.window) == 0)
        fresh = WelfordVariance.create(self.var.shape[0], dtype=self.var.dtype)
        new_fg = tree_select(swap, bg, fg)
        new_bg = tree_select(swap, fresh, bg)
        new_window = jnp.where(
            swap,
            (self.window.astype(jnp.float32) * self.window_multiplier).astype(jnp.int32),
            self.window,
        )

        updated = QuadPotentialDiagAdapt(
            var=var,
            stds=stds,
            inv_stds=1.0 / stds,
            fg=new_fg,
            bg=new_bg,
            n_samples=self.n_samples + 1,
            window=new_window,
            window_multiplier=self.window_multiplier,
        )
        return tree_select(tuning, updated, self)

    def raise_ok(self) -> None:
        """Host-side check mirroring reference ``quadpotential.py:247-291``."""
        stds = np.asarray(jax.device_get(self.stds))
        if np.any(stds == 0):
            index = np.where(stds == 0)[0]
            raise ValueError(
                "Mass matrix contains zeros on the diagonal.\n"
                + "\n".join(f"The derivative of RV ravel()[{i}] is zero." for i in index)
            )
        if np.any(~np.isfinite(stds)):
            index = np.where(~np.isfinite(stds))[0]
            raise ValueError(
                "Mass matrix contains non-finite values on the diagonal.\n"
                + "\n".join(f"The derivative of RV ravel()[{i}] is non-finite." for i in index)
            )


@pytree.dataclass
class QuadPotentialFullAdapt:
    """Dense metric adapted from sample covariances (Stan-style).

    Functional rewrite of reference ``quadpotential.py:471-555``. The
    Cholesky refresh runs every ``update_window`` tuning steps; a failed
    (non-finite) factorization keeps the previous factor and latches
    ``chol_failed`` — the functional analogue of the reference's deferred
    ``_chol_error`` (``quadpotential.py:521-526,557-560``).
    """

    cov: jax.Array
    chol: jax.Array
    chol_failed: jax.Array  # bool scalar
    fg: WelfordCovariance
    bg: WelfordCovariance
    n_samples: jax.Array  # int32
    prev_update: jax.Array  # int32
    window: jax.Array  # int32, doubles each swap
    window_multiplier: float = pytree.field(pytree_node=False, default=2.0)
    update_window: int = pytree.field(pytree_node=False, default=1)
    regularize: bool = pytree.field(pytree_node=False, default=True)

    @classmethod
    def create(
        cls,
        n: int,
        initial_mean=None,
        initial_cov=None,
        initial_weight: float = 0.0,
        adaptation_window: int = 101,
        adaptation_window_multiplier: float = 2.0,
        update_window: int = 1,
        regularize: bool = True,
        dtype=jnp.float32,
    ) -> "QuadPotentialFullAdapt":
        if initial_mean is None:
            initial_mean = jnp.zeros(n, dtype)
        if initial_cov is None:
            initial_cov = jnp.eye(n, dtype=dtype)
            initial_weight = 1.0
        initial_cov = jnp.asarray(initial_cov, dtype)
        fg = WelfordCovariance.create(n, initial_mean, initial_cov, initial_weight, dtype)
        bg = WelfordCovariance.create(n, dtype=dtype)
        return cls(
            cov=initial_cov,
            chol=jnp.linalg.cholesky(initial_cov),
            chol_failed=jnp.asarray(False),
            fg=fg,
            bg=bg,
            n_samples=jnp.asarray(0, jnp.int32),
            prev_update=jnp.asarray(0, jnp.int32),
            window=jnp.asarray(adaptation_window, jnp.int32),
            window_multiplier=float(adaptation_window_multiplier),
            update_window=int(update_window),
            regularize=bool(regularize),
        )

    def velocity(self, p: jax.Array) -> jax.Array:
        # exact-f32: bf16 matmul inputs bias the sampled density (the kinetic
        # energy would no longer match the momentum-sampling density)
        return jnp.dot(self.cov, p, precision="highest",
                       preferred_element_type=self.cov.dtype)

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        n = jax.random.normal(key, (self.cov.shape[0],), self.cov.dtype)
        return jax.scipy.linalg.solve_triangular(self.chol.T, n, lower=False)

    def update(self, sample: jax.Array, grad: jax.Array, tuning) -> "QuadPotentialFullAdapt":
        """One adaptation step, matching reference ``quadpotential.py:528-555``."""
        delta = self.n_samples - self.prev_update
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)

        do_refresh = jnp.mod(delta + 1, self.update_window) == 0
        cov_new = fg.current_covariance()
        if self.regularize:
            # Stan-style shrinkage toward a small diagonal prior
            # (stan::mcmc::covar_adaptation): with w draws in the window,
            #   cov <- w/(w+5) * cov + 1e-3 * 5/(w+5) * I.
            # The reference reproduces Stan's *estimator* but drops this
            # regularization (quadpotential.py:471-560); at ndim ~ window
            # size the raw sample covariance is near-singular and per-chain
            # adapted runs ship visibly overdispersed posteriors.
            w = fg.n_samples
            shrink = w / (w + 5.0)
            eye = jnp.eye(cov_new.shape[0], dtype=cov_new.dtype)
            cov_new = shrink * cov_new + (1e-3 * (1.0 - shrink)) * eye
        chol_new = jnp.linalg.cholesky(cov_new)
        chol_ok = jnp.all(jnp.isfinite(chol_new))
        cov = jnp.where(do_refresh, cov_new, self.cov)
        chol = jnp.where(do_refresh & chol_ok, chol_new, self.chol)
        chol_failed = self.chol_failed | (do_refresh & ~chol_ok)

        swap = delta >= self.window
        fresh = WelfordCovariance.create(self.cov.shape[0], dtype=self.cov.dtype)
        new_fg = tree_select(swap, bg, fg)
        new_bg = tree_select(swap, fresh, bg)
        prev_update = jnp.where(swap, self.n_samples, self.prev_update)
        window = jnp.where(
            swap,
            (self.window.astype(jnp.float32) * self.window_multiplier).astype(jnp.int32),
            self.window,
        )

        updated = QuadPotentialFullAdapt(
            cov=cov,
            chol=chol,
            chol_failed=chol_failed,
            fg=new_fg,
            bg=new_bg,
            n_samples=self.n_samples + 1,
            prev_update=prev_update,
            window=window,
            window_multiplier=self.window_multiplier,
            update_window=self.update_window,
            regularize=self.regularize,
        )
        return tree_select(tuning, updated, self)

    def raise_ok(self) -> None:
        if bool(jax.device_get(jnp.any(self.chol_failed))):
            raise ValueError("Cholesky factorization of the adapted mass matrix failed.")


def _orthonormal_columns(A: jax.Array) -> jax.Array:
    """Orthonormalize the columns of ``A`` (CholeskyQR, positive-R sign).

    Computes the Q of a QR factorization as ``A L^{-T}`` with
    ``L = chol(AᵀA)`` — the sign convention (``diag(R) > 0``) is built
    in, keeping adaptation streams reproducible and letting the
    cross-chain pool average per-chain bases without cancellation.
    CholeskyQR over Householder ``jnp.linalg.qr`` because the per-chain
    update runs it *vmapped every draw*: two thin matmuls plus a k×k
    factorization are dense products, where batched ``geqrf`` is a
    sequence of small Householder steps. The κ(A)² conditioning loss is irrelevant here (A is a basis
    plus a bounded subspace-iteration step; the jitter floor guards the
    degenerate case).
    """
    G = jnp.dot(A.T, A, precision="highest",
                preferred_element_type=A.dtype)
    k = G.shape[0]
    # jitter keeps the factorization defined if A ever loses rank
    eps = 1e-6 * (jnp.trace(G) / k + 1.0)
    L = jnp.linalg.cholesky(G + eps * jnp.eye(k, dtype=G.dtype))
    return jax.scipy.linalg.solve_triangular(
        L, A.T, lower=True).T


def _effective_eigenvalues(
    s2: jax.Array, w: jax.Array, clip: float
) -> jax.Array:
    """Shrunk, clipped eigenvalue estimates from raw second moments.

    ``s2 / w`` estimates ``E[(vᵢᵀ z)²]`` — the covariance eigenvalue along
    direction ``vᵢ`` in standardized space, where the identity (``λ = 1``)
    is the "diagonal metric suffices" null. Shrinking toward 1 with a
    pseudo-count of 5 (the same weight Stan's covar_adaptation uses for
    its diagonal prior) keeps barely-observed directions inert, and the
    clip bounds the metric's condition number against early-tune noise.
    """
    raw = s2 / jnp.maximum(w, 1.0)
    shrunk = (w * raw + 5.0) / (w + 5.0)
    return jnp.clip(shrunk, 1.0 / clip, clip)


@pytree.dataclass
class QuadPotentialLowRankAdapt:
    """Spiked adaptive metric: ``Σ̂ = S (α(I−VVᵀ) + VΛVᵀ) S``.

    An extension beyond the reference's metric family (its options are
    diagonal or fully dense, ``/root/reference/littlemcmc/quadpotential.py``):
    the inverse mass is a diagonal ``S² = diag(var)`` (the reference's
    ``QuadPotentialDiagAdapt`` estimate, same dual-window Welford) plus a
    spiked correction in *standardized* space — ``V`` (``n×k``,
    orthonormal) spans the directions whose standardized variance ``λ``
    departs most from 1, and the scalar ``α`` rescales the residual
    bulk. The bulk factor matters: strong spikes inflate the position
    variances, so after standardization the *non*-spike directions land
    well below 1 — a shift no rank-``k ≪ n`` correction can absorb
    direction-by-direction, but one scalar fixes exactly (measured on a
    3-spike 24-d Gaussian: without ``α`` the mean tree depth stalls at
    the diagonal metric's 4.5; with it the dense metric's 3.0 is
    reachable). Every metric operation is ``O(nk)``:

    - ``velocity(p) = S (C (S p))`` with
      ``C^s x = α^s x + V((λ^s−α^s)·(Vᵀx))``,
    - ``sample_momentum`` draws ``p = S⁻¹ C^{−1/2} ζ`` (valid for
      orthonormal ``V``),

    so for large ``n`` it captures the dominant correlations the diagonal
    metric misses at a storage/compute cost that — unlike the dense
    metric's ``O(n²)`` — stays ``O(nk)`` per chain.

    Adaptation: the diagonal follows ``QuadPotentialDiagAdapt`` exactly
    (dual-window Welford, swap every ``window`` samples). The subspace is
    tracked per chain by one *shifted subspace-iteration* step per draw
    against a ring buffer of the last ``buffer_size`` positions —
    ``V ← orth(V + Zᵀ(ZV)/m)`` on the standardized buffer ``Z`` — and the
    eigenvalues by windowed second moments of the buffer projections,
    shrunk toward 1 (see :func:`_effective_eigenvalues`). (A rank-1 Oja
    stream was measured to leave the basis half-aligned after 600
    autocorrelated NUTS draws — principal-angle cosines ~0.65 — which
    mis-scales the metric enough to cause ~10% post-tune divergences;
    the buffered iteration aligns it.) Under cross-chain pooled
    adaptation (``sample(cross_chain_adapt=True)``, auto-promoted at
    vector chain counts) the basis is instead refreshed each tuning step
    from the cross-chain batch — ``V ← orth(V + Zᵀ(ZV)/C)`` — which
    converges in a handful of steps when hundreds of chains contribute
    samples
    (:func:`littlemcmc_tpu.parallel.cross_chain.cross_chain_potential_pool`).
    """

    # diagonal part — identical semantics to QuadPotentialDiagAdapt
    var: jax.Array  # (n,) inverse-mass diagonal (sample variance)
    stds: jax.Array
    inv_stds: jax.Array
    fg: WelfordVariance
    bg: WelfordVariance
    n_samples: jax.Array  # int32 scalar
    window: jax.Array  # int32 scalar
    # low-rank part, in standardized space
    vecs: jax.Array  # (n, k) orthonormal columns
    lam: jax.Array  # (k,) effective (shrunk, clipped) eigenvalues
    alpha: jax.Array  # scalar effective residual-bulk variance
    lam_w: jax.Array  # scalar second-moment weight
    lam_s2: jax.Array  # (k,) raw sum of squared projections
    alpha_s2: jax.Array  # scalar raw sum of residual squared norms
    buf: jax.Array  # (m, n) ring buffer of recent raw positions
    buf_pos: jax.Array  # int32 scalar, next write slot
    buf_fill: jax.Array  # int32 scalar, valid rows (saturates at m)
    window_multiplier: float = pytree.field(pytree_node=False, default=1.0)
    rank: int = pytree.field(pytree_node=False, default=8)
    lam_clip: float = pytree.field(pytree_node=False, default=100.0)
    buffer_size: int = pytree.field(pytree_node=False, default=32)

    @classmethod
    def create(
        cls,
        n: int,
        initial_mean=None,
        initial_diag=None,
        initial_weight: float = 0.0,
        adaptation_window: int = 101,
        adaptation_window_multiplier: float = 1.0,
        rank: int = 8,
        lam_clip: float = 100.0,
        buffer_size: int = 32,
        dtype=jnp.float32,
    ) -> "QuadPotentialLowRankAdapt":
        if initial_mean is None:
            initial_mean = jnp.zeros(n, dtype)
        if initial_diag is None:
            initial_diag = jnp.ones(n, dtype)
            initial_weight = 1.0
        initial_diag = jnp.asarray(initial_diag, dtype)
        fg = WelfordVariance.create(n, initial_mean, initial_diag,
                                    initial_weight, dtype)
        bg = WelfordVariance.create(n, dtype=dtype)
        k = max(1, min(int(rank), n))
        # deterministic orthonormal start (host-side, fixed seed): any
        # basis works — λ starts at 1, so the correction begins inert
        v0 = np.linalg.qr(
            np.random.RandomState(20240817).standard_normal((n, k))
        )[0].astype(np.dtype(dtype))
        return cls(
            var=initial_diag,
            stds=jnp.sqrt(initial_diag),
            inv_stds=1.0 / jnp.sqrt(initial_diag),
            fg=fg,
            bg=bg,
            n_samples=jnp.asarray(0, jnp.int32),
            window=jnp.asarray(adaptation_window, jnp.int32),
            vecs=jnp.asarray(v0),
            lam=jnp.ones(k, dtype),
            alpha=jnp.asarray(1.0, dtype),
            lam_w=jnp.asarray(0.0, dtype),
            lam_s2=jnp.zeros(k, dtype),
            alpha_s2=jnp.asarray(0.0, dtype),
            buf=jnp.zeros((int(buffer_size), n), dtype),
            buf_pos=jnp.asarray(0, jnp.int32),
            buf_fill=jnp.asarray(0, jnp.int32),
            window_multiplier=float(adaptation_window_multiplier),
            rank=k,
            lam_clip=float(lam_clip),
            buffer_size=int(buffer_size),
        )

    def _corr_matvec(self, x: jax.Array, power: jax.Array) -> jax.Array:
        """``C^s x`` for ``C = α(I−VVᵀ) + VΛVᵀ``: ``α^s x + V((λ^s−α^s)·(Vᵀx))``."""
        a = self.alpha ** power
        c = jnp.dot(self.vecs.T, x, precision="highest",
                    preferred_element_type=x.dtype)
        return a * x + jnp.dot(self.vecs, (self.lam ** power - a) * c,
                               precision="highest",
                               preferred_element_type=x.dtype)

    def velocity(self, p: jax.Array) -> jax.Array:
        return self.stds * self._corr_matvec(self.stds * p, 1.0)

    def kinetic(self, p: jax.Array, velocity: Optional[jax.Array] = None) -> jax.Array:
        if velocity is None:
            velocity = self.velocity(p)
        return 0.5 * jnp.dot(p, velocity)

    def sample_momentum(self, key: jax.Array) -> jax.Array:
        # p = S⁻¹ C^{−1/2} ζ  ⇒  cov(p) = S⁻¹C⁻¹S⁻¹ = Σ̂⁻¹ = M, matching
        # the kinetic energy ½ pᵀ Σ̂ p
        zeta = jax.random.normal(key, self.stds.shape, self.stds.dtype)
        return self.inv_stds * self._corr_matvec(zeta, -0.5)

    def update(self, sample: jax.Array, grad: jax.Array, tuning) -> "QuadPotentialLowRankAdapt":
        """One adaptation step (no-op when ``tuning`` is False).

        Diagonal bookkeeping matches :meth:`QuadPotentialDiagAdapt.update`
        (reference ``quadpotential.py:231-245``); the subspace takes one
        shifted subspace-iteration step against the standardized ring
        buffer (inert until the buffer has filled once), and the
        eigenvalue window decays by half at each foreground/background
        swap so stale-basis projections wash out.
        """
        fg = self.fg.add_sample(sample)
        bg = self.bg.add_sample(sample)
        var = fg.current_variance()
        stds = jnp.sqrt(var)
        inv_stds = 1.0 / stds

        swap = (self.n_samples > 0) & (jnp.mod(self.n_samples, self.window) == 0)
        fresh = WelfordVariance.create(self.var.shape[0], dtype=self.var.dtype)
        new_fg = tree_select(swap, bg, fg)
        new_bg = tree_select(swap, fresh, bg)
        new_window = jnp.where(
            swap,
            (self.window.astype(jnp.float32) * self.window_multiplier).astype(jnp.int32),
            self.window,
        )

        buf = self.buf.at[self.buf_pos].set(sample)
        buf_pos = jnp.mod(self.buf_pos + 1, self.buffer_size)
        # buf_fill (not n_samples) gates readiness: a state whose buffer
        # was reset (buf_fill = 0) refills before trusting the buffer rows
        # again, however many samples the Welford windows have seen
        buf_fill = jnp.minimum(self.buf_fill + 1, self.buffer_size)
        ready = buf_fill >= self.buffer_size

        m = float(self.buffer_size)
        Z = (buf - fg.mean) * inv_stds  # (m, n) standardized recent draws
        Y = jnp.dot(Z, self.vecs, precision="highest",
                    preferred_element_type=Z.dtype)  # (m, k)
        step = jnp.dot(Z.T, Y, precision="highest",
                       preferred_element_type=Z.dtype) / m
        vecs_new = _orthonormal_columns(self.vecs + step)
        vecs = jnp.where(ready, vecs_new, self.vecs)
        # project the NEW sample on the PREVIOUS basis: out-of-sample, so
        # the eigenvalue estimate avoids the PCA selection bias of scoring
        # the same draws that chose the directions (measured to inflate
        # tail eigenvalues ~3x when scored against the buffer itself)
        z = (sample - fg.mean) * inv_stds
        c2 = jnp.dot(self.vecs.T, z, precision="highest",
                     preferred_element_type=z.dtype) ** 2
        # residual bulk: same out-of-sample principle, one scalar for the
        # (n−k)-dim complement of the tracked subspace
        r2 = jnp.maximum(jnp.sum(z * z) - jnp.sum(c2), 0.0)
        decay = jnp.where(swap, 0.5, 1.0)
        gain = jnp.where(ready, 1.0, 0.0)
        lam_w = self.lam_w * decay + gain
        lam_s2 = self.lam_s2 * decay + gain * c2
        alpha_s2 = self.alpha_s2 * decay + gain * r2
        n_resid = max(self.var.shape[0] - self.rank, 1)

        updated = self.replace(
            var=var,
            stds=stds,
            inv_stds=inv_stds,
            fg=new_fg,
            bg=new_bg,
            n_samples=self.n_samples + 1,
            window=new_window,
            vecs=vecs,
            lam=_effective_eigenvalues(lam_s2, lam_w, self.lam_clip),
            alpha=_effective_eigenvalues(alpha_s2 / n_resid, lam_w,
                                         self.lam_clip),
            lam_w=lam_w,
            lam_s2=lam_s2,
            alpha_s2=alpha_s2,
            buf=buf,
            buf_pos=buf_pos,
            buf_fill=buf_fill,
        )
        return tree_select(tuning, updated, self)

    def raise_ok(self) -> None:
        """Host-side validity check (diagonal part mirrors reference ``:247-291``)."""
        stds = np.asarray(jax.device_get(self.stds))
        if np.any(stds == 0):
            index = np.where(stds == 0)[0]
            raise ValueError(
                "Mass matrix contains zeros on the diagonal.\n"
                + "\n".join(f"The derivative of RV ravel()[{i}] is zero." for i in index)
            )
        if np.any(~np.isfinite(stds)):
            index = np.where(~np.isfinite(stds))[0]
            raise ValueError(
                "Mass matrix contains non-finite values on the diagonal.\n"
                + "\n".join(f"The derivative of RV ravel()[{i}] is non-finite." for i in index)
            )
        lam = np.asarray(jax.device_get(self.lam))
        alpha = np.asarray(jax.device_get(self.alpha))
        if (np.any(~np.isfinite(lam)) or np.any(lam <= 0)
                or np.any(~np.isfinite(alpha)) or np.any(alpha <= 0)):
            raise ValueError(
                "Low-rank metric eigenvalues are non-finite or non-positive."
            )


Potential = Union[
    QuadPotentialDiag,
    QuadPotentialFull,
    QuadPotentialFullInv,
    QuadPotentialDiagAdapt,
    QuadPotentialFullAdapt,
    QuadPotentialLowRankAdapt,
]


def quad_potential(C, is_cov: bool) -> Potential:
    """Build a static metric from a scaling vector/matrix.

    Mirrors reference ``quadpotential.py:33-65`` minus the (broken) sparse
    branch: a 1-D ``C`` is a diagonal, 2-D is dense; ``is_cov`` selects
    covariance vs precision parameterization.
    """
    if type(C).__module__.startswith("scipy.sparse"):
        # The reference's sparse branch is dead code (it references an
        # undefined QuadPotentialSparse, ``quadpotential.py:49-53``);
        # sparse metrics are explicitly unsupported here.
        raise ValueError("Sparse scaling matrices are not supported.")
    C = jnp.asarray(C)
    partial_check_positive_definite(C)
    if C.ndim == 1:
        return QuadPotentialDiag.create(C if is_cov else 1.0 / C)
    if is_cov:
        return QuadPotentialFull.create(C)
    return QuadPotentialFullInv.create(C)


def isquadpotential(value) -> bool:
    """Check whether an object is one of the metric pytrees."""
    return isinstance(
        value,
        (
            QuadPotentialDiag,
            QuadPotentialFull,
            QuadPotentialFullInv,
            QuadPotentialDiagAdapt,
            QuadPotentialFullAdapt,
            QuadPotentialLowRankAdapt,
        ),
    )
