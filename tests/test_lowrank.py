"""Tests for the low-rank-plus-diagonal adaptive metric.

``QuadPotentialLowRankAdapt`` is an extension beyond the reference's
metric family (diag or dense only, ``/root/reference/littlemcmc/
quadpotential.py``): ``Σ̂ = S (α(I−VVᵀ) + VΛVᵀ) S`` with O(nk) matvecs
and O(nk + mn) per-chain state, giving large-n runs most of the dense
metric's benefit at a cost that fits per-chain in VMEM. Coverage:

- exact linear-algebra invariants against a dense reconstruction
  (velocity, kinetic, momentum-sampling covariance, C^s identities);
- adaptation invariants (orthonormal basis, buffer warm-up gate,
  window-swap bookkeeping, no-op off tuning);
- end-to-end statistics on a spiked-covariance Gaussian, per-chain and
  cross-chain pooled, with a divergence gate;
- the ``adapt_lowrank`` init-string plumbing and the cross-chain pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu.quadpotential import QuadPotentialLowRankAdapt
from littlemcmc_tpu.parallel import cross_chain_potential_pool


def _spiked_sigma(n: int, k: int, seed: int = 3, lams=(64.0, 25.0, 9.0)):
    """Covariance S(I + V(Λ−I)Vᵀ)S with k spike directions."""
    rng = np.random.RandomState(seed)
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    lam = np.asarray(lams[:k], np.float64)
    D = np.exp(rng.uniform(-2, 2, n))
    S = np.diag(np.sqrt(D))
    return S @ (np.eye(n) + V @ np.diag(lam - 1) @ V.T) @ S


def _arbitrary_state(n=12, k=3, seed=0, alpha=0.37):
    """A LowRank potential pushed away from its inert initial state."""
    rng = np.random.RandomState(seed)
    V = np.linalg.qr(rng.standard_normal((n, k)))[0].astype(np.float32)
    lam = np.linspace(9.0, 0.25, k).astype(np.float32)
    stds = np.exp(rng.standard_normal(n)).astype(np.float32)
    pot = QuadPotentialLowRankAdapt.create(n, rank=k)
    pot = pot.replace(
        vecs=jnp.asarray(V), lam=jnp.asarray(lam),
        alpha=jnp.asarray(alpha, jnp.float32),
        stds=jnp.asarray(stds), inv_stds=1.0 / jnp.asarray(stds),
        var=jnp.asarray(stds ** 2),
    )
    Sigma = np.diag(stds) @ (
        alpha * (np.eye(n) - V @ V.T) + V @ np.diag(lam) @ V.T
    ) @ np.diag(stds)
    return pot, Sigma


def test_velocity_kinetic_match_dense_reconstruction():
    pot, Sigma = _arbitrary_state()
    rng = np.random.RandomState(1)
    for _ in range(3):
        p = rng.standard_normal(Sigma.shape[0]).astype(np.float32)
        v = np.asarray(pot.velocity(jnp.asarray(p)))
        np.testing.assert_allclose(v, Sigma @ p, rtol=1e-4, atol=1e-4)
        kin = float(pot.kinetic(jnp.asarray(p)))
        assert np.isclose(kin, 0.5 * p @ Sigma @ p, rtol=1e-4)


def test_momentum_covariance_is_inverse_metric():
    # p = S⁻¹C^{−1/2}ζ must have covariance Σ̂⁻¹ — the density the kinetic
    # energy ½pᵀΣ̂p integrates against; a mismatch biases every posterior
    pot, Sigma = _arbitrary_state()
    keys = jax.random.split(jax.random.key(1), 200_000)
    ps = np.asarray(jax.vmap(pot.sample_momentum)(keys))
    emp = np.cov(ps.T)
    Minv = np.linalg.inv(Sigma)
    assert np.abs(emp - Minv).max() / np.abs(Minv).max() < 0.05


def test_corr_power_identities():
    # C^{1/2} C^{−1/2} = I and C^1 = C, via the matvec helper
    pot, _ = _arbitrary_state()
    x = jnp.asarray(np.random.RandomState(2).standard_normal(12), jnp.float32)
    y = pot._corr_matvec(pot._corr_matvec(x, -0.5), 0.5)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-4,
                               atol=1e-5)


def test_update_invariants():
    n, k, m = 10, 3, 8
    pot = QuadPotentialLowRankAdapt.create(
        n, initial_weight=10.0, rank=k, buffer_size=m)
    rng = np.random.RandomState(0)
    v0 = np.asarray(pot.vecs)

    # warm-up: basis frozen and eigenvalues inert until the buffer fills
    for i in range(m - 1):
        pot = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                         jnp.zeros(n, jnp.float32), jnp.asarray(True))
    np.testing.assert_allclose(np.asarray(pot.vecs), v0)
    np.testing.assert_allclose(np.asarray(pot.lam), 1.0)
    np.testing.assert_allclose(np.asarray(pot.alpha), 1.0)
    assert float(pot.lam_w) == 0.0

    # after warm-up the basis moves but stays orthonormal
    for i in range(2 * m):
        pot = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                         jnp.zeros(n, jnp.float32), jnp.asarray(True))
    V = np.asarray(pot.vecs)
    assert not np.allclose(V, v0)
    np.testing.assert_allclose(V.T @ V, np.eye(k), atol=1e-5)
    assert float(pot.lam_w) > 0.0
    lam = np.asarray(pot.lam)
    assert np.all(lam > 0) and np.all(np.isfinite(lam))
    alpha = float(pot.alpha)
    assert alpha > 0 and np.isfinite(alpha)

    # off tuning: strict no-op
    pot2 = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                      jnp.zeros(n, jnp.float32), jnp.asarray(False))
    for a, b in zip(jax.tree.leaves(pot2), jax.tree.leaves(pot)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    pot.raise_ok()  # healthy state must pass


def test_init_string_plumbing():
    start, step = lmc.init_nuts(
        logp_dlogp_func=lambda q: (-0.5 * jnp.sum(q ** 2), -q),
        model_ndim=6, init="adapt_lowrank", random_seed=1)
    assert isinstance(step.potential, QuadPotentialLowRankAdapt)
    with pytest.raises(ValueError, match="Unknown initializer"):
        lmc.init_nuts(logp_dlogp_func=lambda q: (-0.5 * jnp.sum(q ** 2), -q),
                      model_ndim=6, init="adapt_banana")


def test_cross_chain_pool_lowrank():
    n, k, C = 8, 2, 16
    base = QuadPotentialLowRankAdapt.create(n, initial_weight=10.0, rank=k)
    pots = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (C,) + jnp.shape(x)), base)
    rng = np.random.RandomState(5)
    samples = jnp.asarray(rng.standard_normal((C, n)), jnp.float32)

    pooled = cross_chain_potential_pool(pots, jnp.asarray(True),
                                        samples=samples)
    # every chain carries the identical pooled metric
    for leaf_name in ("var", "stds", "vecs", "lam", "alpha"):
        leaf = np.asarray(getattr(pooled, leaf_name))
        np.testing.assert_allclose(leaf, np.broadcast_to(leaf[0], leaf.shape),
                                   rtol=1e-6)
    V = np.asarray(pooled.vecs[0])
    np.testing.assert_allclose(V.T @ V, np.eye(k), atol=1e-5)

    # tuning=False is a strict no-op
    same = cross_chain_potential_pool(pots, jnp.asarray(False),
                                      samples=samples)
    for a, b in zip(jax.tree.leaves(same), jax.tree.leaves(pots)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # without samples the low-rank part is untouched, the diag still pools
    diag_only = cross_chain_potential_pool(pots, jnp.asarray(True))
    np.testing.assert_array_equal(np.asarray(diag_only.vecs),
                                  np.asarray(pots.vecs))


@pytest.mark.parametrize("pooled", [False, True])
def test_lowrank_e2e_spiked_gaussian(pooled):
    """Moments within MC error and zero-ish divergences on a spiked target.

    The spiked covariance is the configuration the low-rank metric
    exists for: a diagonal metric leaves condition λmax≈15 in
    standardized space, the rank-k correction removes it.
    """
    n = 24
    Sigma = _spiked_sigma(n, 3)
    Prec = jnp.asarray(np.linalg.inv(Sigma), jnp.float32)

    def logp_grad(q):
        g = -Prec @ q
        return 0.5 * jnp.dot(q, g), g

    trace, stats = lmc.sample(
        logp_dlogp_func=logp_grad, model_ndim=n, tune=500, draws=400,
        chains=32, random_seed=11, init="jitter+adapt_lowrank",
        cross_chain_adapt=pooled, progressbar=False)
    flat = np.asarray(trace).reshape(-1, n)
    true_sd = np.sqrt(np.diag(Sigma))
    sd_ratio = flat.std(axis=0) / true_sd
    assert sd_ratio.min() > 0.9 and sd_ratio.max() < 1.1, sd_ratio
    assert np.abs(flat.mean(axis=0) / true_sd).max() < 0.12
    assert float(np.mean(np.asarray(stats["diverging"]))) < 0.02


def test_lowrank_beats_diag_on_spiked_target():
    """The point of the metric: shallower trees than adapt_diag on a
    target whose standardized covariance has large spike eigenvalues."""
    n = 24
    Sigma = _spiked_sigma(n, 3, lams=(400.0, 100.0, 25.0))
    Prec = jnp.asarray(np.linalg.inv(Sigma), jnp.float32)

    def logp_grad(q):
        g = -Prec @ q
        return 0.5 * jnp.dot(q, g), g

    depths = {}
    for init in ("jitter+adapt_diag", "jitter+adapt_lowrank"):
        _, stats = lmc.sample(
            logp_dlogp_func=logp_grad, model_ndim=n, tune=500, draws=300,
            chains=32, random_seed=11, init=init, cross_chain_adapt=False,
            progressbar=False)
        depths[init] = float(np.mean(np.asarray(stats["depth"])))
    assert depths["jitter+adapt_lowrank"] < depths["jitter+adapt_diag"] - 0.5, depths


def test_pooled_lowrank_sharded_equals_unsharded(eight_device_mesh):
    """The pooled subspace iteration under a chains-sharded mesh: the
    cross-chain ``Zᵀ(ZV)`` products become XLA collectives. Exact match
    only holds over a short horizon (cross-device reduction order
    differs in the last ulps and NUTS branching amplifies it — same
    protocol as ``test_model_axis_shards_dense_metric``); the long
    horizon gates statistics and the pooled-state invariants."""
    n = 8
    Sigma = _spiked_sigma(n, 2, lams=(25.0, 9.0))
    Prec = jnp.asarray(np.linalg.inv(Sigma), jnp.float32)

    def logp_grad(q):
        g = -Prec @ q
        return 0.5 * jnp.dot(q, g), g

    common = dict(
        logp_dlogp_func=logp_grad, model_ndim=n, chains=16, random_seed=13,
        init="jitter+adapt_lowrank", cross_chain_adapt=True,
        progressbar=False, return_final_state=True,
    )

    # short horizon: sharded == replicated up to reduction-order noise
    t_plain, _, _ = lmc.sample(tune=4, draws=1, **common)
    t_shard, _, _ = lmc.sample(tune=4, draws=1, mesh=eight_device_mesh,
                               **common)
    np.testing.assert_allclose(np.asarray(t_plain), np.asarray(t_shard),
                               atol=1e-3)

    # longer horizon: correct posterior + replicated pooled metric
    tr, stats, final = lmc.sample(tune=300, draws=300,
                                  mesh=eight_device_mesh, **common)
    flat = np.asarray(tr).reshape(-1, n)
    sd_ratio = flat.std(axis=0) / np.sqrt(np.diag(Sigma))
    assert sd_ratio.min() > 0.85 and sd_ratio.max() < 1.15, sd_ratio
    assert float(np.mean(np.asarray(stats["diverging"]))) < 0.02
    vecs = np.asarray(final.potential.vecs)
    np.testing.assert_allclose(vecs[0], vecs[-1], atol=1e-6)
    V = vecs[0]
    np.testing.assert_allclose(V.T @ V, np.eye(V.shape[1]), atol=1e-5)


def test_hmc_with_lowrank_metric():
    """Classic HMC consumes the metric duck-typed on the XLA path."""
    n = 12
    Sigma = _spiked_sigma(n, 2, lams=(25.0, 9.0))
    Prec = jnp.asarray(np.linalg.inv(Sigma), jnp.float32)

    def logp_grad(q):
        g = -Prec @ q
        return 0.5 * jnp.dot(q, g), g

    pot = QuadPotentialLowRankAdapt.create(n, initial_weight=10.0, rank=2)
    step = lmc.HamiltonianMC(model_ndim=n, potential=pot, max_steps=32)
    trace, stats = lmc.sample(
        logp_dlogp_func=logp_grad, model_ndim=n, tune=400, draws=400,
        chains=16, random_seed=3, step=step, progressbar=False)
    flat = np.asarray(trace).reshape(-1, n)
    sd_ratio = flat.std(axis=0) / np.sqrt(np.diag(Sigma))
    assert sd_ratio.min() > 0.85 and sd_ratio.max() < 1.15, sd_ratio
    assert float(np.mean(np.asarray(stats["diverging"]))) < 0.02


def test_lowrank_checkpoint_resume_bit_identical(tmp_path):
    """The new potential leaves (basis, buffer, int32 ring pointer)
    round-trip through Orbax checkpointing; resume is bit-identical."""
    ckpt = str(tmp_path / "ckpt")
    n = 6
    Prec = jnp.asarray(np.linalg.inv(_spiked_sigma(n, 2, lams=(9.0, 4.0))),
                       jnp.float32)

    def logp_grad(q):
        g = -Prec @ q
        return 0.5 * jnp.dot(q, g), g

    kwargs = dict(logp_dlogp_func=logp_grad, model_ndim=n, draws=60, tune=40,
                  chains=8, random_seed=17, init="adapt_lowrank",
                  cross_chain_adapt=False, progressbar=False)
    t_full, _ = lmc.sample(checkpoint_dir=ckpt, checkpoint_every=30, **kwargs)
    t_resumed, _ = lmc.sample(checkpoint_dir=ckpt, resume=True, **kwargs)
    assert t_resumed.shape == (8, 10, n)
    np.testing.assert_array_equal(np.asarray(t_resumed),
                                  np.asarray(t_full)[:, -10:, :])


def test_buffer_staleness_gate_after_fused_chunk():
    """A state whose ring buffer was reset (buf_fill zeroed) while
    n_samples stays large must refill the buffer before the per-chain
    update moves the basis again."""
    n, k, m = 8, 2, 6
    pot = QuadPotentialLowRankAdapt.create(
        n, initial_weight=10.0, rank=k, buffer_size=m)
    rng = np.random.RandomState(1)
    for _ in range(2 * m):
        pot = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                         jnp.zeros(n, jnp.float32), jnp.asarray(True))
    # counters advanced, buffer reset
    pot = pot.replace(n_samples=jnp.asarray(500, jnp.int32),
                      buf_fill=jnp.zeros_like(pot.buf_fill),
                      buf=jnp.zeros_like(pot.buf))
    v_frozen = np.asarray(pot.vecs)
    for i in range(m - 1):
        pot = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                         jnp.zeros(n, jnp.float32), jnp.asarray(True))
        np.testing.assert_array_equal(np.asarray(pot.vecs), v_frozen)
    # buffer refilled: the basis moves again
    pot = pot.update(jnp.asarray(rng.standard_normal(n), jnp.float32),
                     jnp.zeros(n, jnp.float32), jnp.asarray(True))
    assert not np.allclose(np.asarray(pot.vecs), v_frozen)
