"""Sharded multi-device sampling tests on the 8-device virtual CPU mesh.

The reference's multiprocessing tests only assert "doesn't crash"
(``tests/test_sampling.py:91-100``, which is why its shared-memory bug
shipped); here the sharded path is held to the same *statistical* gates
as the single-device path, plus a determinism cross-check: sharding must
not change results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu.parallel import chain_mesh, shard_chains, cross_chain_potential_pool
from littlemcmc_tpu.quadpotential import QuadPotentialDiagAdapt, QuadPotentialFullAdapt
from tests.conftest import std_normal_logp_grad
from littlemcmc_tpu import models


def test_chain_mesh_shapes(eight_device_mesh):
    mesh = chain_mesh()
    assert mesh.size == 8
    assert mesh.axis_names == ("chains",)


def test_sharded_sampling_statistics(eight_device_mesh):
    trace, stats = lmc.sample(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=300,
        tune=300,
        chains=16,
        mesh=eight_device_mesh,
        random_seed=42,
        progressbar=False,
    )
    assert trace.shape == (16, 300, 2)
    assert abs(trace.mean()) < 0.1
    assert abs(trace.std() - 1.0) < 0.1


def test_sharded_equals_unsharded(eight_device_mesh):
    """Sharding over the mesh must not change the sampled values."""
    kwargs = dict(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=100,
        tune=100,
        chains=8,
        random_seed=11,
        progressbar=False,
    )
    t_plain, _ = lmc.sample(**kwargs)
    t_shard, _ = lmc.sample(mesh=eight_device_mesh, **kwargs)
    np.testing.assert_allclose(t_plain, t_shard, rtol=2e-4, atol=2e-5)


def test_cross_chain_pool_diag():
    """Pooled metric equals the variance of all chains' samples combined."""
    rng = np.random.RandomState(0)
    C, n = 4, 3
    pots = jax.vmap(
        lambda m: QuadPotentialDiagAdapt.create(n, initial_mean=m,
                                                initial_diag=jnp.ones(n),
                                                initial_weight=0.0)
    )(jnp.zeros((C, n)))
    # feed disjoint data to each chain (30 samples each)
    data = rng.randn(30, C, n).astype(np.float32) * 2.0
    tuning = jnp.asarray(True)
    for t in range(30):
        pots = jax.vmap(lambda p, x: p.update(x, x, tuning))(pots, jnp.asarray(data[t]))
    pooled = cross_chain_potential_pool(pots, tuning)
    # all chains share the same pooled metric
    v = np.asarray(pooled.var)
    assert np.allclose(v[0], v[1])
    all_samples = data.transpose(1, 0, 2).reshape(-1, n)
    np.testing.assert_allclose(v[0], all_samples.var(axis=0), rtol=0.05)


def test_cross_chain_pool_full():
    rng = np.random.RandomState(1)
    C, n = 4, 2
    pots = jax.vmap(
        lambda m: QuadPotentialFullAdapt.create(n, initial_mean=m,
                                                initial_cov=jnp.eye(n),
                                                initial_weight=0.0)
    )(jnp.zeros((C, n)))
    data = rng.randn(40, C, n).astype(np.float32)
    tuning = jnp.asarray(True)
    for t in range(40):
        pots = jax.vmap(lambda p, x: p.update(x, x, tuning))(pots, jnp.asarray(data[t]))
    pooled = cross_chain_potential_pool(pots, tuning)
    cov = np.asarray(pooled.cov)
    assert np.allclose(cov[0], cov[1])
    all_samples = data.transpose(1, 0, 2).reshape(-1, n)
    np.testing.assert_allclose(cov[0], np.cov(all_samples.T), rtol=0.1, atol=0.05)
    # no-op when not tuning
    same = cross_chain_potential_pool(pots, jnp.asarray(False))
    np.testing.assert_allclose(np.asarray(same.cov), np.asarray(pots.cov))


def test_cross_chain_adapt_end_to_end(eight_device_mesh):
    """Cross-chain adaptation samples correctly and shares the metric."""
    trace, stats, final = lmc.sample(
        logp_dlogp_func=std_normal_logp_grad,
        model_ndim=2,
        draws=200,
        tune=200,
        chains=8,
        mesh=eight_device_mesh,
        cross_chain_adapt=True,
        random_seed=5,
        progressbar=False,
        return_final_state=True,
    )
    assert abs(trace.mean()) < 0.15
    assert abs(trace.std() - 1.0) < 0.15
    var = np.asarray(final.potential.var)
    # every chain carries the same pooled metric
    assert np.allclose(var[0], var[-1])
    np.testing.assert_allclose(var[0], np.ones(2), rtol=0.3)


def test_shard_chains_helper(eight_device_mesh):
    x = {"a": jnp.zeros((16, 3)), "b": jnp.zeros((16,))}
    sharded = shard_chains(x, eight_device_mesh)
    assert len(sharded["a"].sharding.device_set) == 8


def test_model_axis_shards_dense_metric():
    """2-D mesh (chains x model): O(n^2) dense-metric state is row-sharded
    over the model axis (SURVEY.md §5 large-ndim scale axis; the
    reference holds the whole dense metric on one core,
    ``quadpotential.py:507-524``)."""
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU backend")
    m = models.CorrelatedGaussian(16)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("chains", "model"))
    common = dict(logp_dlogp_func=m.logp_grad, model_ndim=16, chains=8,
                  init="jitter+adapt_full", random_seed=5, progressbar=False,
                  return_final_state=True)

    # short horizon: sharded == replicated up to reduction-order noise
    tr_ref, _, fs_ref = lmc.sample(tune=4, draws=1, **common)
    tr_sh, st_sh, fs_sh = lmc.sample(tune=4, draws=1, mesh=mesh,
                                     model_axis="model", **common)
    spec = fs_sh.potential.cov.sharding.spec
    assert tuple(spec)[:2] == ("chains", "model")
    assert fs_sh.potential.fg.raw_cov.sharding.spec[1] == "model"
    np.testing.assert_allclose(np.asarray(tr_ref), np.asarray(tr_sh),
                               atol=1e-3)

    # longer horizon: statistically correct posterior on the sharded path
    tr, _, _ = lmc.sample(tune=200, draws=300, mesh=mesh,
                          model_axis="model", **common)
    vr = np.asarray(tr).reshape(-1, 16).var(0) / m.true_var
    assert vr.min() > 0.75 and vr.max() < 1.25


def test_model_axis_validation_errors():
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU backend")
    m = models.CorrelatedGaussian(10)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("chains", "model"))
    with pytest.raises(ValueError, match="divisible by the 'model'"):
        lmc.sample(logp_dlogp_func=m.logp_grad, model_ndim=10, chains=8,
                   init="adapt_full", mesh=mesh, model_axis="model",
                   tune=2, draws=2, progressbar=False)
    with pytest.raises(ValueError, match="no axis named"):
        lmc.sample(logp_dlogp_func=m.logp_grad, model_ndim=10, chains=8,
                   init="adapt_full", mesh=mesh, model_axis="nope",
                   tune=2, draws=2, progressbar=False)


def test_adapt_full_auto_promotes_to_pooled_at_vector_chain_counts():
    """cross_chain_adapt=None (default) promotes adapt_full to pooled
    adaptation at >= 128 chains (measured dominance —
    POOLED_VS_PERCHAIN.json); explicit False keeps the reference's
    per-chain estimator."""
    import jax.numpy as jnp

    from tests.conftest import std_normal_logp_grad

    kwargs = dict(
        logp_dlogp_func=std_normal_logp_grad, model_ndim=3, chains=128,
        tune=80, draws=20, init="jitter+adapt_full", random_seed=12,
        progressbar=False, return_final_state=True,
    )
    _, _, st_auto = lmc.sample(**kwargs)
    cov = np.asarray(st_auto.potential.cov)
    # pooled: every chain carries the same metric
    np.testing.assert_array_equal(cov[0], cov[1])
    np.testing.assert_array_equal(cov[0], cov[-1])

    _, _, st_pc = lmc.sample(cross_chain_adapt=False, **kwargs)
    cov_pc = np.asarray(st_pc.potential.cov)
    assert not np.array_equal(cov_pc[0], cov_pc[1])
