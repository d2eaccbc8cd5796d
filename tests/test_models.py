"""Model zoo tests: analytic gradients vs autodiff, and posterior recovery."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu import models


@pytest.mark.parametrize(
    "model",
    [
        models.StandardNormal(3),
        models.CorrelatedGaussian(8, rho=0.7),
        models.NealsFunnel(5),
        models.LogisticRegression(*models.german_credit_synthetic(100, 6)),
        models.EightSchools(),
        models.LinearRegression(20),
        models.SpikedGaussian(16, rank=2, spikes=(25.0, 9.0)),
    ],
    ids=["stdnormal", "corrgauss", "funnel", "logistic", "8schools", "linreg",
         "spiked"],
)
def test_analytic_grad_matches_autodiff(model):
    key = jax.random.key(0)
    q = jax.random.normal(key, (model.ndim,)) * 0.5
    logp_a, grad_a = model.logp_grad(q)
    logp_b, grad_b = jax.value_and_grad(model.logp)(q)
    np.testing.assert_allclose(float(logp_a), float(logp_b), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(grad_a), np.asarray(grad_b), rtol=1e-3, atol=1e-4)


def test_correlated_gaussian_recovery_diag_vs_full():
    """BASELINE config 2 (scaled down): full adaptation should handle the
    correlated target; recovered variances must match the true diagonal."""
    model = models.CorrelatedGaussian(5, rho=0.8, scale_range=(0.5, 2.0))
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad,
        model_ndim=model.ndim,
        draws=800,
        tune=800,
        chains=4,
        init="jitter+adapt_full",
        random_seed=42,
        progressbar=False,
    )
    var = trace.reshape(-1, model.ndim).var(axis=0)
    np.testing.assert_allclose(var, model.true_var, rtol=0.4)
    assert abs(trace.mean()) < 0.3


def test_funnel_produces_divergences_or_depth():
    """The centered funnel must stress the sampler: either divergences
    appear or deep trees are needed (this is the point of config 3)."""
    model = models.NealsFunnel(10)
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad,
        model_ndim=model.ndim,
        draws=300,
        tune=300,
        chains=4,
        random_seed=0,
        progressbar=False,
    )
    assert trace.shape == (4, 300, 10)
    assert stats["diverging"].sum() > 0 or stats["depth"].mean() > 4


def test_eight_schools_samples():
    model = models.EightSchools()
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad,
        model_ndim=model.ndim,
        draws=400,
        tune=400,
        chains=4,
        random_seed=1,
        progressbar=False,
    )
    mu = trace[:, :, 0]
    # Posterior mean of mu is around 4-9 for this data
    assert 0.0 < mu.mean() < 12.0


def test_logistic_regression_recovers_signal():
    X, y = models.german_credit_synthetic(400, 8)
    model = models.LogisticRegression(X, y, prior_scale=5.0)
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad,
        model_ndim=model.ndim,
        draws=400,
        tune=400,
        chains=2,
        random_seed=2,
        progressbar=False,
    )
    # MAP-ish check: posterior mean predicts labels better than chance
    beta = trace.reshape(-1, model.ndim).mean(axis=0)
    Xb = np.concatenate([np.ones((X.shape[0], 1)), X], axis=1)
    acc = ((Xb @ beta > 0) == (y > 0.5)).mean()
    assert acc > 0.65
    assert stats["diverging"].mean() < 0.05


def test_non_centered_funnel_transform_and_sampling():
    """Non-centered funnel: trivial sampled geometry, funnel via transform."""
    import numpy as np
    import jax.numpy as jnp
    import littlemcmc_tpu as lmc
    from littlemcmc_tpu.models import NonCenteredFunnel

    model = NonCenteredFunnel(5, scale=3.0)
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=5, draws=400, tune=300,
        chains=8, random_seed=0, progressbar=False,
    )
    # sampled (tilde) space is iid standard normal
    tr = np.asarray(trace)
    assert np.abs(tr.mean(axis=(0, 1))).max() < 0.2
    assert np.abs(tr.std(axis=(0, 1)) - 1.0).max() < 0.2
    assert np.asarray(stats["diverging"]).mean() < 0.005
    # transformed draws reproduce the funnel's heavy-tailed x marginals
    fx = np.asarray(model.transform(jnp.asarray(tr)))
    v = fx[..., 0]
    assert abs(v.std() - 3.0) < 0.5
    assert fx[..., 1:].std() > 2.0  # much wider than the tilde space


def test_hierarchical_regression_lowers_and_recovers():
    """Group-indexed hierarchical regression (models/hierarchical.py): the
    zoo's gather/scatter model, written with ``jnp.take`` and autodiff,
    must recover the fixed effects."""
    model = models.HierarchicalRegression(n_groups=8, n_rows=256,
                                          n_features=4, seed=3)
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
        chains=8, tune=400, draws=600, random_seed=5, progressbar=False,
        target_accept=0.9,
    )
    tr = np.asarray(trace).reshape(-1, model.ndim)
    b_hat = tr[:, 2:2 + model.n_features].mean(axis=0)
    np.testing.assert_allclose(b_hat, model.true_b, atol=0.12)
    mu_hat = tr[:, 0].mean()
    assert abs(mu_hat - model.true_mu) < 0.5  # partial pooling: wide tol
    assert np.asarray(stats["diverging"]).mean() < 0.02


def test_spiked_gaussian_structured_precision_exact():
    """The O(nk) structured precision matches a dense reconstruction."""
    m = models.SpikedGaussian(24, rank=3, spikes=(100.0, 25.0, 9.0))
    S = np.diag(m.scales)
    Sigma = S @ (np.eye(24) + m.V @ np.diag(m.lam - 1) @ m.V.T) @ S
    q = np.random.RandomState(1).standard_normal(24).astype(np.float32)
    lp, g = m.logp_grad(jnp.asarray(q))
    g_ref = -np.linalg.solve(Sigma, q)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-3, atol=1e-4)
    assert np.isclose(float(lp), 0.5 * q @ g_ref, rtol=1e-3)
    lps, gs = m.batched_logp_grad(jnp.asarray(q[None]))
    np.testing.assert_allclose(np.asarray(gs[0]), g_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.diag(Sigma), m.true_var, rtol=1e-6)


def test_stochastic_volatility_samples_and_recovers():
    """SV (T=64): globals converge, latent path recovered, few divergences."""
    from littlemcmc_tpu.utils.diagnostics import split_rhat

    m = models.StochasticVolatility(T=64)
    trace, stats = lmc.sample(
        logp_dlogp_func=m.logp_grad, model_ndim=m.ndim, tune=600, draws=600,
        chains=8, random_seed=4, target_accept=0.95, progressbar=False)
    tr = np.asarray(trace)
    flat = tr.reshape(-1, m.ndim)
    phi = np.tanh(flat[:, 0])
    # persistence recovered within posterior spread (weakly identified at
    # T=64, so the gates are deliberately loose)
    assert abs(phi.mean() - m.true_phi) < 3 * phi.std() + 0.02
    rh = max(float(split_rhat(tr[:, :, i])) for i in range(3))
    assert rh < 1.06, rh
    assert float(np.mean(np.asarray(stats["diverging"]))) < 0.02
    hbar = flat[:, 3:].mean(axis=0)
    assert np.corrcoef(hbar, m.h_true)[0, 1] > 0.85
