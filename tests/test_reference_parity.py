"""Statistical parity against the actual reference implementation.

Runs eigenfoo/littlemcmc's *sequential* path (its only correct mode —
SURVEY.md §2) from /root/reference on CPU, and compares posterior moments
and sampler-statistics distributions with littlemcmc_tpu on the same
targets. Gates are MC-error-aware, not bitwise (different PRNGs).

Skipped automatically if the reference checkout is unavailable.
"""

import os
import sys
import types

import numpy as np
import pytest

import littlemcmc_tpu as lmc

REFERENCE_PATH = "/root/reference"


@pytest.fixture(scope="module")
def reference():
    if not os.path.isdir(os.path.join(REFERENCE_PATH, "littlemcmc")):
        pytest.skip("reference checkout not available")

    # Shim fastprogress (not installed) before importing the reference.
    class _Bar:
        def __init__(self, it, total=None, display=True):
            self._it = it
            self.comment = ""

        def __iter__(self):
            return iter(self._it)

    fp = types.ModuleType("fastprogress")
    fpfp = types.ModuleType("fastprogress.fastprogress")
    fpfp.progress_bar = _Bar
    fp.fastprogress = fpfp
    sys.modules.setdefault("fastprogress", fp)
    sys.modules.setdefault("fastprogress.fastprogress", fpfp)
    if not hasattr(np, "bool"):
        np.bool = np.bool_  # removed in numpy>=1.24; the reference uses it

    sys.path.insert(0, REFERENCE_PATH)
    import littlemcmc as ref

    yield ref
    sys.path.remove(REFERENCE_PATH)


def _run_reference(ref, logp_dlogp, ndim, tune=400, draws=600, chains=2, seed=1):
    trace, stats = ref.sample(
        logp_dlogp_func=logp_dlogp,
        model_ndim=ndim,
        tune=tune,
        draws=draws,
        chains=chains,
        cores=1,
        progressbar=False,
        random_seed=seed,
    )
    return np.asarray(trace), stats


def test_std_normal_moments_and_stats_match(reference):
    """1D standard normal: moments and NUTS stats distributions line up."""
    import jax.numpy as jnp

    def ref_model(x):
        return -0.5 * np.sum(x ** 2), -x

    def ours_model(x):
        return -0.5 * jnp.sum(x ** 2), -x

    ref_trace, ref_stats = _run_reference(reference, ref_model, 1)
    ours_trace, ours_stats = lmc.sample(
        logp_dlogp_func=ours_model, model_ndim=1, tune=400, draws=600,
        chains=2, random_seed=1, progressbar=False,
    )

    # Posterior moments within MC error of each other (~1200 draws each).
    assert abs(ref_trace.mean() - ours_trace.mean()) < 0.15
    assert abs(ref_trace.std() - ours_trace.std()) < 0.12

    # Sampler-statistic distributions: acceptance and tree size regimes.
    assert abs(ref_stats["mean_tree_accept"].mean()
               - ours_stats["mean_tree_accept"].mean()) < 0.08
    assert abs(ref_stats["depth"].mean() - ours_stats["depth"].mean()) < 0.8
    assert abs(ref_stats["tree_size"].mean() - ours_stats["tree_size"].mean()) < 2.0
    # Step-size adaptation lands in the same regime.
    ref_eps = ref_stats["step_size"][:, -1]
    ours_eps = ours_stats["step_size"][:, -1]
    assert 0.3 < ours_eps.mean() / ref_eps.mean() < 3.0


def test_correlated_gaussian_moments_match(reference):
    """5-d correlated Gaussian, diag adaptation, both samplers."""
    import jax.numpy as jnp
    from littlemcmc_tpu.models import CorrelatedGaussian

    m = CorrelatedGaussian(5, rho=0.7, scale_range=(0.5, 2.0))
    prec = m.prec

    def ref_model(x):
        g = -prec @ x
        return 0.5 * x @ g, g

    ref_trace, _ = _run_reference(reference, ref_model, 5, tune=500, draws=800)
    ours_trace, _ = lmc.sample(
        logp_dlogp_func=m.logp_grad, model_ndim=5, tune=500, draws=800,
        chains=2, random_seed=2, progressbar=False,
    )

    ref_var = ref_trace.reshape(-1, 5).var(axis=0)
    ours_var = ours_trace.reshape(-1, 5).var(axis=0)
    # Both recover the true marginal variances within sampling error...
    np.testing.assert_allclose(ours_var, m.true_var, rtol=0.5)
    # ...and agree with each other.
    np.testing.assert_allclose(ours_var, ref_var, rtol=0.6)
    assert abs(ref_trace.mean() - ours_trace.mean()) < 0.4


def test_hmc_parity(reference):
    """Classic HMC: acceptance and moments in the same regime."""
    import jax.numpy as jnp

    def ref_model(x):
        return -0.5 * np.sum(x ** 2), -x

    def ours_model(x):
        return -0.5 * jnp.sum(x ** 2), -x

    ref_step_cls = reference.HamiltonianMC

    ref_trace, ref_stats = reference.sample(
        logp_dlogp_func=ref_model, model_ndim=1, tune=400, draws=600,
        chains=2, cores=1, progressbar=False, random_seed=3,
        step=ref_step_cls(logp_dlogp_func=ref_model, model_ndim=1),
    )
    ours_trace, ours_stats = lmc.sample(
        logp_dlogp_func=ours_model, model_ndim=1, tune=400, draws=600,
        chains=2, random_seed=3, progressbar=False,
        step=lmc.HamiltonianMC(model_ndim=1),
    )
    ref_trace = np.asarray(ref_trace)
    assert abs(ref_trace.std() - ours_trace.std()) < 0.15
    assert abs(ref_stats["accept"].mean() - ours_stats["accept"].mean()) < 0.25
    assert abs(float(np.mean(ref_stats["accepted"]))
               - float(ours_stats["accepted"].mean())) < 0.2
