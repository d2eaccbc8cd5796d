"""Exact per-draw invariants of the NUTS and HMC kernels, over the model zoo
and every adaptive metric.

Each case runs ``sample()`` once (tuning draws kept) and checks properties
that hold draw by draw, whatever the posterior: a transition diverges
exactly when its energy error reaches ``Emax``, trees respect the depth
schedule, and tree sizes match the depth they report.
"""

import functools

import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu import models

MODELS = {
    "stdnormal": lambda: models.StandardNormal(3),
    "corrgauss": lambda: models.CorrelatedGaussian(6, rho=0.7, scale_range=(0.5, 2.0)),
    "funnel": lambda: models.NealsFunnel(4),
    "logistic": lambda: models.LogisticRegression(
        *models.german_credit_synthetic(60, 4), prior_scale=5.0),
    "eightschools": lambda: models.EightSchools(),
    "spiked": lambda: models.SpikedGaussian(8, rank=2, spikes=(9.0, 4.0)),
}
METRICS = ("diag", "full", "lowrank")
CASES = [(m, k) for m in MODELS for k in METRICS]

EMAX = 2.0  # low enough that early tuning draws diverge
MAX_DEPTH, EARLY_DEPTH = 4, 2
TUNE, DRAWS = 60, 40  # all tuning draws fall in the early-treedepth window


@functools.lru_cache(maxsize=None)
def _run(model_id: str, metric: str, sampler: str):
    model = MODELS[model_id]()
    if sampler == "nuts":
        step = lmc.NUTS(model_ndim=model.ndim, Emax=EMAX, max_treedepth=MAX_DEPTH,
                        early_max_treedepth=EARLY_DEPTH)
    else:
        step = lmc.HamiltonianMC(model_ndim=model.ndim, Emax=EMAX, max_steps=64)
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=model.ndim, chains=8,
        tune=TUNE, draws=DRAWS, init=f"jitter+adapt_{metric}", step=step,
        random_seed=3, discard_tuned_samples=False, progressbar=False,
        compute_convergence_checks=False)
    return trace, stats


@pytest.mark.parametrize("model_id,metric", CASES)
def test_nuts_diverges_iff_energy_error_reaches_emax(model_id, metric):
    _, stats = _run(model_id, metric, "nuts")
    div = np.asarray(stats["diverging"])
    mee = np.abs(np.asarray(stats["max_energy_error"]))
    np.testing.assert_array_equal(div, mee >= EMAX)


@pytest.mark.parametrize("model_id,metric", CASES)
def test_nuts_tree_size_and_depth_bounds(model_id, metric):
    trace, stats = _run(model_id, metric, "nuts")
    depth = np.asarray(stats["depth"])
    size = np.asarray(stats["tree_size"])
    tune = np.asarray(stats["tune"])
    assert trace.shape == (8, TUNE + DRAWS, MODELS[model_id]().ndim)
    assert tune[:, :TUNE].all() and not tune[:, TUNE:].any()
    assert (depth >= 1).all()
    assert (depth[:, :TUNE] <= EARLY_DEPTH).all()
    assert (depth <= MAX_DEPTH).all()
    assert (size >= 1).all() and (size <= 2.0 ** depth - 1).all()
    reached = np.asarray(stats["reached_max_treedepth"])
    assert not reached[:, :TUNE].any()
    assert (depth[reached] == MAX_DEPTH).all()
    assert not (reached & np.asarray(stats["diverging"])).any()


@pytest.mark.parametrize("model_id", list(MODELS))
def test_hmc_diverges_iff_energy_error_exceeds_emax(model_id):
    _, stats = _run(model_id, "diag", "hmc")
    div = np.asarray(stats["diverging"])
    np.testing.assert_array_equal(div, np.abs(np.asarray(stats["energy_error"])) > EMAX)
    n_steps = np.asarray(stats["n_steps"])
    assert (n_steps >= 1).all() and (n_steps <= 64).all()
    assert not (np.asarray(stats["accepted"]) & div).any()
