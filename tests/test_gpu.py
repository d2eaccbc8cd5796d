"""Tests that run only on an NVIDIA GPU (``LMC_TEST_PLATFORM=gpu python -m
pytest -m gpu``); on the CPU they skip."""

import os
import sys

import numpy as np
import pytest

import littlemcmc_tpu as lmc
from littlemcmc_tpu import models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.gpu


def test_model_evaluation_matches_float64_on_the_card(gpu_devices):
    import chip_smoke

    errors = chip_smoke.phase_models(gpu_devices[0].device_kind, n_points=256)
    assert errors["gauss_grad"] <= chip_smoke.MODEL_TOL


def test_flagship_width_sample_on_the_card(gpu_devices):
    model = models.CorrelatedGaussian(100)
    report = {}
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=100, chains=1024, tune=100,
        draws=100, init="jitter+adapt_full", random_seed=0, progressbar=False,
        perf_report=report)
    assert report["engine"] == "nuts_dense_pooled"
    assert trace.shape == (1024, 100, 100) and np.isfinite(trace).all()
    assert stats["diverging"].mean() < 0.01
