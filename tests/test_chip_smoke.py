"""``chip_smoke.py``'s phases at tiny sizes on the CPU, its gates, and its
refusal to run without a GPU."""

import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from littlemcmc_tpu import models  # noqa: E402


@pytest.fixture
def collected(monkeypatch):
    """Replace the gates by a recorder: at tiny sizes the posterior gates
    are Monte Carlo noise, so the tests read the values instead."""
    seen = {}

    def record(label, values, limits):
        seen[label] = {k: values.get(k) for k in limits}

    monkeypatch.setattr(chip_smoke, "require", record)
    return seen


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_a_cpu_platform(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_require_passes_values_inside_and_fails_outside(capsys):
    limits = {"a": (None, 1.0), "b": (0.5, 1.5)}
    chip_smoke.require("in", {"a": 1.0, "b": 0.5}, limits)
    assert "in: gates met" in capsys.readouterr().out
    for bad in ({"a": 1.1, "b": 1.0}, {"a": 0.0, "b": 2.0},
                {"a": float("nan"), "b": 1.0}, {"b": 1.0}):
        with pytest.raises(chip_smoke.GateFailure):
            chip_smoke.require("out", bad, limits)


def test_phase_models_meets_its_gates_at_a_small_batch():
    errors = chip_smoke.phase_models("cpu", n_points=16)
    assert set(errors) == {
        "gauss_logp", "gauss_grad", "logistic_logp", "logistic_grad",
        "user_default_logp", "user_default_grad",
        "user_highest_logp", "user_highest_grad"}
    assert all(0.0 <= e <= chip_smoke.MODEL_TOL for e in errors.values())


def test_run_sampler_reports_the_row_the_gates_read():
    row, final = chip_smoke.run_sampler(
        "cpu", "tiny", models.CorrelatedGaussian(4), chains=8, tune=60, draws=60,
        seed=1, devices=jax.devices()[:1], init="jitter+adapt_full",
        cross_chain_adapt=True)
    assert row["engine"] == "nuts_dense_pooled"
    for key in ("max_rhat", "divergence_rate", "var_ratio_mean", "min_ess_bulk",
                "sample_seconds", "transitions_per_second"):
        assert np.isfinite(row[key]), key
    assert row["peak_bytes_in_use"] is None  # the CPU keeps no allocator stats
    assert chip_smoke.pooled_spread(final) == 0.0


def test_one_card_runs_every_phase(collected):
    # 128 chains: the dense phase relies on auto-promotion to pooling
    chip_smoke.one_card("cpu", jax.devices()[:1], ndim=4, chains=128, tune=50,
                        draws=50, hmc_chains=16, hmc_tune=50, hmc_draws=50,
                        n_points=8)
    assert list(collected) == [
        "model evaluation", "flagship NUTS diag", "flagship NUTS pooled dense",
        "eight schools HMC", "live progress"]
    assert collected["flagship NUTS pooled dense"]["pooled_spread"] == 0.0
    assert collected["live progress"]["progress_lines"] >= 4


def test_four_cards_compares_the_mesh_with_one_device(collected):
    chip_smoke.four_cards("cpu", jax.devices()[:4], chains=16, model_chains=8,
                          tune=30, draws=30, ndim=4)
    pooled = collected["pooled metric"]
    assert pooled["pooled_spread_4_cards"] == 0.0
    assert pooled["pooled_spread_1_card"] == 0.0
    assert pooled["cov_rel_diff_same_state"] <= 1e-4
    assert collected["2 x 2 mesh"] == {"model_axis_in_spec": 1.0,
                                       "finite_trace": 1.0}
