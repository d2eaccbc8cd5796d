"""The benchmark suite's quality gates (``scripts/bench_suite.py``), on
synthetic rows: each gate passes a row inside it and fails one outside,
and a row whose config crashed fails."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from bench_suite import gate_violations  # noqa: E402

GOOD = {"engine": "nuts_diag", "max_rhat": 1.002, "divergence_rate": 0.0,
        "var_ratio_mean": 1.001}


def _row(**kw):
    return dict(GOOD, **kw)


def test_rhat_gates():
    bad = gate_violations({
        "ok": _row(max_rhat=1.05),
        "high": _row(max_rhat=1.06),
        "stress_ok": _row(max_rhat=1.3, stress_config=True),
        "stress_high": _row(max_rhat=1.4, stress_config=True),
    })
    assert set(bad) == {"high", "stress_high"}


def test_divergence_gates():
    bad = gate_violations({
        "ok": _row(divergence_rate=0.02),
        "high": _row(divergence_rate=0.021),
        "stress_ok": _row(divergence_rate=0.04, stress_config=True),
        "stress_high": _row(divergence_rate=0.05, stress_config=True),
    })
    assert set(bad) == {"high", "stress_high"}


def test_var_ratio_gates():
    bad = gate_violations({
        "ok": _row(var_ratio_mean=0.985),
        "low": _row(var_ratio_mean=0.97),
        "high": _row(var_ratio_mean=1.03),
        "no_exact_posterior": {k: v for k, v in GOOD.items()
                               if k != "var_ratio_mean"},
        "stress_ok": _row(var_ratio_mean=1.04, stress_config=True),
    })
    assert set(bad) == {"low", "high"}


def test_centered_funnel_reference_anchored_gates():
    funnel = dict(stress_config=True, max_rhat=1.2, divergence_rate=0.03)
    bad = gate_violations({
        "ok": _row(p_div_given_not_neck=0.02, v_std=2.5, **funnel),
        "out_of_neck": _row(p_div_given_not_neck=0.03, v_std=2.5, **funnel),
        "shallow": _row(p_div_given_not_neck=0.01, v_std=2.0, **funnel),
    })
    assert set(bad) == {"out_of_neck", "shallow"}


def test_every_row_stamps_its_engine():
    bad = gate_violations({"ok": _row(), "unstamped": _row(engine=None)})
    assert set(bad) == {"unstamped"}


def test_crashed_row_fails_the_gate():
    bad = gate_violations({
        "ok": _row(),
        "crashed": {"error": "RuntimeError: out of memory"},
        "no_metrics": {"engine": "nuts_diag"},
    })
    assert set(bad) == {"crashed", "no_metrics"}
    assert bad["crashed"] == ["error: RuntimeError: out of memory"]
