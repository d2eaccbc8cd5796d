"""Measure the reference littlemcmc's sampling throughput on this machine.

The reference publishes no sampler benchmarks (BASELINE.md), so the
baseline must be measured. This script runs the reference's *sequential*
path (its multiprocessing path is broken — SURVEY.md §2) on the benchmark
configs and records draws/s and bulk-ESS/s, evaluated with the same
diagnostics used for littlemcmc_tpu. Results land in
REFERENCE_BASELINE.json, which bench.py reads for its vs_baseline field.

Run:  python scripts/measure_reference_baseline.py
"""

import json
import os
import sys
import time
import types

import numpy as np

# --- stub fastprogress (not installed; the reference imports it) ---------
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
sys.modules["fastprogress"] = fp
sys.modules["fastprogress.fastprogress"] = fpfp

# numpy>=1.24 removed np.bool (the reference uses it in stats_dtypes)
if not hasattr(np, "bool"):
    np.bool = np.bool_  # type: ignore[attr-defined]

sys.path.insert(0, "/root/reference")
import littlemcmc as ref_lmc  # noqa: E402

repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo_root)
from littlemcmc_tpu.utils.diagnostics import ess_bulk  # noqa: E402


def run_config(name, logp_dlogp_func, ndim, chains=4, tune=500, draws=1000,
               init="auto"):
    t0 = time.perf_counter()
    # Sequential chains (cores=1): the reference's only correct path.
    trace, stats = ref_lmc.sample(
        logp_dlogp_func=logp_dlogp_func,
        model_ndim=ndim,
        tune=tune,
        draws=draws,
        chains=chains,
        cores=1,
        progressbar=False,
        random_seed=42,
        init=init,
    )
    elapsed = time.perf_counter() - t0
    trace = np.asarray(trace)  # (chains, draws, ndim)
    ess = np.array([ess_bulk(trace[:, :, i]) for i in range(ndim)])
    total_transitions = chains * (tune + draws)
    result = {
        "config": name,
        "ndim": ndim,
        "chains": chains,
        "tune": tune,
        "draws": draws,
        "wall_seconds": elapsed,
        "transitions_per_sec": total_transitions / elapsed,
        "min_ess_bulk": float(np.nanmin(ess)),
        "ess_per_sec_min_dim": float(np.nanmin(ess) / elapsed),
        "posterior_mean": float(trace.mean()),
        "posterior_std": float(trace.std()),
    }
    print(json.dumps(result))
    return result


def main():
    results = {}

    def std_normal(x):
        return -0.5 * np.sum(x ** 2), -x

    results["std_normal_1d"] = run_config("1D standard normal", std_normal, 1)

    # 100-d correlated Gaussian — the flagship config. Same construction as
    # littlemcmc_tpu.models.CorrelatedGaussian(100) for apples-to-apples.
    from littlemcmc_tpu.models.gaussian import CorrelatedGaussian

    m = CorrelatedGaussian(100)
    prec = m.prec

    def corr_gauss(x):
        g = -prec @ x
        return 0.5 * x @ g, g

    results["corr_gaussian_100d"] = run_config(
        "100-d correlated Gaussian (diag adapt)", corr_gauss, 100
    )

    # Same target with the reference's dense metric (its best algorithm
    # on this config: jitter+adapt_full collapses the deep trees the
    # diag metric needs). bench.py compares our best engine against the
    # best reference row, metric for metric.
    results["corr_gaussian_100d_full"] = run_config(
        "100-d correlated Gaussian (full adapt)", corr_gauss, 100,
        init="jitter+adapt_full",
    )

    meta = {
        "machine": "benchmark container host CPU (reference has no accelerator path)",
        "reference": "eigenfoo/littlemcmc v0.2.2, sequential cores=1 path",
        "note": "multiprocessing path of the reference is broken (SURVEY.md §2); "
                "sequential is its only correct mode",
        "results": results,
    }
    out = os.path.join(repo_root, "REFERENCE_BASELINE.json")
    with open(out, "w") as f:
        json.dump(meta, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
