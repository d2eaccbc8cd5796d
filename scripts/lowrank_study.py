"""Measured comparison of the metric family on spiked-covariance targets.

Writes LOWRANK_STUDY.json: adapt_diag vs adapt_full vs adapt_lowrank
(per-chain and cross-chain pooled) on ``models.SpikedGaussian`` — the
geometry the low-rank metric exists for. Gates of interest: mean tree
depth (leapfrogs per draw), min bulk ESS per leapfrog (sampler
efficiency net of metric quality), posterior variance ratios, and
divergence rates. Run on the CPU or a GPU: python scripts/lowrank_study.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run(model, init, cca, chains, tune, draws, seed=11):
    import littlemcmc_tpu as lmc
    from littlemcmc_tpu.utils.diagnostics import ess_bulk

    t0 = time.perf_counter()
    trace, stats = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
        tune=tune, draws=draws, chains=chains, random_seed=seed,
        init=init, cross_chain_adapt=cca, progressbar=False)
    wall = time.perf_counter() - t0
    tr = np.asarray(trace)
    ndim = model.ndim
    sub = range(ndim) if ndim <= 24 else list(range(0, ndim, ndim // 24))
    ess = np.array([ess_bulk(tr[:, :, i]) for i in sub])
    depth = float(np.mean(np.asarray(stats["depth"])))
    leapfrogs = float(np.mean(np.asarray(stats["tree_size"])))
    vr = tr.reshape(-1, ndim).var(axis=0) / model.true_var
    min_ess = float(np.nanmin(ess))
    return {
        "init": init,
        "pooled": bool(cca),
        "wall_seconds": round(wall, 1),
        "mean_depth": round(depth, 2),
        "mean_leapfrogs_per_draw": round(leapfrogs, 1),
        "min_ess_bulk": round(min_ess, 1),
        # metric quality net of trajectory cost — the number the metric
        # family actually changes (wall clock is backend-dependent)
        "min_ess_per_1k_leapfrogs": round(
            1000.0 * min_ess / (leapfrogs * chains * draws), 3),
        "var_ratio_min": round(float(vr.min()), 3),
        "var_ratio_max": round(float(vr.max()), 3),
        "divergence_rate": round(float(np.mean(np.asarray(stats["diverging"]))), 5),
    }


def main():
    import jax

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from littlemcmc_tpu import models

    out = {"platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind,
           "model": "SpikedGaussian (spikes 400/100/25/9, log-spread scales)",
           "configs": {}}

    m24 = models.SpikedGaussian(24, rank=3, spikes=(400.0, 100.0, 25.0))
    rows = []
    for init, cca in [("jitter+adapt_diag", False),
                      ("jitter+adapt_full", False),
                      ("jitter+adapt_lowrank", False),
                      ("jitter+adapt_lowrank", True)]:
        r = run(m24, init, cca, chains=64, tune=500, draws=500)
        print(json.dumps(r))
        rows.append(r)
    out["configs"]["spiked_24d"] = rows

    m100 = models.SpikedGaussian(100)
    rows = []
    for init, cca in [("jitter+adapt_diag", False),
                      ("jitter+adapt_lowrank", True)]:
        r = run(m100, init, cca, chains=64, tune=500, draws=500)
        print(json.dumps(r))
        rows.append(r)
    out["configs"]["spiked_100d"] = rows

    path = os.path.join(REPO, "LOWRANK_STUDY.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
