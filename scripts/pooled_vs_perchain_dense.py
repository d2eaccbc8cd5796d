"""Experiment: per-chain vs cross-chain pooled dense-metric adaptation.

The measurement behind ``sample()``'s auto-promotion of ``adapt_full``
to pooled adaptation at vector chain counts: the same ``adapt_full`` run with per-chain Welford covariance (the
reference's semantics, one chain's 101-sample window per estimate) vs
``cross_chain_adapt=True`` (every chain's samples pooled into one
estimate each tuning step — ``chains×`` more data per window).

Quality metrics: posterior variance ratio (sampling correctness), mean
tree depth (metric quality — a better metric yields shallower trees),
min bulk ESS, and the final adapted covariance's distance to the true
covariance. Writes POOLED_VS_PERCHAIN.json.

Run: python scripts/pooled_vs_perchain_dense.py  (the CPU is enough)
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = 32
TUNE, DRAWS = 500, 600


def run(chains, pooled, seed=13):
    import jax

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import littlemcmc_tpu as lmc
    from littlemcmc_tpu import models
    from littlemcmc_tpu.utils.diagnostics import ess_bulk, split_rhat

    model = models.CorrelatedGaussian(N, rho=0.9)
    t0 = time.perf_counter()
    trace, stats, final = lmc.sample(
        logp_dlogp_func=model.logp_grad, model_ndim=N, chains=chains,
        tune=TUNE, draws=DRAWS, init="jitter+adapt_full", random_seed=seed,
        cross_chain_adapt=pooled, progressbar=False,
        return_final_state=True,
    )
    wall = time.perf_counter() - t0
    tr = np.asarray(trace)
    var_ratio = tr.reshape(-1, N).var(0) / model.true_var
    ess = np.array([ess_bulk(tr[:, :, i]) for i in range(0, N, 4)])
    rhat = np.array([split_rhat(tr[:, :, i]) for i in range(0, N, 4)])
    # metric quality: relative Frobenius error of the adapted covariance
    cov = np.asarray(final.potential.cov)
    true_cov = np.asarray(model.cov if hasattr(model, "cov") else np.nan)
    cov_err = float(np.linalg.norm(cov.mean(0) - true_cov)
                    / np.linalg.norm(true_cov))
    cov_err_per_chain = float(np.mean([
        np.linalg.norm(cov[c] - true_cov) / np.linalg.norm(true_cov)
        for c in range(min(chains, 16))
    ]))
    return {
        "chains": chains,
        "pooled": pooled,
        "wall_seconds": round(wall, 1),
        "var_ratio_mean": round(float(var_ratio.mean()), 4),
        "var_ratio_worst": round(float(np.abs(var_ratio - 1).max() + 1), 4),
        "min_ess_bulk": round(float(np.nanmin(ess)), 1),
        "max_rhat": round(float(np.nanmax(rhat)), 4),
        "mean_depth_post_tune": round(float(np.asarray(stats["depth"]).mean()), 3),
        "mean_accept": round(float(np.asarray(stats["mean_tree_accept"]).mean()), 3),
        "cov_rel_frobenius_err_meanmetric": round(cov_err, 4),
        "cov_rel_frobenius_err_per_chain": round(cov_err_per_chain, 4),
    }


def main():
    import jax

    rows = []
    for chains in (8, 64):
        for pooled in (False, True):
            r = run(chains, pooled)
            print(json.dumps(r))
            rows.append(r)
    out = {
        "model": f"CorrelatedGaussian({N}, rho=0.9), adapt_full, "
                 f"tune={TUNE} draws={DRAWS}",
        "platform": jax.devices()[0].platform,
        "rows": rows,
    }
    with open(os.path.join(REPO, "POOLED_VS_PERCHAIN.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("wrote POOLED_VS_PERCHAIN.json")


if __name__ == "__main__":
    main()
