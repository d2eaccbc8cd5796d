"""Probe: where does the flagship's TUNE wall go, chunk by chunk?

Trees run deep early in tuning, from jittered starts against the
weight-10 identity metric, and shallow once the pooled covariance takes
over. This script runs the flagship pooled-dense config (1024 chains,
100-d correlated Gaussian) with a per-chunk callback and records, per
chunk: wall seconds, mean/max tree size, mean step size, and the
divergence count — the tune/draw split of the work.

Run: python scripts/tune_phase_probe.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHAINS = 1024
TUNE, DRAWS = 500, 1000
N = 100


def main():
    import jax

    import littlemcmc_tpu as lmc
    from littlemcmc_tpu import models
    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    model = models.CorrelatedGaussian(N)
    common = dict(
        logp_dlogp_func=model.logp_grad, model_ndim=N, chains=CHAINS,
        random_seed=42, progressbar=False, target_accept=0.8,
        init="jitter+adapt_full", cross_chain_adapt=True,
        compute_convergence_checks=False, discard_tuned_samples=False,
    )
    # warm every program (one 250-draw chunk per phase) outside the timing
    lmc.sample(tune=TUNE, draws=250, progress_every=250, perf_report={},
               **common)

    chunks = []
    last = [time.perf_counter()]

    def cb(iteration, tuning, states, chunk, n_divergences):
        now = time.perf_counter()
        row = {"iteration": int(iteration), "tuning": bool(tuning),
               "wall_s": round(now - last[0], 4),
               "n_divergences": int(n_divergences)}
        if chunk is not None:
            info = chunk[1]
            ts = np.asarray(jax.device_get(info.tree_size))
            ss = np.asarray(jax.device_get(info.step_size))
            row.update(mean_tree_size=round(float(ts.mean()), 2),
                       max_tree_size=int(ts.max()),
                       mean_step_size=round(float(ss.mean()), 5))
        chunks.append(row)
        last[0] = now
        print(json.dumps(row), flush=True)

    rep = {}
    t0 = time.perf_counter()
    trace, stats = lmc.sample(tune=TUNE, draws=DRAWS, progress_every=250,
                              callback=cb, perf_report=rep, **common)
    wall = time.perf_counter() - t0

    ts = np.asarray(stats["tree_size"])  # (chains, tune+draws)
    per_draw_mean = ts.mean(axis=0)
    out = {
        "engine": rep.get("engine"),
        "sample_seconds": round(rep.get("sample_seconds", wall), 3),
        "wall_s": round(wall, 2),
        "chunks": chunks,
        "tune_mean_tree_size_by_50": [
            round(float(per_draw_mean[i:i + 50].mean()), 2)
            for i in range(0, TUNE, 50)],
        "draw_mean_tree_size": round(float(per_draw_mean[TUNE:].mean()), 2),
    }
    path = os.path.join(REPO, "TUNE_PHASE_PROBE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", path)


if __name__ == "__main__":
    main()
