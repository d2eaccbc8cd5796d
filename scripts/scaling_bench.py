"""Chain-scaling sweep on one device: transitions/s vs chain count.

The reference's only scaling axis is OS processes (at most `cores`
chains active); here chains are vectorized lanes, so single-device
throughput should grow with the chain count until the device saturates.
Device sampling time from ``sample(perf_report=...)`` on a second, warm
call (the first compiles), 100-d correlated Gaussian, with the diagonal
metric and the cross-chain pooled dense metric.

Run: python scripts/scaling_bench.py  (writes BENCH_SCALING.json)
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = 100
TUNE, DRAWS = 300, 300
CHAIN_COUNTS = (256, 1024, 4096, 16384)
INITS = ("jitter+adapt_diag", "jitter+adapt_full")


def main():
    import jax

    import littlemcmc_tpu as lmc
    from littlemcmc_tpu import models
    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    model = models.CorrelatedGaussian(N)
    dev = jax.devices()[0]
    results = {}
    for chains in CHAIN_COUNTS:
        row = {"chains": chains}
        for init in INITS:
            args = dict(logp_dlogp_func=model.logp_grad, model_ndim=N,
                        chains=chains, tune=TUNE, draws=DRAWS, init=init,
                        random_seed=7, progressbar=False,
                        compute_convergence_checks=False)
            lmc.sample(**args)  # compiles
            rep = {}
            lmc.sample(perf_report=rep, **args)
            row[rep["engine"]] = {
                "sample_seconds": rep["sample_seconds"],
                "transfer_seconds": rep["transfer_seconds"],
                "transitions_per_sec": chains * (TUNE + DRAWS) / rep["sample_seconds"],
            }
        results[str(chains)] = row
        print(json.dumps(row), flush=True)

    base_c = str(CHAIN_COUNTS[0])
    for engine, base in results[base_c].items():
        if not isinstance(base, dict):
            continue
        for c in CHAIN_COUNTS:
            r = results[str(c)][engine]
            r["scaling_efficiency_vs_%s" % base_c] = (
                r["transitions_per_sec"] / base["transitions_per_sec"]
                / (c / CHAIN_COUNTS[0]))

    out = os.path.join(REPO, "BENCH_SCALING.json")
    with open(out, "w") as f:
        json.dump({"platform": dev.platform, "device_kind": dev.device_kind,
                   "ndim": N, "tune": TUNE, "draws": DRAWS,
                   "timing": "perf_report sample_seconds of a warm call",
                   "results": results}, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
