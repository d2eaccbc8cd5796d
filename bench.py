"""Headline benchmark: NUTS effective samples per second on one GPU.

Config: BASELINE.json #2 — 100-d correlated Gaussian, 1024 vectorized
chains, 500 tune + 1000 draws, NUTS defaults, ``random_seed=42``. The
adaptive metric is part of the algorithm (the reference ships adapt_diag
AND adapt_full, init_nuts sampling.py:578-597), so the bench runs
``sample()`` with both — the diagonal metric and the cross-chain pooled
dense metric — and elects the one with the higher measured
min-bulk-ESS/s. Both walls and the winner's statistical gates are
reported.

Metric: min-over-dims bulk ESS per second of device sampling time
(``perf_report["sample_seconds"]`` of a second, warm call; the first
call compiles). Baseline: the reference littlemcmc's sequential CPU path
on the same target (REFERENCE_BASELINE.json, measured by
scripts/measure_reference_baseline.py; the reference has no accelerator
path).

Prints the platform, device kind, device count and the card's
``nvidia-smi`` name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra"}.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CHAINS = 1024
TUNE = 500
DRAWS = 1000
NDIM = 100
SEED = 42

# Published dense peaks per device, keyed by JAX's device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, at its 700 W limit.
# float32 = outside the tensor cores (the model matmuls run at
# precision="highest").
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM, dense, 700 W",
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak table row for ``device_kind``; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add its row "
            f"to bench.PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[device_kind]


def _baseline_ess_per_sec() -> float:
    """Best reference ESS/s on this target across its metrics."""
    with open(os.path.join(REPO, "REFERENCE_BASELINE.json")) as f:
        rows = json.load(f)["results"]
    return float(max(rows[k]["ess_per_sec_min_dim"]
                     for k in ("corr_gaussian_100d", "corr_gaussian_100d_full")
                     if k in rows))


def main():
    import jax

    import littlemcmc_tpu as lmc
    from littlemcmc_tpu import models
    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache
    from littlemcmc_tpu.utils.diagnostics import ess_bulk

    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"platform {dev.platform}; device_kind {dev.device_kind}; "
          f"device count {len(jax.devices())}; nvidia-smi {card}", flush=True)

    model = models.CorrelatedGaussian(NDIM)
    results = {}
    for init in ("jitter+adapt_diag", "jitter+adapt_full"):
        args = dict(logp_dlogp_func=model.logp_grad, model_ndim=NDIM,
                    chains=CHAINS, tune=TUNE, draws=DRAWS, random_seed=SEED,
                    init=init, progressbar=False)
        lmc.sample(**args)  # compiles; the timed call below reuses it
        report = {}
        trace, stats = lmc.sample(perf_report=report, **args)
        ess = np.array([ess_bulk(trace[:, :, i]) for i in range(NDIM)])
        results[report["engine"]] = (report, trace, stats, float(np.min(ess)))
        print(f"# {report['engine']}: sample_seconds {report['sample_seconds']}, "
              f"min bulk ESS {float(np.min(ess))}", flush=True)

    def ess_per_sec(name):
        report, _, _, min_ess = results[name]
        return min_ess / report["sample_seconds"]

    best = max(results, key=ess_per_sec)
    report, trace, stats, min_ess = results[best]
    seconds = report["sample_seconds"]

    # Model matvecs executed in the draw phase: every chain integrates in
    # lock-step until the deepest tree of the draw finishes.
    tree = np.asarray(stats["tree_size"])  # (chains, draws)
    leaps_executed = float(tree.max(axis=0).sum() * CHAINS)
    n_matvecs = 3 if "dense" in best else 1  # dense: two velocity matvecs
    model_flops = leaps_executed * 2.0 * NDIM * NDIM * n_matvecs
    draw_share = DRAWS / (TUNE + DRAWS)  # time share, assuming even draws

    baseline = _baseline_ess_per_sec()
    value = ess_per_sec(best)
    print(json.dumps({
        "metric": "NUTS bulk-ESS/s (min over dims), 100-d corr Gaussian, "
                  f"{CHAINS} chains, 1 device",
        "value": value,
        "unit": "ESS/s",
        "vs_baseline": value / baseline,
        "extra": {
            "engine": best,
            "engine_sample_seconds": {k: v[0]["sample_seconds"]
                                      for k, v in results.items()},
            "engine_min_ess_per_sec": {k: ess_per_sec(k) for k in results},
            "sample_seconds": seconds,
            "transfer_seconds": report["transfer_seconds"],
            "transitions_per_sec": CHAINS * (TUNE + DRAWS) / seconds,
            "min_ess_bulk": min_ess,
            "divergence_rate": float(np.mean(stats["diverging"])),
            "posterior_var_ratio": float(np.mean(
                trace.reshape(-1, NDIM).var(axis=0) / model.true_var)),
            "model_float32_share_of_peak": (
                model_flops / (seconds * draw_share) / peaks["float32_flops"]),
            "peaks_source": peaks["source"],
            "baseline_ess_per_sec_reference_cpu": baseline,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": card,
        },
    }))


if __name__ == "__main__":
    main()
