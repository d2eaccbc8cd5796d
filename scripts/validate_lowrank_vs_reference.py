"""Validate adapt_lowrank against the reference sampler on a shared target.

The low-rank metric is an extension (no reference counterpart), so its
correctness gate is: on the same spiked-covariance Gaussian, sampling
with ``init="adapt_lowrank"`` must reproduce the posterior the
reference's own sampler (diag metric, its only robust mode at this
conditioning) produces — moments within joint MC error — while needing
fewer leapfrogs per draw. Appends/refreshes the "## Config 7" section
of VALIDATION.md (kept by deep_validation.py's regeneration).

Run: python scripts/validate_lowrank_vs_reference.py  (~5 min CPU)
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def main():
    import jax

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from _reference_shim import import_reference

    ref = import_reference()

    import littlemcmc_ours as lmc
    from littlemcmc_ours import models
    from littlemcmc_ours.utils.diagnostics import ess_bulk

    n = 24
    m = models.SpikedGaussian(n, rank=3, spikes=(64.0, 25.0, 9.0))
    S = np.diag(m.scales)
    Sigma = S @ (np.eye(n) + m.V @ np.diag(m.lam - 1) @ m.V.T) @ S
    Prec64 = np.linalg.inv(Sigma)

    def ref_logp_grad(q):
        g = -Prec64 @ q
        return 0.5 * q @ g, g

    t0 = time.perf_counter()
    ref_tr, ref_st = ref.sample(
        logp_dlogp_func=ref_logp_grad, model_ndim=n, tune=1000, draws=3000,
        chains=2, cores=1, progressbar=False, random_seed=7)
    ref_secs = time.perf_counter() - t0
    ref_tr = np.asarray(ref_tr).reshape(-1, n)
    ref_depth = float(np.mean(ref_st["depth"]))

    t0 = time.perf_counter()
    ours_tr, ours_st = lmc.sample(
        logp_dlogp_func=m.logp_grad, model_ndim=n, tune=1000, draws=3000,
        chains=256, random_seed=7, init="jitter+adapt_lowrank",
        progressbar=False)
    ours_secs = time.perf_counter() - t0
    ours_tr2 = np.asarray(ours_tr).reshape(-1, n)
    ours_depth = float(np.mean(np.asarray(ours_st["depth"])))
    ours_div = float(np.mean(np.asarray(ours_st["diverging"])))

    ref_ess = np.asarray([ess_bulk(ref_tr[:, i][None, :]) for i in range(n)])
    se = np.sqrt(ref_tr.std(0) ** 2 / np.maximum(ref_ess, 1.0)
                 + ours_tr2.std(0) ** 2 / ours_tr2.shape[0])
    z = np.abs(ref_tr.mean(0) - ours_tr2.mean(0)) / se
    sd_ratio = ours_tr2.std(0) / ref_tr.std(0)
    exact_sd = np.sqrt(np.diag(Sigma))
    sd_vs_exact = ours_tr2.std(0) / exact_sd

    lines = [
        "## Config 7 — adapt_lowrank vs the reference on a spiked Gaussian "
        "(extension validation)",
        "",
        f"`models.SpikedGaussian(24, rank=3)` (spikes 64/25/9, log-spread "
        f"scales). reference: 2 chains x 3000 draws, its diag metric "
        f"({ref_secs:.0f}s); littlemcmc_ours: 256 chains x 3000 draws, "
        f"`init=\"jitter+adapt_lowrank\"` ({ours_secs:.0f}s).",
        "",
        "The low-rank metric has no reference counterpart; the gate is that",
        "it samples the *same posterior* within joint MC error while doing",
        "less leapfrog work per draw:",
        "",
        "| statistic | value |",
        "|---|---|",
        f"| max z over {n} coordinates | {z.max():.2f} |",
        f"| mean z | {z.mean():.2f} |",
        f"| sd ratio vs reference (min, max) | {sd_ratio.min():.3f}, "
        f"{sd_ratio.max():.3f} |",
        f"| sd ratio vs EXACT (min, max) | {sd_vs_exact.min():.3f}, "
        f"{sd_vs_exact.max():.3f} |",
        f"| mean tree depth: reference (diag) | {ref_depth:.2f} |",
        f"| mean tree depth: adapt_lowrank | {ours_depth:.2f} |",
        f"| divergence rate (ours) | {ours_div:.4f} |",
        "",
    ]
    assert z.max() < 4.0, f"moment mismatch: max z = {z.max():.2f}"
    assert 0.9 < sd_vs_exact.min() and sd_vs_exact.max() < 1.1

    path = os.path.join(REPO, "VALIDATION.md")
    with open(path) as f:
        old = f.read()
    i7 = old.find("## Config 7")
    base = old[:i7].rstrip("\n") + "\n" if i7 >= 0 else old.rstrip("\n") + "\n"
    with open(path, "w") as f:
        f.write(base + "\n" + "\n".join(lines) + "\n")
    print("appended Config 7 to", path)


if __name__ == "__main__":
    main()
