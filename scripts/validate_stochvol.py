"""VALIDATION config 8: stochastic volatility (503 params) vs the reference.

The one realistic-geometry zoo entry (financial time series, latent
AR(1) log-volatility with funnel-like sigma<->h coupling) validated the
same way as config 5: the reference's sequential path and littlemcmc_ours
sample the *same* target (the reference takes any callable — the
framework-cookbook contract, docs/tutorials/quickstart.rst:37-49 — so
both sides share the JAX log-density, the reference side jitted on the
host CPU), and every moment must agree within joint MC error.

Appends/updates the "## Config 8" section of VALIDATION.md.

Run: python scripts/validate_stochvol.py
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

T_LATENT = 500  # ndim = 503


def main():
    import jax

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    import littlemcmc_ours as lmc
    from littlemcmc_ours import models
    from littlemcmc_ours.utils.diagnostics import ess_bulk
    from _reference_shim import import_reference

    ref = import_reference()
    sv = models.StochasticVolatility(T=T_LATENT)
    ndim = sv.ndim

    # Reference side: same target, jitted on the host CPU. Placement is
    # by committed argument (device_put), so every reference gradient
    # runs on the host, not on the accelerator.
    cpu = jax.devices("cpu")[0]
    logp_grad_cpu = jax.jit(sv.logp_grad)

    def ref_fn(x):
        # numpy -> CPU device directly: jnp.asarray would materialize on
        # the default device (the accelerator) first
        xd = jax.device_put(np.asarray(x, np.float32), cpu)
        lp, g = logp_grad_cpu(xd)
        return float(lp), np.asarray(g, np.float64)

    print(f"reference: 2 chains x 2000 draws on {ndim} params ...",
          flush=True)
    t0 = time.perf_counter()
    ref_tr, ref_stats = ref.sample(
        logp_dlogp_func=ref_fn, model_ndim=ndim, tune=1000, draws=2000,
        chains=2, cores=1, progressbar=False, random_seed=8,
    )
    ref_secs = time.perf_counter() - t0
    ref_tr = np.asarray(ref_tr).reshape(-1, ndim)
    print(f"  {ref_secs:.0f}s, divergences="
          f"{int(np.asarray(ref_stats['diverging']).sum())}", flush=True)

    print("littlemcmc_ours: 256 chains x 2000 draws ...", flush=True)
    t0 = time.perf_counter()
    ours_tr, ours_stats = lmc.sample(
        logp_dlogp_func=sv.logp_grad, model_ndim=ndim, tune=1000,
        draws=2000, chains=256, random_seed=8, progressbar=False,
    )
    ours_secs = time.perf_counter() - t0
    div_ours = float(np.asarray(ours_stats["diverging"]).mean())
    ours_tr = np.asarray(ours_tr).reshape(-1, ndim)
    print(f"  {ours_secs:.0f}s, divergence rate {div_ours:.4f}", flush=True)

    # Joint-MC-error z gate on every coordinate (reference ESS-adjusted;
    # our side has ~128x the samples so the reference term dominates).
    ref_ess = np.asarray([ess_bulk(ref_tr[:, i][None, :])
                          for i in range(ndim)])
    se = np.sqrt(ref_tr.std(0) ** 2 / np.maximum(ref_ess, 1.0)
                 + ours_tr.std(0) ** 2 / ours_tr.shape[0])
    z = np.abs(ref_tr.mean(0) - ours_tr.mean(0)) / se
    sd_ratio = ours_tr.std(0) / ref_tr.std(0)

    names = {0: "phi_raw", 1: "log_sigma", 2: "mu", 3: "h[1]",
             3 + T_LATENT // 2: f"h[{T_LATENT // 2}]",
             2 + T_LATENT: f"h[{T_LATENT}]"}
    lines = [
        "## Config 8 — stochastic volatility (503 params; realistic "
        "latent-state geometry)",
        "",
        f"Same JAX log-density on both sides (the reference's "
        f"bring-your-own-logp contract); reference 2 chains x 2000 draws "
        f"({ref_secs:.0f}s, cores=1), littlemcmc_ours 256 chains x 2000 "
        f"draws ({ours_secs:.0f}s, on {jax.devices()[0].device_kind}).",
        "",
        "Gate: every one of the 503 coordinates' means agree within "
        "joint MC error.",
        "",
        "| statistic | value |",
        "|---|---|",
        f"| max z over 503 coordinates | {z.max():.2f} |",
        f"| mean z | {z.mean():.2f} |",
        f"| max sd ratio | {sd_ratio.max():.3f} |",
        f"| min sd ratio | {sd_ratio.min():.3f} |",
        f"| divergence rate (ours) | {div_ours:.4f} |",
        "",
        "| param | reference mean ± sd | littlemcmc_ours mean ± sd |",
        "|---|---|---|",
    ]
    for i in sorted(names):
        r, t = ref_tr[:, i], ours_tr[:, i]
        lines.append(f"| {names[i]} | {r.mean():+.3f} ± {r.std():.3f} "
                     f"| {t.mean():+.3f} ± {t.std():.3f} |")
    lines.append("")

    ok = z.max() < 4.0
    lines.append(f"Verdict: max z = {z.max():.2f} "
                 f"{'< 4 — PASS' if ok else '>= 4 — FAIL'}.")
    lines.append("")

    out = os.path.join(REPO, "VALIDATION.md")
    with open(out) as f:
        old = f.read()
    i8 = old.find("## Config 8")
    if i8 >= 0:
        old = old[:i8].rstrip("\n") + "\n"
    text = old.rstrip("\n") + "\n\n" + "\n".join(lines)
    with open(out, "w") as f:
        f.write(text)
    print("wrote", out)
    assert ok, f"stochvol moment mismatch: max z = {z.max():.2f}"


if __name__ == "__main__":
    main()
