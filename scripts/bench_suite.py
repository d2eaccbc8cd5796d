"""Full benchmark suite: all five BASELINE configs on the current backend.

Writes BENCH_SUITE.json at the repo root with throughput + quality
metrics per config, and exits non-zero when a row fails its gates
(:func:`gate_violations`). The headline driver benchmark stays in
bench.py; this suite is for the fuller picture.

Run: python scripts/bench_suite.py [--small] [row ...]
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# Gates per row: (max R-hat, max divergence rate, max |var ratio - 1|).
# Stress rows (the centered funnel) get the wider envelope.
GATES = {False: (1.05, 0.02, 0.02), True: (1.35, 0.045, 0.05)}
FUNNEL_GATES = {"p_div_given_not_neck": 0.025, "v_std_min": 2.13}


def gate_violations(rows: dict) -> dict:
    """``{row key: [failed gates]}`` for every row that fails.

    A row that recorded an ``"error"`` (its config crashed) fails, and so
    does a row without an ``engine`` stamp or without the metrics its
    gates read.
    """
    bad = {}
    for key, r in rows.items():
        fails = []
        if "error" in r:
            fails.append(f"error: {r['error']}")
        else:
            rhat_cap, div_cap, vr_tol = GATES[bool(r.get("stress_config"))]
            if not r.get("engine"):
                fails.append("no engine stamp")
            if not r.get("max_rhat", np.inf) <= rhat_cap:
                fails.append(f"max_rhat {r.get('max_rhat')} > {rhat_cap}")
            if not r.get("divergence_rate", np.inf) <= div_cap:
                fails.append(f"divergence_rate {r.get('divergence_rate')} > {div_cap}")
            vr = r.get("var_ratio_mean")
            if vr is not None and not abs(vr - 1.0) <= vr_tol:
                fails.append(f"var_ratio_mean {vr} off 1 by more than {vr_tol}")
            if "p_div_given_not_neck" in r:
                # out-of-neck divergences as the reference's own region,
                # plus a coverage floor at the reference's v std: a
                # sampler can always buy a low marginal rate by not
                # entering the neck
                if not r["p_div_given_not_neck"] <= FUNNEL_GATES["p_div_given_not_neck"]:
                    fails.append(f"p_div_given_not_neck {r['p_div_given_not_neck']}")
                if not r.get("v_std", 0.0) >= FUNNEL_GATES["v_std_min"]:
                    fails.append(f"v_std {r.get('v_std')} < {FUNNEL_GATES['v_std_min']}")
        if fails:
            bad[key] = fails
    return bad


def run_config(name, model, chains, tune, draws, init="jitter+adapt_diag", seed=42,
               target_accept=0.8, step_method="nuts",
               annotations=None, extra_metrics=None,
               **sample_kwargs):
    import littlemcmc_tpu as lmc
    from littlemcmc_tpu.utils.diagnostics import ess_bulk, split_rhat

    extra = dict(sample_kwargs)
    if step_method == "hmc":
        extra["step"] = lmc.HamiltonianMC(
            model_ndim=model.ndim, target_accept=target_accept)

    common = dict(
        logp_dlogp_func=model.logp_grad,
        model_ndim=model.ndim,
        chains=chains,
        init=init,
        random_seed=seed,
        progressbar=False,
        tune=tune,
        draws=draws,
        **extra,
    )
    if "step" not in extra:  # explicit steps carry their own target_accept
        common["target_accept"] = target_accept
    # Warm-up: the same call compiles every program the timed run uses.
    lmc.sample(**common)

    rep = {}
    t_all = time.perf_counter()
    trace, stats = lmc.sample(perf_report=rep, **common)
    wall = time.perf_counter() - t_all

    ndim = model.ndim
    sub = range(ndim) if ndim <= 20 else list(range(0, ndim, max(1, ndim // 20)))
    ess = np.array([ess_bulk(trace[:, :, i]) for i in sub])
    rhat = np.array([split_rhat(trace[:, :, i]) for i in sub])
    out = {
        "config": name,
        "ndim": ndim,
        "chains": chains,
        "tune": tune,
        "draws": draws,
        "wall_seconds_warm": round(wall, 2),
        "transitions_per_sec": round(chains * (tune + draws) / wall, 1),
        # device-only split + the sampler and metric that ran
        "engine": rep.get("engine"),
        "device_sample_seconds": round(rep.get("sample_seconds", wall), 2),
        "transfer_seconds": round(rep.get("transfer_seconds", 0.0), 2),
        "transitions_per_device_sec": round(
            chains * (tune + draws) / rep.get("sample_seconds", wall), 1),
        "min_ess_bulk": round(float(np.nanmin(ess)), 1),
        "ess_per_sec_min_dim": round(float(np.nanmin(ess) / wall), 1),
        "ess_per_device_sec_min_dim": round(
            float(np.nanmin(ess) / rep.get("sample_seconds", wall)), 1),
        "max_rhat": round(float(np.nanmax(rhat)), 4),
        "divergence_rate": round(float(stats["diverging"].mean()), 5),
        "mean_depth": round(float(
            (stats["depth"] if "depth" in stats else stats["n_steps"]).mean()), 2),
        "mean_accept": round(float(
            (stats["mean_tree_accept"] if "mean_tree_accept" in stats
             else stats["accept"]).mean()), 3),
    }
    if getattr(model, "true_var", None) is not None:
        var = trace.reshape(-1, ndim).var(axis=0)
        out["var_ratio_mean"] = round(float((var / model.true_var).mean()), 3)
    if extra_metrics is not None:
        out.update(extra_metrics(trace, stats))
    if annotations:
        out.update(annotations)
    print(json.dumps(out))
    return out


def main():
    small = "--small" in sys.argv
    only = [a for a in sys.argv[1:] if not a.startswith("--")]
    import jax
    from littlemcmc_tpu import models
    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    scale = 4 if small else 1
    results = {}
    out_path = os.path.join(REPO, "BENCH_SUITE.json")
    if only and os.path.exists(out_path):
        # partial re-run: merge into the existing artifact
        with open(out_path) as f:
            prev = json.load(f)
        results.update(prev.get("results", prev))

    def _dump():
        # incremental: a crashed late config loses nothing
        meta = {"platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "device_count": len(jax.devices()),
                "results": results}
        with open(out_path, "w") as f:
            json.dump(meta, f, indent=2)

    def _run(key, *a, **kw):
        if only and key not in only:
            return
        try:
            results[key] = run_config(*a, **kw)
        except Exception as e:
            results[key] = {"error": f"{type(e).__name__}: {e}"}
            print(f"# {key} failed: {e}", flush=True)
        _dump()

    _run("std_normal_1d", "1D standard normal (config 1)", models.StandardNormal(1),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
    )
    _run("corr_gaussian_100d_diag", "100-d correlated Gaussian, diag adapt (config 2a)",
        models.CorrelatedGaussian(100),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
    )
    _run("corr_gaussian_100d_full", "100-d correlated Gaussian, full adapt (config 2b)",
        models.CorrelatedGaussian(100),
        chains=256 // scale, tune=500 // scale, draws=1000 // scale,
        # explicit False: this row is the reference-parity per-chain
        # estimator; at >=128 chains sample() otherwise auto-promotes to
        # pooled adaptation (the next row)
        init="jitter+adapt_full", cross_chain_adapt=False,
        annotations={"estimator": "per-chain (reference parity); "
                     "auto-promotion would select the pooled row below"},
    )
    _run("corr_gaussian_100d_full_pooled", "100-d corr Gaussian, cross-chain pooled full adapt (extension)",
        models.CorrelatedGaussian(100),
        chains=256 // scale, tune=500 // scale, draws=1000 // scale,
        init="jitter+adapt_full", cross_chain_adapt=True,
    )
    _run("spiked_gaussian_100d_diag", "100-d spiked Gaussian, diag adapt (contrast row for adapt_lowrank)",
        models.SpikedGaussian(100),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        annotations={"note": "diag metric cannot model the spikes; "
                     "expect trees ~1.5 levels deeper than the lowrank row"},
    )
    _run("spiked_gaussian_100d_lowrank", "100-d spiked Gaussian, low-rank+diag adapt (extension)",
        models.SpikedGaussian(100),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        init="jitter+adapt_lowrank",
        annotations={"note": "QuadPotentialLowRankAdapt, pooled cross-chain "
                     "subspace iteration (auto-promoted at >=128 chains)"},
    )
    def _centered_funnel_metrics(trace, stats):
        # Reference-anchored decomposition: divergences on the centered
        # funnel live in the neck (v < -2), and the marginal rate is
        # exploration-weighted. The reference's lower marginal rate
        # (0.0175) comes with v_q05 = -1.86 against the exact -4.94: it
        # diverges less because it explores less. So the gate conditions
        # on the region the reference actually samples, plus a coverage
        # floor at the reference's own v_std.
        v = trace[:, :, 0]
        div = np.asarray(stats["diverging"])
        neck = v < -2.0
        return {
            "v_std": round(float(v.std()), 3),
            "v_q05": round(float(np.percentile(v, 5)), 3),
            "p_neck": round(float(neck.mean()), 5),
            "p_div_given_neck": round(
                float(div[neck].mean()) if neck.any() else 0.0, 5),
            "p_div_given_not_neck": round(float(div[~neck].mean()), 5),
        }

    _run("funnel_10d", "Neal's funnel 10-d, centered (config 3) — STRESS CONFIG",
        models.NealsFunnel(10),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        target_accept=0.9,
        extra_metrics=_centered_funnel_metrics,
        annotations={
            # The centered parameterization is the standard divergence
            # stress test: NO sampler with a fixed step size traverses
            # the funnel's neck unbiased. The non-centered row below is
            # the production parameterization and gates at R-hat < 1.05.
            "stress_config": True,
        },
    )

    def _funnel_space_metrics(model):
        def metrics(trace, stats):
            import jax.numpy as jnp

            fun = np.asarray(model.transform(jnp.asarray(trace)))
            v = fun[..., 0].reshape(-1)
            return {
                "funnel_v_std": round(float(v.std()), 3),
                "funnel_v_std_exact": model.scale,
            }
        return metrics

    ncf = models.NonCenteredFunnel(10)
    _run("funnel_10d_noncentered", "Neal's funnel 10-d, non-centered (config 3, production form)",
        ncf,
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        extra_metrics=_funnel_space_metrics(ncf),
        annotations={"gate": "max_rhat < 1.05"},
    )
    _run("logistic_25p", "Logistic regression 25 params (config 4)", models.LogisticRegression(),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
    )
    _run("eight_schools_10k_chains", "Eight schools non-centered, 10k chains (config 5)", models.EightSchools(),
        chains=10240 // scale, tune=500 // scale, draws=500 // scale,
        # Hierarchical geometry: the default 0.8 yields ~20% divergent
        # transitions and a biased posterior; 0.95 brings it under 2%.
        target_accept=0.95,
    )
    _run("hierarchical_regression", "Group-indexed hierarchical regression, 42-d (auto-lowered gather)",
        models.HierarchicalRegression(),
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        target_accept=0.9,
    )
    sv = models.StochasticVolatility(T=500)
    _run("stochastic_volatility_503d", "Stochastic volatility, T=500 (503 params, centered AR(1) states)",
        sv,
        chains=1024 // scale, tune=500 // scale, draws=1000 // scale,
        target_accept=0.95,
        annotations={"note": "large-ndim realistic geometry: funnel-like "
                     "sigma-latent coupling; globals gate convergence",
                     "gate": "divergence_rate < 0.05"},
    )
    _run("eight_schools_hmc", "Eight schools, classic HMC (C19)",
        models.EightSchools(),
        chains=10240 // scale, tune=500 // scale, draws=500 // scale,
        target_accept=0.95, step_method="hmc",
    )

    print("wrote", out_path)
    bad = gate_violations(results)
    if bad:
        raise SystemExit(f"gate violations: {bad}")


if __name__ == "__main__":
    main()
