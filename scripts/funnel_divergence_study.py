"""Why does the centered funnel diverge 2.2x more than the reference?

VALIDATION config 4 (Neal's funnel 10-d, centered, target 0.9) records
a higher divergence rate than the reference's 0.0175, alongside *better*
neck coverage (the reference's v q05 is -1.86 against the exact -4.94).
Candidate causes, isolated one at a time (each arm = one subprocess, run
one after another, because x64 is a process-start flag):

- arm f32_t090 vs f64_t090: **precision** (the reference is f64
  end-to-end; f32 gradient error in the neck's e^{-v} curvature can
  produce spurious |dE| > Emax).
- arm f32_t095: **step size** (smaller step = fewer divergences at
  equal geometry).
- every arm also decomposes P(div) = P(neck) * P(div|neck) + ... with
  neck := v < -2 (exact occupancy would be Phi(-2/3) = 0.2525): if our
  sampler simply *visits* the neck more than the reference's, a higher
  marginal divergence rate accompanies better coverage.

Writes FUNNEL_DIVERGENCE_STUDY.json. Run: python scripts/funnel_divergence_study.py
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHAINS, TUNE, DRAWS = 512, 1000, 3000

ARMS = {  # name: (f64, target_accept)
    "f32_t090": (False, 0.9),
    "f64_t090": (True, 0.9),
    "f32_t095": (False, 0.95),
}


def run_arm(name):
    import numpy as np
    import jax

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    def _fmean(x):
        a = np.asarray(x, dtype=np.float64)
        return float(a[np.isfinite(a)].mean())

    f64, target = ARMS[name]
    if f64:
        assert jax.config.jax_enable_x64, "f64 arm needs JAX_ENABLE_X64=1"
    import jax.numpy as jnp

    import littlemcmc_tpu as lmc
    from littlemcmc_tpu import models

    fm = models.NealsFunnel(10)
    common = dict(
        logp_dlogp_func=fm.logp_grad, model_ndim=10, tune=TUNE,
        draws=DRAWS, chains=CHAINS, random_seed=4, progressbar=False,
        target_accept=target, compute_convergence_checks=False,
    )
    if f64:
        common["dtype"] = jnp.float64
    rep = {}
    t0 = time.perf_counter()
    trace, stats = lmc.sample(perf_report=rep, **common)
    wall = time.perf_counter() - t0
    tr = np.asarray(trace)
    v = tr[:, :, 0]  # (chains, draws)
    div = np.asarray(stats["diverging"])
    neck = v < -2.0
    row = {
        "engine": rep.get("engine"),
        "dtype": "float64" if f64 else "float32",
        "target_accept": target,
        "wall_s": round(wall, 1),
        "divergence_rate": round(float(div.mean()), 5),
        "v_mean": round(float(v.mean()), 3),
        "v_std": round(float(v.std()), 3),
        "v_q05": round(float(np.percentile(v, 5)), 3),
        "v_q95": round(float(np.percentile(v, 95)), 3),
        # finite-masked: a tree whose first doubling diverges leaves only
        # the initial state, and the reference's own mean_tree_accept
        # formula (exp(lwas - logdiffexp(log_size, 0))) is inf there —
        # one such draw poisons a plain mean (seen on the f64 arm)
        "mean_accept": round(_fmean(stats["mean_tree_accept"]), 4),
        "mean_depth": round(float(np.asarray(stats["depth"]).mean()), 3),
        "mean_final_step": round(_fmean(stats["step_size"]), 5),
        "p_neck": round(float(neck.mean()), 5),
        "p_div_given_neck": round(
            float(div[neck].mean()) if neck.any() else 0.0, 5),
        "p_div_given_not_neck": round(float(div[~neck].mean()), 5),
    }
    print("ARMJSON:" + json.dumps(row), flush=True)


def main():
    out = {"config": {"chains": CHAINS, "tune": TUNE, "draws": DRAWS,
                      "model": "NealsFunnel(10) centered", "seed": 4,
                      "exact_p_neck": 0.2525},
           "reference_row": {
               "divergence_rate": 0.0175, "v_std": 2.130, "v_q05": -1.855,
               "mean_accept": 0.642, "mean_depth": 3.14,
               "note": "VALIDATION.md config 4 (2 chains x 3000, f64, "
                       "cores=1 sequential path)"},
           "arms": {}}
    path = os.path.join(REPO, "FUNNEL_DIVERGENCE_STUDY.json")
    for name, (f64, target) in ARMS.items():
        env = dict(os.environ)
        if f64:
            env["JAX_ENABLE_X64"] = "1"
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--arm", name],
            env=env, capture_output=True, text=True, timeout=3600)
        arm = None
        for line in r.stdout.splitlines():
            if line.startswith("ARMJSON:"):
                arm = json.loads(line[len("ARMJSON:"):])
        if arm is None:
            arm = {"error": (r.stderr or r.stdout)[-2000:]}
        out["arms"][name] = arm
        print(name, json.dumps(arm), flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    print("wrote", path)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--arm":
        run_arm(sys.argv[2])
    else:
        main()
