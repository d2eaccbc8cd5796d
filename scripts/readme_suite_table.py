"""Render the README benchmark-suite table from BENCH_SUITE.json.

Keeps the README's numbers mechanically tied to the suite's artifact:
no prose number may differ from it.
Prints the markdown table to stdout; paste into README.md's suite
section.

Run: python scripts/readme_suite_table.py
"""

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LABELS = {
    "std_normal_1d": "1-D std normal",
    "corr_gaussian_100d_diag": "100-d corr. Gaussian (diag)",
    "corr_gaussian_100d_full": "100-d corr. Gaussian (full adapt, per-chain)",
    "corr_gaussian_100d_full_pooled": "— pooled full adapt (extension)",
    "spiked_gaussian_100d_diag": "100-d spiked Gaussian (diag)",
    "spiked_gaussian_100d_lowrank": "— pooled low-rank adapt (extension)",
    "funnel_10d": "Neal's funnel 10-d (centered, stress)",
    "funnel_10d_noncentered": "— non-centered (production form)",
    "logistic_25p": "logistic regression 25p",
    "eight_schools_10k_chains": "eight schools NUTS, `target_accept=0.95`",
    "hierarchical_regression": "hierarchical regression 42-d (gather model)",
    "stochastic_volatility_503d": "stochastic volatility 503-d",
    "eight_schools_hmc": "eight schools classic HMC",
}


def _k(x):
    if x is None:
        return "—"
    if x >= 1e6:
        return f"{x / 1e6:.2f}M"
    return f"{x / 1000:.1f}k" if x >= 1000 else f"{x:.0f}"


def main():
    with open(os.path.join(REPO, "BENCH_SUITE.json")) as f:
        suite = json.load(f)
    rows = suite["results"] if "results" in suite else suite
    print("| config | chains | engine | device trans/s | device ESS/s "
          "(min dim) | max R̂ | div. rate | var ratio |")
    print("|---|---|---|---|---|---|---|---|")
    for key, label in LABELS.items():
        r = rows.get(key)
        if r is None:
            continue
        tps = r.get("transitions_per_device_sec")
        ess = r.get("ess_per_device_sec_min_dim")
        star = ""
        if tps is None:  # carried row without the device split: warm wall
            tps, ess, star = (r.get("transitions_per_sec"),
                              r.get("ess_per_sec_min_dim"), "\u2020")
        div = r.get("divergence_rate", 0.0)
        div_s = "0" if div == 0 else f"{100 * div:.1f}%"
        var = r.get("var_ratio_mean")
        print(f"| {label} | {r['chains']} | {r.get('engine', '—')}{star} "
              f"| {_k(tps)}{star} "
              f"| {_k(ess)}{star} "
              f"| {r.get('max_rhat', float('nan')):.3f} | {div_s} "
              f"| {var if var is not None else '—'} |")


if __name__ == "__main__":
    main()
