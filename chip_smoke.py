"""Check that littlemcmc_tpu's main sampling path runs right on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards of one host

One card runs, in one process and in this order:

1. the device: a GPU is required, there is no CPU fallback;
2. model evaluation on the card against float64 NumPy: the zoo's
   ``CorrelatedGaussian(100)`` and ``LogisticRegression()``, and a
   user-style ``logp_fn`` through ``jax.value_and_grad`` at JAX's default
   matmul precision and at ``"highest"``;
3. the flagship job through ``sample()``: NUTS on the 100-d correlated
   Gaussian, 1024 chains, 500 tune + 1000 draws, diagonal metric;
4. the same with ``init="jitter+adapt_full"`` (pooled dense metric);
5. classic HMC on eight schools at 10,240 chains, 500 tune + 500 draws;
6. one short run with live progress from inside the compiled scan.

``--four-cards`` runs only the sharded path: the flagship dense job at
4096 chains on a four-card ``chains`` mesh and on one card, and a 2 x 2
``("chains", "model")`` mesh run.

A failed gate raises, so any failure exits non-zero. Every time printed
is labelled with the card's name and power limit. The last line of a
passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FLAGSHIP = dict(ndim=100, chains=1024, tune=500, draws=1000, seed=42)
NUTS_GATES = {"max_rhat": (None, 1.01), "divergence_rate": (None, 0.01),
              "var_ratio_mean": (0.95, 1.05)}
HMC_GATES = {"max_rhat": (None, 1.05), "divergence_rate": (None, 0.02)}
MODEL_TOL = 1e-5  # the zoo pins precision="highest": float32 accuracy


class GateFailure(RuntimeError):
    """A measured value fell outside its gate."""


def require(label: str, values: dict, limits: dict) -> None:
    """Raise :class:`GateFailure` unless every ``values[name]`` lies in
    ``limits[name] = (lo, hi)`` (``None`` = unbounded); print the gates met.

    A missing or non-finite value fails its gate.
    """
    failed, met = [], []
    for name, (lo, hi) in limits.items():
        v = values.get(name)
        ok = (v is not None and np.isfinite(v)
              and (lo is None or v >= lo) and (hi is None or v <= hi))
        (met if ok else failed).append(f"{name}={v} in [{lo}, {hi}]")
    if failed:
        raise GateFailure(f"{label}: gate failed: " + "; ".join(failed))
    print(f"{label}: gates met: " + "; ".join(met), flush=True)


def card_label() -> str:
    """``name, power limit`` of the card(s), read by ``nvidia-smi`` in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def check_device(count: int):
    """Exit non-zero unless JAX sees at least ``count`` GPUs; print what it sees."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found: JAX's platform is {platform!r}. "
            "This check runs only on an NVIDIA GPU; there is no CPU fallback.")
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs, JAX sees {len(devices)}.")
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"device count {len(devices)}", flush=True)
    return devices


def _rel_err(got, ref) -> float:
    """Max over points of ``max|got - ref| / max|ref|`` (a point is one row;
    scalars per point when ``ref`` is 1-D)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if ref.ndim == 1:
        return float(np.max(np.abs(got - ref) / np.abs(ref)))
    num = np.max(np.abs(got - ref), axis=1)
    return float(np.max(num / np.max(np.abs(ref), axis=1)))


def phase_models(card: str, n_points: int = 1024, seed: int = 0) -> dict:
    """Evaluate the zoo models and a user-style ``logp_fn`` on the device,
    batched over ``n_points`` random points, against float64 NumPy.

    The reference evaluates the same float32 inputs (points, precision
    matrix, design matrix) upcast to float64, so only the device's
    arithmetic is measured.
    """
    import jax
    import jax.numpy as jnp

    from littlemcmc_tpu import models

    rng = np.random.default_rng(seed)
    errors = {}

    gauss = models.CorrelatedGaussian(FLAGSHIP["ndim"])
    prec = np.asarray(gauss.prec, np.float32).astype(np.float64)
    chol = np.linalg.cholesky(gauss.cov)
    q = (rng.standard_normal((n_points, gauss.ndim)) @ chol.T).astype(np.float32)
    q64 = q.astype(np.float64)
    g_ref = -q64 @ prec.T
    lp_ref = 0.5 * np.sum(q64 * g_ref, axis=1)
    lp, g = jax.jit(jax.vmap(gauss.logp_grad))(jnp.asarray(q))
    errors["gauss_logp"] = _rel_err(lp, lp_ref)
    errors["gauss_grad"] = _rel_err(g, g_ref)

    X, y = models.german_credit_synthetic()
    logistic = models.LogisticRegression(X, y)
    Xb = np.concatenate([np.ones((X.shape[0], 1)), X], axis=1)
    Xb = Xb.astype(np.float32).astype(np.float64)
    y64 = y.astype(np.float32).astype(np.float64)
    inv_s2 = 1.0 / logistic.prior_scale ** 2
    b = (0.5 * rng.standard_normal((n_points, logistic.ndim))).astype(np.float32)
    b64 = b.astype(np.float64)
    logits = b64 @ Xb.T
    lr_lp_ref = (np.sum(y64 * logits - np.logaddexp(0.0, logits), axis=1)
                 - 0.5 * inv_s2 * np.sum(b64 * b64, axis=1))
    lr_g_ref = (y64 - 1.0 / (1.0 + np.exp(-logits))) @ Xb - inv_s2 * b64
    lp, g = jax.jit(jax.vmap(logistic.logp_grad))(jnp.asarray(b))
    errors["logistic_logp"] = _rel_err(lp, lr_lp_ref)
    errors["logistic_grad"] = _rel_err(g, lr_g_ref)

    # A user's log-density, written without any precision pin.
    prec_dev = jnp.asarray(prec, jnp.float32)

    def user_logp(x):
        return -0.5 * x @ prec_dev @ x

    user_g_ref = -0.5 * q64 @ (prec + prec.T)
    for tag, ctx in (("default", None), ("highest", "highest")):
        vg = jax.vmap(jax.value_and_grad(user_logp))
        if ctx is None:
            lp, g = jax.jit(vg)(jnp.asarray(q))
        else:
            with jax.default_matmul_precision(ctx):
                lp, g = jax.jit(vg)(jnp.asarray(q))
        errors[f"user_{tag}_logp"] = _rel_err(lp, lp_ref)
        errors[f"user_{tag}_grad"] = _rel_err(g, user_g_ref)

    for name, err in errors.items():
        print(f"[{card}] model evaluation: {name} max relative error {err:.3e}",
              flush=True)
    require("model evaluation", errors,
            {k: (None, MODEL_TOL) for k in errors if "default" not in k})
    return errors


def _peak_bytes(devices) -> int | None:
    stats = [d.memory_stats() for d in devices]
    if any(s is None for s in stats):
        return None  # the CPU backend keeps no allocator statistics
    return max(int(s.get("peak_bytes_in_use", 0)) for s in stats)


def _convergence(trace: np.ndarray):
    """(max split R-hat, min bulk ESS) over the parameters of a
    ``(chains, draws, ndim)`` trace; one rank normalization per parameter."""
    from littlemcmc_tpu.utils.diagnostics import _rank_normalize, ess_bulk, split_rhat

    def one(i):
        z = _rank_normalize(trace[:, :, i])
        return (split_rhat(z, rank_normalized=False),
                ess_bulk(z, rank_normalized=False))

    with ThreadPoolExecutor(8) as pool:
        res = list(pool.map(one, range(trace.shape[2])))
    return max(r[0] for r in res), min(r[1] for r in res)


def run_sampler(card: str, label: str, model, *, chains: int, tune: int,
                draws: int, seed: int, devices, **kwargs):
    """One warm ``sample()`` call, then one timed call with the same
    arguments; print and return the timed call's row and final state."""
    import littlemcmc_tpu as lmc

    args = dict(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
                chains=chains, tune=tune, draws=draws, random_seed=seed,
                progressbar=False, return_final_state=True, **kwargs)
    t0 = time.perf_counter()
    lmc.sample(**args)
    first = time.perf_counter() - t0
    report = {}
    t0 = time.perf_counter()
    trace, stats, final = lmc.sample(perf_report=report, **args)
    wall = time.perf_counter() - t0

    max_rhat, min_ess = _convergence(trace)
    row = {
        "engine": report["engine"],
        "first_call_seconds": first,
        "wall_seconds": wall,
        "sample_seconds": report["sample_seconds"],
        "transfer_seconds": report["transfer_seconds"],
        "transitions_per_second": chains * (tune + draws) / report["sample_seconds"],
        "min_ess_bulk": min_ess,
        "max_rhat": max_rhat,
        "divergence_rate": float(np.mean(stats["diverging"])),
        "peak_bytes_in_use": _peak_bytes(devices),
    }
    # Leapfrogs per draw phase transition: the mean a chain needs, and
    # the lock-step count the batch executes (the deepest chain's).
    steps = np.asarray(stats["tree_size"] if "tree_size" in stats
                       else stats["n_steps"], np.float64)
    row["mean_leapfrogs"] = float(steps.mean())
    row["mean_lockstep_leapfrogs"] = float(steps.max(axis=0).mean())
    if getattr(model, "true_var", None) is not None:
        var = trace.reshape(-1, model.ndim).var(axis=0)
        row["var_ratio_mean"] = float(np.mean(var / model.true_var))
    print(f"[{card}] {label}: engine {row['engine']}; first call (compile + run) "
          f"{first} s; timed call {wall} s: sample_seconds {row['sample_seconds']}, "
          f"transfer_seconds {row['transfer_seconds']}, transitions/s "
          f"{row['transitions_per_second']}", flush=True)
    print(f"{label}: min bulk ESS {min_ess}; max split R-hat {max_rhat}; "
          f"divergence rate {row['divergence_rate']}; var ratio "
          f"{row.get('var_ratio_mean')}; peak_bytes_in_use "
          f"{row['peak_bytes_in_use']}; draw-phase leapfrogs per transition: "
          f"mean {row['mean_leapfrogs']}, lock-step {row['mean_lockstep_leapfrogs']}",
          flush=True)
    return row, final


def phase_progress(card: str, model, *, chains: int, tune: int, draws: int) -> int:
    """A short run with ``progressbar=True``: the in-scan host callback
    must report progress. Returns the number of progress log lines."""
    import littlemcmc_tpu as lmc

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            msg = record.getMessage()
            if "iterations" in msg:
                self.lines.append(msg)
                print(f"progress: {msg.strip()}", flush=True)

    log = logging.getLogger("littlemcmc_tpu")
    handler, level = Lines(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        lmc.sample(logp_dlogp_func=model.logp_grad, model_ndim=model.ndim,
                   chains=chains, tune=tune, draws=draws, random_seed=1,
                   progressbar=True, compute_convergence_checks=False)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    print(f"[{card}] live progress: run with compile {wall} s", flush=True)
    if sys.stderr.isatty():
        print("live progress: rendered as a bar on the terminal", flush=True)
        return len(handler.lines)
    expected = (tune + draws) // 25
    require("live progress", {"progress_lines": len(handler.lines)},
            {"progress_lines": (expected, None)})
    return len(handler.lines)


def pooled_spread(final) -> float:
    """Largest difference between any chain's dense metric and chain 0's."""
    cov = np.asarray(final.potential.cov)
    return float(np.max(np.abs(cov - cov[:1])))


def one_card(card: str, devices, *, ndim: int = FLAGSHIP["ndim"],
             chains: int = FLAGSHIP["chains"], tune: int = FLAGSHIP["tune"],
             draws: int = FLAGSHIP["draws"], hmc_chains: int = 10240,
             hmc_tune: int = 500, hmc_draws: int = 500, n_points: int = 1024) -> None:
    """Phases 2-6 on one card, at the flagship sizes by default."""
    from littlemcmc_tpu import models

    import littlemcmc_tpu as lmc

    phase_models(card, n_points=n_points)
    gauss = models.CorrelatedGaussian(ndim)
    common = dict(chains=chains, tune=tune, draws=draws, seed=FLAGSHIP["seed"],
                  devices=devices)
    row, _ = run_sampler(card, "flagship NUTS diag", gauss,
                         init="jitter+adapt_diag", **common)
    require("flagship NUTS diag", row, NUTS_GATES)
    row, final = run_sampler(card, "flagship NUTS pooled dense", gauss,
                             init="jitter+adapt_full", **common)
    require("flagship NUTS pooled dense", dict(row, pooled_spread=pooled_spread(final)),
            dict(NUTS_GATES, pooled_spread=(0.0, 0.0)))
    schools = models.EightSchools()
    row, _ = run_sampler(card, "eight schools HMC", schools, chains=hmc_chains,
                         tune=hmc_tune, draws=hmc_draws, seed=FLAGSHIP["seed"],
                         devices=devices,
                         step=lmc.HamiltonianMC(model_ndim=schools.ndim,
                                                target_accept=0.95))
    require("eight schools HMC", row, HMC_GATES)
    phase_progress(card, gauss, chains=chains, tune=50, draws=50)


def four_cards(card: str, devices, *, chains: int = 4096, model_chains: int = 1024,
               tune: int = FLAGSHIP["tune"], draws: int = FLAGSHIP["draws"],
               ndim: int = FLAGSHIP["ndim"]) -> None:
    """The flagship dense job sharded over four cards against one card, and
    a 2 x 2 ``("chains", "model")`` mesh with the metric row-sharded."""
    import jax
    from jax.sharding import Mesh

    from littlemcmc_tpu import models
    from littlemcmc_tpu.parallel import chain_mesh, cross_chain_potential_pool

    import littlemcmc_tpu as lmc

    gauss = models.CorrelatedGaussian(ndim)
    common = dict(chains=chains, tune=tune, draws=draws, seed=FLAGSHIP["seed"],
                  init="jitter+adapt_full", cross_chain_adapt=True)
    row4, final4 = run_sampler(card, f"{chains}-chain pooled dense on 4 cards",
                               gauss, mesh=chain_mesh(4), devices=devices[:4],
                               **common)
    row1, final1 = run_sampler(card, f"{chains}-chain pooled dense on 1 card",
                               gauss, devices=devices[:1], **common)
    cov4 = np.asarray(final4.potential.cov)[0]
    cov1 = np.asarray(final1.potential.cov)[0]
    # The pooled sum adds in another order on four cards (local sums, then
    # one all-reduce) than on one; that changes the metric in its last
    # bits, and over hundreds of draws the chains of the two runs separate.
    # So the runs' covariances agree only to Monte Carlo error (printed),
    # and the 1e-4 gate holds the same per-chain Welford state pooled on
    # four cards and on one card.
    repooled = cross_chain_potential_pool(
        jax.device_put(final4.potential, devices[0]), True)
    cov_same_state = np.asarray(repooled.cov)[0]
    checks = {
        "pooled_spread_4_cards": pooled_spread(final4),
        "pooled_spread_1_card": pooled_spread(final1),
        "cov_rel_diff_same_state": float(
            np.max(np.abs(cov4 - cov_same_state)) / np.max(np.abs(cov_same_state))),
        "cov_rel_diff_runs": float(np.max(np.abs(cov4 - cov1)) / np.max(np.abs(cov1))),
    }
    print(f"four cards vs one card: {checks}", flush=True)
    require("4 cards", row4, NUTS_GATES)
    require("1 card", row1, NUTS_GATES)
    require("pooled metric", checks, {
        "pooled_spread_4_cards": (0.0, 0.0),
        "pooled_spread_1_card": (0.0, 0.0),
        "cov_rel_diff_same_state": (None, 1e-4),
    })

    mesh2 = Mesh(np.array(devices[:4]).reshape(2, 2), ("chains", "model"))
    t0 = time.perf_counter()
    trace, _, final = lmc.sample(
        logp_dlogp_func=gauss.logp_grad, model_ndim=ndim, chains=model_chains,
        tune=tune, draws=draws, random_seed=FLAGSHIP["seed"],
        init="jitter+adapt_full", mesh=mesh2, model_axis="model",
        progressbar=False, return_final_state=True)
    wall = time.perf_counter() - t0
    spec = tuple(final.potential.cov.sharding.spec)
    print(f"[{card}] 2 x 2 chains x model mesh: {model_chains} chains, run with "
          f"compile {wall} s; cov sharding spec {spec}", flush=True)
    require("2 x 2 mesh", {"model_axis_in_spec": float("model" in spec),
                           "finite_trace": float(np.isfinite(trace).all())},
            {"model_axis_in_spec": (1.0, 1.0), "finite_trace": (1.0, 1.0)})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path, on four cards")
    opts = parser.parse_args(argv)

    devices = check_device(4 if opts.four_cards else 1)

    from littlemcmc_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = card_label()
    print(f"nvidia-smi: {card}", flush=True)

    if opts.four_cards:
        four_cards(card, devices)
    else:
        one_card(card, devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
