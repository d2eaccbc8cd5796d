"""Sampling driver: the public ``sample()`` / ``init_nuts()`` entry points.

Re-architecture of the reference's ``littlemcmc/sampling.py`` and
``parallel_sampling.py`` for accelerators. The reference runs chains as OS processes in
a lock-step pipe protocol (one Python ``_astep`` per draw per chain,
``parallel_sampling.py:161-200``); here *all* chains advance together as
one ``lax.scan`` over draws of a ``vmap``-ed transition kernel, compiled
once by XLA, optionally sharded over a ``chains`` mesh axis so the same
program runs on one device or a multi-host mesh. The host only sees the
final ``(chains, draws, ndim)`` trace and ``(chains, draws)`` stats.

Output shapes and stats names match the reference (``sampling.py:207-220``).

Note the reference's multiprocessing path is broken (draws never leave the
worker's shared-memory buffer — see SURVEY.md §2); parity targets are the
reference's sequential (``cores=1``) path.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .base import HMCConfig, NUTSConfig, init_chain_state
from .hmc import build_hmc_kernel
from .model import as_logp_grad
from .nuts import build_nuts_kernel
from .quadpotential import (
    QuadPotentialDiag,
    QuadPotentialDiagAdapt,
    QuadPotentialFullAdapt,
    QuadPotentialLowRankAdapt,
    isquadpotential,
    quad_potential,
)

__all__ = ["NUTS", "HamiltonianMC", "sample", "init_nuts"]

_log = logging.getLogger("littlemcmc_tpu")

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


class _StepSpec:
    """Base for user-facing step-method specs.

    Unlike the reference's stateful step objects (``base_hmc.py:29``),
    these are pure *specifications*: a frozen kernel config plus an
    optional metric. All mutable sampler state lives in the ``ChainState``
    pytree owned by the driver.
    """

    def __init__(
        self,
        logp_dlogp_func=None,
        model_ndim: Optional[int] = None,
        scaling=None,
        is_cov: bool = False,
        potential=None,
    ):
        if scaling is not None and potential is not None:
            raise ValueError("Cannot specify both `potential` and `scaling`.")
        if potential is not None and not isquadpotential(potential):
            raise ValueError("`potential` must be a littlemcmc_tpu quadpotential.")
        self.potential = (
            potential if potential is not None else (
                quad_potential(scaling, is_cov) if scaling is not None else None
            )
        )
        self.logp_dlogp_func = logp_dlogp_func
        self.model_ndim = model_ndim
        # last-run outputs stashed by sample() so the reference's
        # ``step.warnings()`` call pattern works unmodified
        self._last_stats = None
        self._last_tune = 0
        self._last_trace = None

    def warnings(self, stats=None, *, tune=None, trace=None):
        """End-of-run sampler warnings — reference ``step.warnings()`` shim.

        The reference's stateful step objects accumulate warnings during
        sampling and expose them via ``step.warnings()``
        (``base_hmc.py:202-230``, ``nuts.py:226-238``). These specs are
        stateless, so ``sample()`` stashes its assembled stats/trace on
        the spec after each run; calling ``step.warnings()`` with no
        arguments reproduces the reference behavior on the most recent
        run. Pass ``stats`` (a ``{name: (chains, draws)}`` dict as
        returned by ``sample()``) to check any other run; ``tune`` marks
        leading tuning columns to exclude and ``trace`` enables the
        R-hat convergence check.
        """
        from .report import warnings_from_stats

        if stats is None:
            stats = self._last_stats
            if stats is None:
                return []
            if tune is None:
                tune = self._last_tune
            if trace is None:
                trace = self._last_trace
        return warnings_from_stats(
            stats,
            target_accept=self.config.target_accept,
            max_treedepth=getattr(self.config, "max_treedepth", None),
            tune=int(tune or 0),
            trace=trace,
        )


class NUTS(_StepSpec):
    """No-U-Turn sampler spec (constructor parity with reference ``nuts.py:103-121``)."""

    name = "nuts"
    generates_stats = True
    stats_dtypes = [
        {
            "depth": np.int64,
            "step_size": np.float64,
            "tune": np.bool_,
            "mean_tree_accept": np.float64,
            "step_size_bar": np.float64,
            "tree_size": np.float64,
            "diverging": np.bool_,
            "energy_error": np.float64,
            "energy": np.float64,
            "max_energy_error": np.float64,
            "model_logp": np.float64,
            "reached_max_treedepth": np.bool_,
        }
    ]

    def __init__(
        self,
        logp_dlogp_func=None,
        model_ndim: Optional[int] = None,
        scaling=None,
        is_cov: bool = False,
        potential=None,
        target_accept: float = 0.8,
        Emax: float = 1000,
        adapt_step_size: bool = True,
        step_scale: float = 0.25,
        gamma: float = 0.05,
        k: float = 0.75,
        t0: int = 10,
        step_rand=None,
        path_length: float = 2.0,
        max_treedepth: int = 10,
        early_max_treedepth: int = 8,
        integrator: str = "leapfrog",
        batched_logp_dlogp_func=None,
    ):
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential)
        del path_length  # accepted for constructor parity; NUTS does not use it
        # Optional natively-batched (C, n) -> ((C,), (C, n)) model;
        # overrides vmap of the per-chain model.
        self.batched_logp_dlogp_func = batched_logp_dlogp_func
        self.config = NUTSConfig(
            target_accept=float(target_accept),
            Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size),
            step_scale=float(step_scale),
            gamma=float(gamma),
            k=float(k),
            t0=float(t0),
            step_rand=step_rand,
            max_treedepth=int(max_treedepth),
            early_max_treedepth=int(early_max_treedepth),
            integrator=str(integrator),
        )

    def build_kernel(self, logp_grad_fn: LogpGradFn):
        return build_nuts_kernel(
            logp_grad_fn, self.config, self.batched_logp_dlogp_func)


class HamiltonianMC(_StepSpec):
    """Classic HMC spec (constructor parity with reference ``hmc.py:52-69``)."""

    name = "hmc"
    generates_stats = True
    stats_dtypes = [
        {
            "step_size": np.float64,
            "n_steps": np.int64,
            "tune": np.bool_,
            "step_size_bar": np.float64,
            "accept": np.float64,
            "diverging": np.bool_,
            "energy_error": np.float64,
            "energy": np.float64,
            "path_length": np.float64,
            "accepted": np.bool_,
            "model_logp": np.float64,
        }
    ]

    def __init__(
        self,
        logp_dlogp_func=None,
        model_ndim: Optional[int] = None,
        scaling=None,
        is_cov: bool = False,
        potential=None,
        target_accept: float = 0.8,
        Emax: float = 1000,
        adapt_step_size: bool = True,
        step_scale: float = 0.25,
        gamma: float = 0.05,
        k: float = 0.75,
        t0: int = 10,
        step_rand=None,
        path_length: float = 2.0,
        max_steps: int = 1024,
        integrator: str = "leapfrog",
    ):
        super().__init__(logp_dlogp_func, model_ndim, scaling, is_cov, potential)
        self.config = HMCConfig(
            target_accept=float(target_accept),
            Emax=float(Emax),
            adapt_step_size=bool(adapt_step_size),
            step_scale=float(step_scale),
            gamma=float(gamma),
            k=float(k),
            t0=float(t0),
            step_rand=step_rand,
            path_length=float(path_length),
            max_steps=int(max_steps),
            integrator=str(integrator),
        )

    def build_kernel(self, logp_grad_fn: LogpGradFn):
        return build_hmc_kernel(logp_grad_fn, self.config)


def _make_adaptive_potential(ndim: int, mean: jax.Array, kind, dtype):
    """Default adaptive metric as built by ``init_nuts`` (``sampling.py:578-597``).

    ``kind`` is ``"diag"`` / ``"full"`` / ``"lowrank"`` (a bool is accepted
    as the legacy full-vs-diag switch).
    """
    if isinstance(kind, bool):
        kind = "full" if kind else "diag"
    if kind == "full":
        return QuadPotentialFullAdapt.create(
            ndim, initial_mean=mean, initial_cov=jnp.eye(ndim, dtype=dtype),
            initial_weight=10.0, dtype=dtype,
        )
    if kind == "lowrank":
        return QuadPotentialLowRankAdapt.create(
            ndim, initial_mean=mean, initial_diag=jnp.ones(ndim, dtype=dtype),
            initial_weight=10.0, dtype=dtype,
        )
    return QuadPotentialDiagAdapt.create(
        ndim, initial_mean=mean, initial_diag=jnp.ones(ndim, dtype=dtype),
        initial_weight=10.0, dtype=dtype,
    )


def _init_metric_kind(init_l: str) -> str:
    """Metric kind from a (lowercased) init-method string."""
    if init_l.endswith("adapt_full"):
        return "full"
    if init_l.endswith("adapt_lowrank"):
        return "lowrank"
    return "diag"


_INIT_METHODS = (
    "adapt_diag", "jitter+adapt_diag",
    "adapt_full", "jitter+adapt_full",
    "adapt_lowrank", "jitter+adapt_lowrank",
)


def init_nuts(
    logp_dlogp_func=None,
    model_ndim: Optional[int] = None,
    init: str = "auto",
    random_seed: Union[None, int, List[int]] = None,
    logp_fn=None,
    dtype=jnp.float32,
    **kwargs,
):
    """Set up mass-matrix initialization for NUTS (reference ``sampling.py:524-605``).

    Returns ``(start, step)`` where ``start`` is a single ``(ndim,)``
    starting point and ``step`` is a :class:`NUTS` spec carrying the
    adaptive potential. ``sample()`` itself jitters *per chain* (an
    improvement over the reference, which reuses one jittered start for
    every chain — ``sampling.py:163-164``).
    """
    if not isinstance(init, str):
        raise TypeError("init must be a string.")
    init = init.lower()
    if init == "auto":
        init = "jitter+adapt_diag"
    _log.info("Initializing NUTS using %s...", init)

    if init not in _INIT_METHODS:
        raise ValueError("Unknown initializer: {}.".format(init))

    if model_ndim is None:
        raise ValueError("model_ndim is required.")

    seed = _as_seed(random_seed)
    key = jax.random.key(seed)
    jitter = init.startswith("jitter")
    kind = _init_metric_kind(init)

    if jitter:
        start = 2.0 * jax.random.uniform(key, (model_ndim,), dtype) - 1.0
    else:
        start = jnp.zeros(model_ndim, dtype)

    if logp_fn is not None:
        if logp_dlogp_func is not None:
            raise ValueError(
                "Provide exactly one of `logp_dlogp_func` or `logp_fn`.")
        # normalize a plain scalar log-density into the (logp, grad) pair
        # the spec carries (autodiffed; memoized per function object)
        logp_dlogp_func = as_logp_grad(logp_fn=logp_fn)

    potential = _make_adaptive_potential(model_ndim, start, kind, dtype)
    step = NUTS(
        logp_dlogp_func=logp_dlogp_func,
        model_ndim=model_ndim,
        potential=potential,
        **kwargs,
    )
    return start, step


def _as_seed(random_seed) -> int:
    if random_seed is None:
        return int(np.random.randint(2 ** 30))
    if isinstance(random_seed, (int, np.integer)):
        return int(random_seed)
    # A list of per-chain seeds; callers that need one master seed
    # (init_nuts' single start point) take the first. sample() itself
    # honors the full list via _resolve_chain_keys.
    return int(np.atleast_1d(np.asarray(random_seed))[0])


def _resolve_chain_keys(random_seed, chains: int):
    """Per-chain ``(init_keys, chain_keys)`` from a seed or seed list.

    Mirrors the reference's per-chain seed semantics
    (``sampling.py:131-138``): a list must carry one seed per chain, and
    each chain's RNG stream derives from its own seed only — so a user
    pinning ``random_seed=[1, 2, 3, 4]`` gets four independent,
    individually-reproducible streams.
    """
    is_scalar_seed = (
        random_seed is None
        or isinstance(random_seed, (int, np.integer))
        or np.ndim(random_seed) == 0  # 0-d ndarray: a master seed too
    )
    if not is_scalar_seed:
        seeds = np.asarray(random_seed).ravel()
        if seeds.size != chains:
            raise ValueError(
                "random_seed must be an int or a sequence with one seed per "
                f"chain ({chains}); got {seeds.size} seeds."
            )
        base = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    else:
        key = jax.random.key(_as_seed(random_seed))
        base = jax.random.split(key, chains)
    pairs = jax.vmap(lambda k: jax.random.split(k, 2))(base)
    return pairs[:, 0], pairs[:, 1]


def _broadcast_potential(potential, chains: int):
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (chains,) + jnp.shape(x)), potential
    )


@functools.lru_cache(maxsize=256)
def _make_init_fn(config, logp_grad, model_ndim: int, kind, dtype, has_potential: bool):
    """Jitted, vmapped per-chain state initializer (cached per config)."""
    if has_potential:
        def init_one(k, q0, pot):
            return init_chain_state(k, q0, pot, config, logp_grad)
    else:
        def init_one(k, q0):
            pot = _make_adaptive_potential(model_ndim, q0, kind, dtype)
            return init_chain_state(k, q0, pot, config, logp_grad)

    return jax.jit(jax.vmap(init_one))


class _ProgressSink:
    """Host-side receiver for in-scan live progress callbacks.

    On a TTY this renders an in-place progress bar with a live
    divergence counter (the reference's fastprogress bar,
    ``parallel_sampling.py:438-445``); otherwise it falls back to log
    lines.
    """

    def __init__(self, chains: int, tune: int, draws: int):
        self.chains = chains
        self.tune = tune
        self.draws = draws
        self.t0 = time.perf_counter()

    def emit(self, done: int, ndiv: int, tuning: bool) -> None:
        _emit_progress(self.chains, done, self.tune + self.draws, tuning,
                       ndiv, self.t0, final=done >= self.tune + self.draws)


def _stderr_is_tty() -> bool:
    import sys

    try:
        return sys.stderr.isatty()
    except Exception:
        return False


def _emit_progress(chains: int, done: int, total: int, tuning: bool,
                   ndiv: int, t0: float, final: bool = False) -> None:
    """One progress update: in-place bar on TTYs, log line otherwise."""
    rate = chains * done / max(time.perf_counter() - t0, 1e-9)
    phase = "tuning" if tuning else "sampling"
    if _stderr_is_tty():
        import sys

        width = 28
        filled = int(width * done / max(total, 1))
        bar = "█" * filled + "░" * (width - filled)
        sys.stderr.write(
            f"\r|{bar}| {done}/{total} [{phase}] "
            f"{ndiv} divergences, {rate:,.0f} transitions/s  "
        )
        if final:
            sys.stderr.write("\n")
        sys.stderr.flush()
    else:
        _log.info(
            "  %d/%d iterations (%s), %d divergences, %.0f transitions/s",
            done, total, phase, ndiv, rate,
        )


@functools.lru_cache(maxsize=256)
def _make_runner(kernel, tune: int, draws: int, collect_tune: bool,
                 cross_chain_adapt: bool = False, live_every: int = 0):
    """Jitted two-phase (tune, draw) scan over the vmapped kernel.

    Cached on the kernel object (itself memoized per ``(model, config)``)
    plus the phase lengths, so repeated ``sample()`` calls with identical
    shapes hit jax's jit cache instead of recompiling.

    ``live_every > 0`` emits a host progress callback (iteration count,
    running divergence total) every that-many draws from *inside* the
    compiled scan — per-draw-granular progress with no chunking and no
    recompiles (the reference's live bar, ``sampling.py:455-469``).

    Returns ``(run, sink_box)``: the callbacks read their
    :class:`_ProgressSink` from ``sink_box[0]`` (a per-runner holder the
    caller installs before running and clears after). A holder per
    runner — not a module global — so concurrent ``sample()`` calls with
    different kernels/shapes keep separate progress state.
    """
    from .parallel.cross_chain import cross_chain_potential_pool

    batched_kernel = kernel  # kernels are chain-batched by construction

    sink_box: list = [None]

    def _emit_tune_progress(i, ndiv):
        s = sink_box[0]
        if s is not None:
            s.emit(int(i) + 1, int(ndiv), tuning=True)

    def _emit_draw_progress(i, ndiv):
        s = sink_box[0]
        if s is not None:
            s.emit(s.tune + int(i) + 1, int(ndiv), tuning=False)

    def phase(states, ndiv0, n_steps: int, tuning: bool, collect: bool,
              emit_fn):
        def body(carry, i):
            s, ndiv = carry
            s2, info = batched_kernel(s, jnp.asarray(tuning))
            if cross_chain_adapt and tuning:
                s2 = s2.replace(
                    potential=cross_chain_potential_pool(
                        s2.potential, jnp.asarray(tuning), samples=s2.q)
                )
            # dtype pinned: under enable_x64 a bare sum(bool) is int64,
            # which breaks the int32 scan carry (f64 + chunked execution)
            ndiv = ndiv + jnp.sum(info.diverging, dtype=jnp.int32).astype(jnp.int32)
            if live_every:
                # also emit at the phase end so the tune->draw boundary
                # never opens a gap wider than live_every draws
                lax.cond(
                    ((i + 1) % live_every == 0) | (i == n_steps - 1),
                    lambda: jax.debug.callback(emit_fn, i, ndiv),
                    lambda: None,
                )
            return (s2, ndiv), ((s2.q, info) if collect else None)

        (states2, ndiv), out = lax.scan(
            body, (states, ndiv0), jnp.arange(n_steps))
        return states2, ndiv, out

    @jax.jit
    def run(states):
        zero = jnp.asarray(0, jnp.int32)
        states, ndiv, tune_out = phase(
            states, zero, tune, True, collect_tune, _emit_tune_progress)
        states, _, draw_out = phase(
            states, ndiv, draws, False, True, _emit_draw_progress)
        return states, tune_out, draw_out

    return run, sink_box


@functools.lru_cache(maxsize=256)
def _make_chunk_runner(kernel, chunk: int, tuning: bool, collect: bool,
                       cross_chain_adapt: bool):
    """Jitted ``chunk``-draw scan segment, for progress/checkpoint loops.

    Returns ``(states, outputs_or_None, divergence_count)``.
    """
    from .parallel.cross_chain import cross_chain_potential_pool

    batched_kernel = kernel  # kernels are chain-batched by construction

    @jax.jit
    def run_chunk(states):
        def body(carry, _):
            s, ndiv = carry
            s2, info = batched_kernel(s, jnp.asarray(tuning))
            if cross_chain_adapt and tuning:
                s2 = s2.replace(
                    potential=cross_chain_potential_pool(
                        s2.potential, jnp.asarray(tuning), samples=s2.q)
                )
            # dtype pinned: under enable_x64 a bare sum(bool) is int64,
            # which breaks the int32 scan carry (f64 + chunked execution)
            ndiv = ndiv + jnp.sum(info.diverging, dtype=jnp.int32)
            return (s2, ndiv), ((s2.q, info) if collect else None)

        (states2, ndiv), out = lax.scan(
            body, (states, jnp.asarray(0, jnp.int32)), length=chunk
        )
        return states2, out, ndiv

    return run_chunk


# chain count at which adapt_full / adapt_lowrank auto-promote to
# cross-chain pooled adaptation
_POOLED_PROMOTE_CHAINS = 128


def _run_chunked(
    kernel,
    states,
    tune: int,
    draws: int,
    collect_tune: bool,
    cross_chain_adapt: bool,
    *,
    progress_every: int,
    checkpoint_dir: Optional[str],
    checkpoint_every: Optional[int],
    resume: bool,
    chains: int,
    callback=None,
    quiet: bool = False,
):
    """Chunked execution with live progress and optional checkpoint/resume.

    The counterpart of the reference's per-draw progress loop
    (``sampling.py:455-469``) and the recovery story its multiprocessing
    runtime lacks: the scan runs in jitted chunks, and between chunks the
    host logs progress (with a live divergence counter) and can snapshot
    the full sampler state. Resuming continues bit-identically; draws
    already collected before the restored step are not re-emitted.
    """
    total = tune + draws
    done = 0
    n_div_total = 0

    if resume:
        if not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        from .utils.checkpoint import latest_checkpoint, restore_checkpoint

        path = latest_checkpoint(checkpoint_dir)
        if path is not None:
            states, meta = restore_checkpoint(path, states)
            done = int(meta.get("step", 0))
            n_div_total = int(meta.get("n_divergences", 0))
            _log.info("Resumed from %s at iteration %d/%d.", path, done, total)

    outs = []
    t0 = time.perf_counter()
    next_progress = done + progress_every
    next_checkpoint = done + checkpoint_every if (checkpoint_dir and checkpoint_every) else None
    # Uniform stepping: every distinct chunk length compiles its own scan
    # program, so interleaved progress/checkpoint intervals would
    # otherwise trigger a compile per interval combination. Stepping by
    # gcd(intervals) keeps the set of chunk lengths to at most the base
    # plus one phase-boundary remainder per phase.
    if next_checkpoint is not None:
        import math as _math

        base_step = _math.gcd(progress_every, checkpoint_every)
        if base_step < 25:
            # Coprime-ish intervals would degrade to per-draw dispatch;
            # step by the smaller interval instead and let the larger one
            # fire (slightly late) on the `done >= next_*` checks below.
            base_step = min(progress_every, checkpoint_every)
    else:
        base_step = progress_every

    # The divergence counter stays on device between sync points: an
    # int() per chunk waits for the device, so it is only materialized
    # when a progress line, checkpoint, or callback needs the value.
    n_div_dev = jnp.asarray(n_div_total, jnp.int32)
    try:
        while done < total:
            tuning = done < tune
            phase_end = tune if tuning else total
            stop = min(phase_end, done + base_step)
            chunk = stop - done
            collect = collect_tune if tuning else True

            runner = _make_chunk_runner(kernel, chunk, tuning, collect,
                                        cross_chain_adapt)
            states, out, ndiv = runner(states)
            if collect:
                outs.append(out)
            n_div_dev = n_div_dev + ndiv
            done += chunk

            due_progress = next_progress is not None and done >= next_progress
            due_checkpoint = next_checkpoint is not None and done >= next_checkpoint
            if callback is not None or due_checkpoint or (due_progress and not quiet):
                jax.block_until_ready(states)
                n_div_total = int(n_div_dev)

            if callback is not None:
                # Per-chunk callback (the reference's per-draw callback hook,
                # ``sampling.py:307-308``, amortized over the chunk).
                callback(iteration=done, tuning=tuning, states=states,
                         chunk=out, n_divergences=n_div_total)

            if next_progress is not None and done >= next_progress:
                if not quiet:
                    _emit_progress(chains, done, total, done <= tune,
                                   n_div_total, t0, final=done >= total)
                next_progress = done + progress_every
            if next_checkpoint is not None and done >= next_checkpoint:
                from .utils.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_dir, states, done,
                    meta={"n_divergences": n_div_total, "tune": tune, "draws": draws},
                )
                next_checkpoint = done + checkpoint_every
    except KeyboardInterrupt:
        # Return the chunks collected so far, like the reference's
        # sequential interrupt path (``sampling.py:463-471``) — and unlike
        # its multiprocessing path, which returns None. An on-device chunk
        # cannot be interrupted midway, but completed ones survive. The
        # loop locals (`states`, `outs`, `done`) hold the last *completed*
        # chunk's values: a mid-dispatch or mid-callback interrupt leaves
        # them one chunk behind the in-flight work, never inconsistent.
        jax.block_until_ready(states)
        _log.warning(
            "Sampling interrupted at iteration %d/%d: returning the %d "
            "compiled chunk(s) collected so far.", done, total, len(outs),
        )
        if checkpoint_dir:
            from .utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_dir, states, done,
                meta={"n_divergences": int(n_div_dev),
                      "tune": tune, "draws": draws},
            )
            _log.warning("Saved an interrupt checkpoint at iteration %d to %r.",
                         done, checkpoint_dir)

    jax.block_until_ready(states)  # callers time/serialize right after
    return states, outs


def sample(
    logp_dlogp_func=None,
    model_ndim: Optional[int] = None,
    draws: int = 1000,
    tune: int = 1000,
    step: Union[NUTS, HamiltonianMC, None] = None,
    init: str = "auto",
    chains: Optional[int] = None,
    cores: Optional[int] = None,
    start=None,
    progressbar: Union[bool, str] = True,
    random_seed: Optional[Union[int, List[int]]] = None,
    discard_tuned_samples: bool = True,
    chain_idx: int = 0,
    callback=None,
    logp_fn=None,
    mp_ctx=None,
    pickle_backend: str = "pickle",
    mesh: Optional[Mesh] = None,
    chain_axis: str = "chains",
    model_axis: Optional[str] = None,
    dtype=jnp.float32,
    cross_chain_adapt: Optional[bool] = None,
    return_final_state: bool = False,
    progress_every: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    compute_convergence_checks: bool = True,
    perf_report: Optional[dict] = None,
    **kwargs,
):
    """Draw posterior samples with NUTS (default) or HMC, fully on device.

    Signature-compatible in spirit with the reference ``sample()``
    (``sampling.py:35-53``). Differences, all from running the chains
    as one vectorized program on an accelerator:

    - ``cores`` is accepted but ignored: chains are vectorized on device
      (``vmap``) rather than forked into OS processes; use ``chains`` (and
      optionally ``mesh``) to scale.
    - ``mesh``: a ``jax.sharding.Mesh`` with a ``chain_axis`` axis; the
      chain batch is sharded over it (single- or multi-host). ``chains``
      must be divisible by that axis' size.
    - ``model_axis``: name of a *second* mesh axis for large-``ndim``
      dense metrics: every O(ndim²) metric matrix (adapted covariance,
      Cholesky, Welford buffers) is row-sharded over it, so an ``n``-dim
      ``adapt_full`` run stores ``n²/m`` metric floats per device
      instead of ``n²`` (the reference holds the dense metric whole on
      one core, ``quadpotential.py:507-524``). Metric matvecs partition
      cleanly (GSPMD inserts one psum per kinetic-energy reduction);
      the per-refresh Cholesky is gathered. State vectors stay
      replicated across this axis.
    - ``logp_fn``: alternatively to ``logp_dlogp_func``, a scalar JAX
      log-density, differentiated with ``jax.value_and_grad``.
    - ``cross_chain_adapt``: pool Welford mass-matrix statistics across
      *all* chains each tuning step (collectives over the mesh) — a
      strict extension the reference's per-process chains cannot do.
    - ``callback``: invoked between compiled chunks with
      ``(iteration, tuning, states, chunk, n_divergences)`` — the
      reference's per-draw hook (``sampling.py:307-308``) amortized over
      the chunk. For the strict per-draw contract set
      ``progress_every=1`` (one compiled step per call; pays a dispatch
      round trip per draw — fine for debugging, not for throughput).
    - models must be JAX-traceable; wrap host callables with
      :func:`littlemcmc_tpu.model.from_numpy_callable`.
    - ``perf_report``: pass a dict and ``sample()`` fills it with the
      configuration that ran (``engine``: sampler and metric, e.g.
      ``nuts_dense_pooled``; ``chunk``: draws per compiled segment, or
      ``None`` for one program) and timing split into ``sample_seconds``
      (device sampling, compile included on first use — warm the jit
      caches with a short run first for steady-state numbers) and
      ``transfer_seconds`` (device→host trace/stats fetch).
    - ``compute_convergence_checks``: run the end-of-run warning checks
      (divergences, acceptance, BFMI, and — for traces under 50M
      elements — split R-hat) and log them, like the reference's
      ``step.warnings()`` consumed by its driver (``base_hmc.py:202``).
      ``False`` skips all host-side post-processing.

    Returns ``(trace, stats)``: ``trace`` has shape ``(chains, draws,
    model_ndim)``; ``stats`` maps stat names to ``(chains, draws)`` arrays
    with the reference's dtypes (``nuts.py:87-101``, ``hmc.py:36-50``).
    """
    # Accepted for signature parity with the reference (``sampling.py:48-51``);
    # meaningless here: there are no worker processes to seed or pickle into.
    del chain_idx, mp_ctx, pickle_backend
    if cores is not None:
        _log.info("`cores` is ignored; chains are vectorized on device.")
    if chains is None:
        chains = 4
    if model_ndim is None:
        if step is not None and step.model_ndim is not None:
            model_ndim = step.model_ndim
        else:
            raise ValueError("model_ndim is required.")

    if draws == 0:
        _log.warning("Tuning was enabled throughout the whole trace.")
    elif draws < 500:
        _log.warning("Only %s samples in chain.", draws)

    logp_grad = as_logp_grad(
        logp_dlogp_func if logp_dlogp_func is not None
        else (step.logp_dlogp_func if step is not None else None),
        logp_fn,
    )

    if random_seed is None and jax.process_count() > 1:
        # Multi-host sharded init assumes every process computed the FULL
        # chain batch from the SAME seeds (see ``_put`` below). A
        # per-process np.random draw silently violates that invariant, so
        # broadcast process 0's draw to everyone.
        from jax.experimental import multihost_utils

        random_seed = int(
            multihost_utils.broadcast_one_to_all(
                np.int64(np.random.randint(2 ** 30))
            )
        )

    init_keys, chain_keys = _resolve_chain_keys(random_seed, chains)

    # --- Resolve the step spec and init method --------------------------
    init_l = (init or "auto").lower()
    if init_l == "auto":
        init_l = "jitter+adapt_diag"
    if init_l not in _INIT_METHODS:
        raise ValueError("Unknown initializer: {}.".format(init))
    jitter = init_l.startswith("jitter")
    metric_kind = _init_metric_kind(init_l)
    if step is None:
        step = NUTS(model_ndim=model_ndim, **kwargs)
    elif kwargs:
        # the reference likewise forwards **kwargs to the step only when
        # it constructs one (sampling.py:148-159) — but silently; warn.
        _log.warning(
            "`step` was provided; ignoring step-method kwargs: %s "
            "(set them on the step constructor instead)", sorted(kwargs))

    # --- Resolve cross_chain_adapt="auto" (None) -------------------------
    # Pooling the Welford covariance across vectorized chains dominates
    # the reference's per-chain estimation for dense metrics at vector
    # chain counts: each tuning window sees chains-times more data, the
    # adapted metric is closer to the true covariance, and trees are
    # shallower. Promote automatically for adapt_full at
    # >= _POOLED_PROMOTE_CHAINS chains; pass cross_chain_adapt=False
    # explicitly for the reference's per-chain estimator.
    if cross_chain_adapt is None:
        # low-rank metrics pool too: the batch subspace iteration over C
        # chains converges in a handful of tuning steps where the
        # per-chain rank-1 Oja stream needs hundreds.
        is_poolable_adapt = (
            metric_kind in ("full", "lowrank")
            or isinstance(step.potential,
                          (QuadPotentialFullAdapt, QuadPotentialLowRankAdapt)))
        cross_chain_adapt = bool(
            is_poolable_adapt and chains >= _POOLED_PROMOTE_CHAINS)
        if cross_chain_adapt:
            _log.info(
                "Promoting %s to cross-chain pooled adaptation at "
                "%d chains (pass cross_chain_adapt=False for the per-chain "
                "estimator).", init_l, chains)

    # --- Per-chain starting points --------------------------------------
    if start is not None:
        start = jnp.asarray(start, dtype)
        if start.ndim == 1:
            starts = jnp.broadcast_to(start, (chains, model_ndim))
        else:
            if start.shape != (chains, model_ndim):
                raise ValueError(
                    f"start must have shape ({chains}, {model_ndim}), got {start.shape}"
                )
            starts = start
    elif jitter:
        starts = jax.vmap(
            lambda k: 2.0 * jax.random.uniform(k, (model_ndim,), dtype) - 1.0
        )(init_keys)
    else:
        starts = jnp.zeros((chains, model_ndim), dtype)

    # --- Per-chain potentials and states ---------------------------------
    # The whole init is jitted: eager op-by-op dispatch would dominate
    # short runs.
    has_potential = step.potential is not None
    init_fn = _make_init_fn(step.config, logp_grad, model_ndim, metric_kind, dtype, has_potential)
    if has_potential:
        states0 = init_fn(chain_keys, starts, _broadcast_potential(step.potential, chains))
    else:
        states0 = init_fn(chain_keys, starts)

    if mesh is not None:
        n_chain_devs = mesh.shape[chain_axis] if chain_axis in mesh.shape else mesh.size
        if chains % n_chain_devs != 0:
            raise ValueError(
                f"chains ({chains}) must be divisible by the {chain_axis!r} "
                f"mesh axis size ({n_chain_devs})"
            )
        if model_axis is not None:
            if model_axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no axis named {model_axis!r}: {dict(mesh.shape)}"
                )
            m_devs = mesh.shape[model_axis]
            if model_ndim % m_devs != 0:
                raise ValueError(
                    f"model_ndim ({model_ndim}) must be divisible by the "
                    f"{model_axis!r} mesh axis size ({m_devs})"
                )

        multi_process = jax.process_count() > 1

        def _put(x, spec):
            sh = NamedSharding(mesh, spec)
            if not multi_process:
                return jax.device_put(x, sh)
            # Multi-host: the init computed the FULL batch identically on
            # every process (same seeds), so each process can serve its
            # addressable shards from its local copy.
            xh = np.asarray(x)
            return jax.make_array_from_callback(xh.shape, sh,
                                                lambda idx: xh[idx])

        def _shard(x):
            # O(n^2) metric matrices (C, n, n): rows over the model axis.
            # Everything else: chain-sharded, replicated elsewhere.
            if (model_axis is not None and jnp.ndim(x) >= 3
                    and x.shape[-1] == x.shape[-2] == model_ndim):
                spec = P(chain_axis, model_axis)
            else:
                spec = P(chain_axis)
            if multi_process and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
                # typed PRNG keys can't round-trip through numpy: shard
                # the raw key words and rewrap
                raw = _put(jax.random.key_data(x), spec)
                return jax.random.wrap_key_data(raw)
            return _put(x, spec)

        states0 = jax.tree.map(_shard, states0)

    # Fail fast on a bad initial point, like the reference's "Bad initial
    # energy" check (``base_hmc.py:145-148``) but for all chains at once.
    init_logp = states0.logp
    if bool(jax.device_get(jnp.any(~jnp.isfinite(init_logp)))):
        raise ValueError(
            "Bad initial energy: model log-probability is not finite at the "
            "starting point. The model might be misspecified."
        )

    kernel = step.build_kernel(logp_grad)
    collect_tune = not discard_tuned_samples
    # draws per compiled segment when the host must act between segments
    # (progress lines, checkpoints, callbacks); None runs one program
    chunk = (progress_every or max(1, (tune + draws) // 10)
             if progress_every or checkpoint_dir or resume or callback else None)

    if perf_report is not None:
        if isinstance(step.potential, (QuadPotentialDiag, QuadPotentialDiagAdapt)):
            metric_tag = "diag"
        elif isinstance(step.potential, QuadPotentialLowRankAdapt):
            metric_tag = "lowrank"
        elif step.potential is not None:
            metric_tag = "dense"
        else:
            metric_tag = {"diag": "diag", "full": "dense",
                          "lowrank": "lowrank"}[metric_kind]
        perf_report.update(
            engine=(f"{step.name}_{metric_tag}"
                    + ("_pooled" if cross_chain_adapt else "")),
            chunk=chunk,
        )

    if progressbar:
        _log.info(
            "Sampling %d chains (%d tune + %d draws, vectorized on %s)...",
            chains, tune, draws, jax.devices()[0].platform,
        )
    t0 = time.perf_counter()

    if (checkpoint_dir or resume) and jax.process_count() > 1:
        # Orbax handles the distributed save (every process writes its
        # addressable shards — the chunked loop below runs identically on
        # all processes), but only through a shared filesystem.
        _log.info(
            "Multi-process checkpointing: %r must be on a filesystem "
            "shared by all %d processes.", checkpoint_dir, jax.process_count(),
        )
    if chunk:
        final_states, outs = _run_chunked(
            kernel, states0, tune, draws, collect_tune, cross_chain_adapt,
            progress_every=chunk,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            resume=resume,
            chains=chains,
            callback=callback,
            quiet=not progressbar,
        )
    else:
        # Live in-scan progress (reference's per-draw bar with a running
        # divergence count, ``sampling.py:455-469``): a host callback
        # every <= 25 draws from inside the compiled scan — fine-grained
        # without chunking or recompiles.
        live_every = 25 if progressbar and (tune + draws) > 25 else 0
        run, sink_box = _make_runner(kernel, tune, draws, collect_tune,
                                     cross_chain_adapt, live_every)
        sink_box[0] = _ProgressSink(chains, tune, draws) if live_every else None
        try:
            final_states, tune_out, draw_out = run(states0)
            jax.block_until_ready(draw_out)
        finally:
            if live_every:
                # block_until_ready does not flush pending debug
                # callbacks; without the barrier the final progress line
                # can race the sink teardown (two concurrent calls that
                # share this exact runner also share its sink holder)
                jax.effects_barrier()
            sink_box[0] = None
        outs = ([tune_out] if collect_tune else []) + [draw_out]

    elapsed = time.perf_counter() - t0
    if progressbar:
        total = chains * (tune + draws)
        _log.info("Done in %.2fs (%.0f transitions/s).", elapsed, total / elapsed)

    # --- Assemble host-side outputs --------------------------------------
    dtypes = step.stats_dtypes[0]
    if not outs:
        # e.g. resume from a checkpoint taken at the final iteration
        trace = np.zeros((chains, 0, model_ndim), np.dtype(dtype))
        stats = {name: np.zeros((chains, 0), dt) for name, dt in dtypes.items()}
    else:
        # Concatenate chunks on device (cheap) and fetch everything with
        # ONE batched device_get: per-chunk per-field transfers would each
        # pay a host round trip.
        info_fields = outs[0][1]._fields

        def _cat(xs):
            return xs[0] if len(xs) == 1 else jnp.concatenate(xs, axis=0)

        qs_d = _cat([o[0] for o in outs])
        stats_d = {name: _cat([getattr(o[1], name) for o in outs])
                   for name in info_fields}
        t_xfer = time.perf_counter()
        if jax.process_count() > 1:
            # multi-host: shards live on other processes; gather over DCN
            from jax.experimental import multihost_utils

            qs, stats_h = multihost_utils.process_allgather(
                (qs_d, stats_d), tiled=True)
        else:
            qs, stats_h = jax.device_get((qs_d, stats_d))
        if perf_report is not None:
            perf_report["transfer_seconds"] = time.perf_counter() - t_xfer
        trace = np.transpose(np.asarray(qs), (1, 0, 2))  # (chains, draws, ndim)

        stats = {}
        for name in info_fields:
            arr = np.asarray(stats_h[name]).T  # (chains, draws)
            stats[name] = arr.astype(dtypes.get(name, arr.dtype))

    expected = draws + (tune if collect_tune else 0)
    if resume and trace.shape[1] < expected:
        _log.warning(
            "Resume: the restored checkpoint already covered %d of the %d "
            "requested draws; only the remaining %d were sampled and "
            "returned. Pass a larger `draws` (or a fresh checkpoint_dir) "
            "for a full trace.",
            expected - trace.shape[1], expected, trace.shape[1],
        )

    if perf_report is not None:
        perf_report["sample_seconds"] = elapsed
        perf_report.setdefault("transfer_seconds", 0.0)

    # Stash outputs on the spec so the reference's ``step.warnings()``
    # call pattern works (references, not copies — the caller holds the
    # same arrays).
    step._last_stats = stats
    step._last_tune = tune if collect_tune else 0
    step._last_trace = trace

    # --- Surface end-of-run sampler warnings ------------------------------
    # The reference's step objects carry warnings() that sample() callers
    # consume (base_hmc.py:202-230, nuts.py:226-238); here the same checks
    # run on the assembled stats and are logged, so a funnel run reports
    # its divergences/acceptance without user code. R-hat needs the trace
    # scanned per dimension — skipped above a size cutoff so huge runs
    # don't pay seconds of host post-processing they didn't ask for.
    if trace.shape[1] > 0 and compute_convergence_checks:
        try:
            from .report import warnings_from_stats

            # R-hat scans the whole trace per dimension on the host —
            # capped so big sweeps don't pay seconds of post-processing
            # (pass compute_convergence_checks=False to skip everything)
            small = trace.size <= 50_000_000
            warns = warnings_from_stats(
                stats,
                target_accept=step.config.target_accept,
                max_treedepth=getattr(step.config, "max_treedepth", None),
                tune=tune if collect_tune else 0,
                trace=trace if small else None,
            )
            for w in warns:
                (_log.error if w.level == "error" else _log.warning)(
                    "%s: %s", w.kind.name, w.message)
        except Exception:  # never fail a finished run on the reporter
            _log.debug("Post-run warning generation failed.", exc_info=True)

    if return_final_state:
        return trace, stats, final_states
    return trace, stats
