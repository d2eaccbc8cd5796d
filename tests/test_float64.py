"""End-to-end float64 sampling (the reference's native precision).

The reference samples in float64 throughout (its one f32 outlier is the
default potential dtype, ``/root/reference/littlemcmc/quadpotential.py:175-177``).
Here f64 is opt-in via ``sample(dtype=jnp.float64)`` under JAX's x64
mode. x64 is a process-global flag, so the run is exercised in a
subprocess to keep the rest of the suite on the default f32 path.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_X64_WORKER = r"""
import os
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys
sys.path.insert(0, {repo!r})
import jax.numpy as jnp
import numpy as np
import littlemcmc_tpu as lmc


def logp_grad(q):
    return -0.5 * jnp.sum(q ** 2), -q


trace, stats, final = lmc.sample(
    logp_dlogp_func=logp_grad, model_ndim=3, chains=8,
    tune=400, draws=600, random_seed=5, progressbar=False,
    dtype=jnp.float64, return_final_state=True,
)
# the device computation itself ran in f64, not a post-hoc cast
assert final.q.dtype == jnp.float64, final.q.dtype
assert final.potential.var.dtype == jnp.float64
assert trace.dtype == np.float64, trace.dtype
assert trace.shape == (8, 600, 3)
# stats dtypes hold the reference's declared dtypes (nuts.py:87-101)
for name, dt in lmc.NUTS.stats_dtypes[0].items():
    assert stats[name].dtype == np.dtype(dt), (name, stats[name].dtype)
draws = trace.reshape(-1, 3)
assert np.abs(draws.mean(0)).max() < 0.1, draws.mean(0)
assert np.abs(draws.var(0) - 1.0).max() < 0.15, draws.var(0)
print("x64 OK", draws.var(0))
"""


def test_sample_float64_end_to_end():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _X64_WORKER.format(repo=REPO)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "x64 OK" in proc.stdout


_X64_CHUNKED_WORKER = r"""
import os
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys
sys.path.insert(0, {repo!r})
import jax.numpy as jnp
import littlemcmc_tpu as lmc


def logp_grad(q):
    return -0.5 * jnp.sum(q ** 2), -q


# progress_every forces the chunked runner: its lax.scan carries an
# int32 divergence counter, and under enable_x64 a bare sum(bool) is
# int64 — the promotion broke the carry (regression: round-5 funnel
# f64 arm)
trace, stats = lmc.sample(
    logp_dlogp_func=logp_grad, model_ndim=3, chains=8,
    tune=100, draws=100, random_seed=5, progressbar=False,
    dtype=jnp.float64, progress_every=50,
    compute_convergence_checks=False,
)
assert trace.dtype == "float64", trace.dtype
assert trace.shape == (8, 100, 3)
print("x64 chunked OK")
"""


def test_sample_float64_chunked():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _X64_CHUNKED_WORKER.format(repo=REPO)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "x64 chunked OK" in proc.stdout
