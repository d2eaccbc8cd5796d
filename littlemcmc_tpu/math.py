"""Log-space math utilities for the samplers.

Re-designed counterpart of the reference's ``littlemcmc/math.py:21-40``:
instead of host-side ``np.random`` Bernoulli trials, every stochastic
primitive takes an explicit ``jax.random`` key so the whole sampler is a
pure function that XLA can trace once and compile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["logbern", "log1mexp", "logdiffexp", "tree_select"]


def logbern(key: jax.Array, log_p: jax.Array) -> jax.Array:
    """Bernoulli trial in log space: returns ``True`` w.p. ``exp(log_p)``.

    NaN ``log_p`` yields ``False`` (the comparison is false), rather than
    raising like the reference (``math.py:21-25``) — exceptions cannot cross
    a jit boundary, and a NaN weight means the branch carries zero mass.
    """
    u = jax.random.uniform(key, shape=jnp.shape(log_p), dtype=jnp.result_type(float))
    return jnp.log(u) < log_p


def log1mexp(x: jax.Array) -> jax.Array:
    """Compute ``log(1 - exp(-x))`` stably for ``x > 0``.

    Uses the two-branch switch at 0.683 from Maechler's log1mexp note
    (same scheme as the reference ``math.py:28-35``).

    >>> import numpy as np
    >>> bool(np.isclose(log1mexp(1.0), np.log(1 - np.exp(-1.0)), rtol=1e-4))
    True
    >>> bool(np.isclose(log1mexp(1e-6), np.log(1e-6), rtol=1e-3))  # stable branch
    True
    """
    x = jnp.asarray(x)
    # Guard both branches so the untaken one cannot generate NaN gradients.
    safe_small = jnp.where(x < 0.683, x, 1.0)
    safe_large = jnp.where(x < 0.683, 1.0, x)
    return jnp.where(
        x < 0.683,
        jnp.log(-jnp.expm1(-safe_small)),
        jnp.log1p(-jnp.exp(-safe_large)),
    )


def logdiffexp(a: jax.Array, b: jax.Array) -> jax.Array:
    """Compute ``log(exp(a) - exp(b))`` for ``a > b`` (reference ``math.py:38-40``).

    >>> import numpy as np
    >>> bool(np.isclose(logdiffexp(np.log(5.0), np.log(3.0)), np.log(2.0), rtol=1e-4))
    True
    """
    return a + log1mexp(a - b)


def tree_select(pred, on_true, on_false):
    """Elementwise ``where`` over matching pytrees (scalar or array pred)."""
    return jax.tree.map(lambda t, f: jnp.where(pred, t, f), on_true, on_false)
