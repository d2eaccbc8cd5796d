"""Model adapters: turn user callables into jittable ``q -> (logp, grad)`` fns.

The reference's model contract is a host Python callable returning
``(logp, grad)`` (``docs/tutorials/quickstart.rst:37-49``). Here the
contract is the same *signature*, but the callable must be JAX-traceable
so it can live inside the compiled sampling loop. This module provides:

- :func:`as_logp_grad` — normalize either a ``logp_dlogp_func`` (already
  returning the pair) or a plain scalar ``logp_fn`` (autodiffed with
  ``jax.value_and_grad``);
- :func:`from_numpy_callable` — escape hatch wrapping an arbitrary host
  callable (NumPy, PyTorch, ...) with ``jax.pure_callback`` so reference
  users can port models unchanged (at host-roundtrip cost, documented);
  the counterpart of the reference's framework cookbook adapters
  (``docs/_static/scripts/sample_*_logp_dlogp_func.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["as_logp_grad", "from_logp_fn", "from_numpy_callable", "from_torch_callable"]

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


@functools.lru_cache(maxsize=512)
def from_logp_fn(logp_fn: Callable[[jax.Array], jax.Array]) -> LogpGradFn:
    """Autodiff a scalar log-density into a ``(logp, grad)`` pair.

    Memoized on the function object so repeated ``sample()`` calls with the
    same model reuse jit caches downstream.
    """
    vag = jax.value_and_grad(logp_fn)

    def logp_grad(q: jax.Array) -> Tuple[jax.Array, jax.Array]:
        logp, grad = vag(q)
        return logp, grad

    return logp_grad


@functools.lru_cache(maxsize=512)
def _wrap_pair_fn(logp_dlogp_func: LogpGradFn) -> LogpGradFn:
    def logp_grad(q: jax.Array) -> Tuple[jax.Array, jax.Array]:
        logp, grad = logp_dlogp_func(q)
        return jnp.asarray(logp, q.dtype), jnp.asarray(grad, q.dtype)

    return logp_grad


def as_logp_grad(
    logp_dlogp_func: Optional[LogpGradFn] = None,
    logp_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
) -> LogpGradFn:
    """Normalize the user's model into a traceable ``q -> (logp, grad)``.

    Memoized per user function: passing the *same* function object twice
    returns the same wrapper, so the compiled sampler is reused. (A fresh
    lambda per call will still recompile.)
    """
    if (logp_dlogp_func is None) == (logp_fn is None):
        raise ValueError("Provide exactly one of `logp_dlogp_func` or `logp_fn`.")
    if logp_fn is not None:
        return from_logp_fn(logp_fn)
    return _wrap_pair_fn(logp_dlogp_func)


def from_numpy_callable(
    func: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    model_ndim: int,
    dtype=jnp.float32,
) -> LogpGradFn:
    """Wrap a host (NumPy/PyTorch/...) ``logp_dlogp_func`` for use on the device.

    Every model evaluation round-trips device→host→device via
    ``jax.pure_callback`` — orders of magnitude slower than a native JAX
    model, but it lets reference users run unmodified models. The callback
    is vmap-batched by looping on the host.
    """

    def host_fn(q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if q.ndim == 1:
            logp, grad = func(np.asarray(q, np.float64))
            return (
                np.asarray(logp, np.dtype(dtype)),
                np.asarray(grad, np.dtype(dtype)),
            )
        logps = np.empty(q.shape[:-1], np.dtype(dtype))
        grads = np.empty(q.shape, np.dtype(dtype))
        for idx in np.ndindex(*q.shape[:-1]):
            logp, grad = func(np.asarray(q[idx], np.float64))
            logps[idx] = logp
            grads[idx] = grad
        return logps, grads

    def logp_grad(q: jax.Array) -> Tuple[jax.Array, jax.Array]:
        out_shapes = (
            jax.ShapeDtypeStruct(q.shape[:-1], dtype),
            jax.ShapeDtypeStruct(q.shape, dtype),
        )
        return jax.pure_callback(host_fn, out_shapes, q, vmap_method="expand_dims")

    return logp_grad


def from_torch_callable(torch_logp_dlogp_func, model_ndim: int, dtype=jnp.float32) -> LogpGradFn:
    """Wrap a PyTorch ``logp_dlogp_func`` (tensors in/out) for use on the device.

    Counterpart of the reference cookbook's PyTorch adapter
    (``docs/_static/scripts/sample_pytorch_logp_dlogp_func.py``).
    """
    import torch  # local import; torch (CPU) is an optional path

    def numpy_func(q: np.ndarray):
        logp, grad = torch_logp_dlogp_func(torch.from_numpy(np.asarray(q)))
        return float(logp), np.asarray(grad.detach().cpu().numpy())

    return from_numpy_callable(numpy_func, model_ndim, dtype)
