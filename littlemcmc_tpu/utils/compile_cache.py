"""Persistent XLA compilation cache for benchmark and script entry points.

A cold process compiles every sampling program again; the cache lets a
second process with the same programs load them instead. It is enabled
by the entry points that need it (``chip_smoke.py``, ``bench.py``, the
scripts), never at package import.
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

# A fixed path inside the checkout: the path is part of the cache key, so
# a temporary or per-process directory would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as is (JAX reads it
    itself and nothing here overrides it). Otherwise the cache lives in
    ``<repo>/.jax_cache``. Call before the first compilation.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
