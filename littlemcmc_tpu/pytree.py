"""Frozen dataclasses registered as JAX pytrees.

Every sampler state (chain state, dual averaging, the metrics and their
Welford accumulators) is one of these: ``jit``, ``vmap`` and ``lax.scan``
carry its array fields as leaves, while fields declared with
``field(pytree_node=False)`` are static metadata — part of the tree
structure, hashed into the compile cache, never traced.

>>> import jax, jax.numpy as jnp
>>> @dataclass
... class Point:
...     x: jax.Array
...     scale: float = field(pytree_node=False, default=2.0)
>>> p = Point(jnp.ones(3))
>>> jax.tree.leaves(p)[0].shape
(3,)
>>> float(jax.jit(lambda p: p.x.sum() * p.scale)(p))
6.0
>>> p.replace(scale=3.0).scale
3.0
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    """A copy of this instance with ``changes`` applied to its fields."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass, registered as a pytree, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls.replace = _replace
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)],
    )
    return cls
