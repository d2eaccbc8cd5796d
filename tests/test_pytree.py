"""The in-repo pytree dataclass helper behind every sampler state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from littlemcmc_tpu import pytree
from littlemcmc_tpu.quadpotential import QuadPotentialLowRankAdapt


@pytree.dataclass
class Point:
    x: jax.Array
    w: jax.Array
    scale: float = pytree.field(pytree_node=False, default=2.0)


def _point(scale=2.0):
    return Point(x=jnp.arange(3.0), w=jnp.asarray(1.5), scale=scale)


def test_flatten_keeps_array_fields_as_leaves_and_static_fields_in_treedef():
    p = _point()
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    np.testing.assert_array_equal(leaves[0], np.arange(3.0))
    assert jax.tree_util.tree_unflatten(treedef, leaves).scale == 2.0
    assert treedef != jax.tree_util.tree_structure(_point(scale=3.0))


def test_replace_returns_a_new_frozen_instance():
    p = _point()
    q = p.replace(w=jnp.asarray(4.0), scale=5.0)
    assert isinstance(q, Point) and q.scale == 5.0 and float(q.w) == 4.0
    assert p.scale == 2.0 and float(p.w) == 1.5
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.w = jnp.asarray(0.0)


def test_jit_round_trip_and_static_fields_key_the_cache():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.scale)
        return p.replace(x=p.x * p.scale)

    out = f(_point())
    assert isinstance(out, Point) and out.scale == 2.0
    np.testing.assert_array_equal(out.x, 2.0 * np.arange(3.0))
    f(_point())  # same static value: cached
    f(_point(scale=3.0))  # new static value: traced again
    assert traces == [2.0, 3.0]


def test_vmap_over_a_batch_of_instances():
    batch = jax.vmap(lambda w: _point().replace(w=w))(jnp.arange(4.0))
    assert batch.x.shape == (4, 3) and batch.w.shape == (4,)
    assert jax.tree.map(lambda a: a[1], batch).w == 1.0


def test_sampler_states_are_registered_dataclasses():
    pot = QuadPotentialLowRankAdapt.create(6, rank=2, buffer_size=4)
    names = {f.name for f in dataclasses.fields(pot)}
    assert {"rank", "buffer_size", "vecs"} <= names
    leaves = jax.tree.leaves(pot)
    assert all(hasattr(x, "shape") for x in leaves)
    assert jax.tree.map(lambda a: a, pot).rank == 2
