"""No-U-Turn sampler as a natively chain-batched, fixed-shape XLA kernel.

Re-architecture of the reference's recursive NUTS (``littlemcmc/nuts.py``)
for accelerators. The reference builds the binary trajectory tree with
Python recursion (``nuts.py:377-417``); XLA cannot trace unbounded
recursion, so the same tree is built *iteratively* with an explicit merge
stack — a post-order traversal that replays the reference's recursion
exactly: leaf ``i`` triggers one merge per trailing one-bit of ``i``,
reproducing every internal node of ``_build_subtree`` in order, with the
same multinomial proposal swaps and the same 3-way generalized U-turn
checks (``nuts.py:332-340, 389-398``).

The kernel is **batched over chains by construction** rather than via
``vmap``. The key observation: every chain that is still extending its
tree follows the *same* schedule — at outer iteration ``d`` all active
chains build a ``2^d``-leaf subtree, process leaves in the same order,
perform merges at the same leaf indices, and push/pop at the same stack
heights. All loop control (depth, leaf index, merge count, stack height)
is therefore *scalar*, per-chain divergence from the schedule is handled
with boolean masks, and every stack access is a static-stride
``dynamic_update_slice`` at a scalar index — **no per-lane gathers or
scatters**, which a ``vmap``-ed per-chain stack would require. All bulk
data is ``(chains, n)``, one dense 2-D array per quantity.

The hot-loop working set is kept deliberately *slim*, because the memory
traffic per leaf bounds throughput once the model itself is cheap: every
extra ``(chains, n)`` array written per leaf costs a sizeable fraction
of a leapfrog.

- the merge stack stores per subtree only ``(left_p, right_p, p_sum,
  proposal q)`` — velocities at subtree boundaries are *recomputed* from
  the stored momenta at each U-turn check (for diagonal metrics this
  fuses into the dot product and costs no extra memory traffic; the
  reference instead stores full ``State`` objects at every boundary,
  ``nuts.py:246-248``);
- the proposal's gradient is not carried through the tree at all — it is
  recomputed with one extra batched model evaluation per transition when
  the accepted proposal is known (the reference caches it in ``State``);
- the integrator carry drops the velocity field (the leapfrog
  re-derives it from ``p`` internally).

Divergences (``|ΔE| ≥ Emax``, NaN ⇒ ∞; reference ``nuts.py:353-358``) and
turning are boolean masks instead of exceptions. Chains stopped early are
frozen by masking; the loops run until the slowest chain finishes — the
standard batched-NUTS execution model on accelerators.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .base import ChainState, NUTSConfig
from .math import log1mexp
from .step_sizes import dual_average_update

__all__ = ["NUTSConfig", "NUTSInfo", "build_nuts_kernel"]

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


class PhaseState(NamedTuple):
    """Slim phase-space point for the NUTS hot loop; batched (C, ...).

    The velocity is intentionally absent (recomputed from ``p`` where
    needed) — see the module docstring.
    """

    q: jax.Array
    p: jax.Array
    q_grad: jax.Array
    energy: jax.Array
    logp: jax.Array


class TreeNode(NamedTuple):
    """A completed subtree, boundaries in integration order; batched.

    ``left_p``/``right_p`` are the momenta at the subtree's two ends —
    all the U-turn criterion needs besides ``p_sum``. For *diagonal*
    metrics the boundary velocities ``left_v``/``right_v`` are ``None``
    (recomputing ``v = var * p`` fuses into the U-turn dot products, so
    storing them would only add stack traffic); for dense metrics they
    are stored (recomputing would cost an (n, n) matvec per check).
    ``q``/``energy``/``logp`` are the subtree's multinomial proposal
    (reference ``nuts.py:243-248``).
    """

    left_p: jax.Array
    right_p: jax.Array
    left_v: Optional[jax.Array]
    right_v: Optional[jax.Array]
    p_sum: jax.Array
    q: jax.Array
    energy: jax.Array
    logp: jax.Array
    log_size: jax.Array
    log_weighted_accept_sum: jax.Array


class NUTSInfo(NamedTuple):
    """Per-draw sampler statistics; names match reference ``nuts.py:87-101``."""

    depth: jax.Array
    step_size: jax.Array
    tune: jax.Array
    mean_tree_accept: jax.Array
    step_size_bar: jax.Array
    tree_size: jax.Array
    diverging: jax.Array
    energy_error: jax.Array
    energy: jax.Array
    max_energy_error: jax.Array
    model_logp: jax.Array
    # Extra (not in the reference's stats dict): exact bookkeeping for the
    # TREEDEPTH warning, which the reference keeps as a mutable counter
    # (``nuts.py:218-220``).
    reached_max_treedepth: jax.Array


def _mwhere(mask, a, b):
    """``where`` with a (C,) mask broadcast against (C, ...) leaves."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (jnp.ndim(x) - mask.ndim))
        return jnp.where(m, x, y)

    return jax.tree.map(sel, a, b)


def _rowdot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def _split_each(keys: jax.Array, num: int):
    """Split a (C,) key batch into ``num`` (C,) key batches."""
    out = jax.vmap(lambda k: jax.random.split(k, num))(keys)
    return tuple(out[:, i] for i in range(num))


def _logbern_b(keys: jax.Array, log_p: jax.Array) -> jax.Array:
    """Per-chain Bernoulli in log space; NaN log_p yields False."""
    u = jax.vmap(jax.random.uniform)(keys)
    return jnp.log(u) < log_p


def _leaf_node(state: PhaseState, energy_change: jax.Array,
               v: Optional[jax.Array] = None) -> TreeNode:
    """Single-leapfrog subtree (reference ``_single_step``, ``nuts.py:359-368``).

    ``v`` is the leaf's velocity when the metric is dense (stored in the
    node); ``None`` for diagonal metrics (recomputed at the checks).
    """
    # log_p_accept_weighted = -ΔE + min(0, -ΔE): saturated Metropolis accept
    # probability with Boltzmann weight (``nuts.py:363``).
    lpaw = -energy_change + jnp.minimum(0.0, -energy_change)
    return TreeNode(
        left_p=state.p,
        right_p=state.p,
        left_v=v,
        right_v=v,
        p_sum=state.p,
        q=state.q,
        energy=state.energy,
        logp=state.logp,
        log_size=-energy_change,
        log_weighted_accept_sum=lpaw,
    )


def _make_batched_potential_ops(potential):
    velocity = jax.vmap(lambda pot, p: pot.velocity(p))
    kinetic = jax.vmap(lambda pot, p, v: pot.kinetic(p, v))
    return (
        lambda p: velocity(potential, p),
        lambda p, v: kinetic(potential, p, v),
    )


def _leapfrog_b(velocity_b, kinetic_b, logp_grad_b, epsilon, state: PhaseState,
                scheme: str = "leapfrog") -> Tuple[PhaseState, jax.Array]:
    """Batched symplectic step (reference ``integration.py:100-121`` for
    the default scheme; higher-order palindromic splittings otherwise).

    Also returns the final velocity (already computed for the kinetic
    energy) so dense-metric callers can store it without a second matvec.
    """
    from .integration import INTEGRATOR_COEFFS

    b, a = INTEGRATOR_COEFFS[scheme]
    eps = epsilon[:, None]
    p = state.p + (b[0] * eps) * state.q_grad
    q, logp, grad = state.q, state.logp, state.q_grad
    for i, ai in enumerate(a):
        v = velocity_b(p)
        q = (q + (ai * eps) * v).astype(state.q.dtype)
        logp, grad = logp_grad_b(q)
        p = p + (b[i + 1] * eps) * grad
    v = velocity_b(p)
    kin = kinetic_b(p, v)
    return PhaseState(q, p, grad, kin - logp, logp), v


def _merge_nodes(keys, t1: TreeNode, t2: TreeNode, check_extra,
                 velocity_b) -> Tuple[TreeNode, jax.Array]:
    """Merge two adjacent complete subtrees (integration order: t1 then t2).

    Replays one internal node of the reference recursion
    (``nuts.py:389-407``): full-span U-turn check, the two cross-subtree
    checks when both children have depth ≥ 1 (``check_extra``), log-space
    weight accumulation, and the multinomial proposal swap. Batched; the
    returned ``turning`` is per-chain. Boundary velocities come from the
    nodes when stored (dense metrics) and are otherwise recomputed from
    the momenta (diagonal metrics — the multiply fuses into the dots).
    """
    if t1.left_v is not None:
        v_1l, v_1r = t1.left_v, t1.right_v
        v_2l, v_2r = t2.left_v, t2.right_v
    else:
        v_1l = velocity_b(t1.left_p)
        v_1r = velocity_b(t1.right_p)
        v_2l = velocity_b(t2.left_p)
        v_2r = velocity_b(t2.right_p)

    p_sum = t1.p_sum + t2.p_sum
    turning = (_rowdot(p_sum, v_1l) <= 0) | (_rowdot(p_sum, v_2r) <= 0)
    p_sum1 = t1.p_sum + t2.left_p
    turning1 = (_rowdot(p_sum1, v_1l) <= 0) | (_rowdot(p_sum1, v_2l) <= 0)
    p_sum2 = t1.right_p + t2.p_sum
    turning2 = (_rowdot(p_sum2, v_1r) <= 0) | (_rowdot(p_sum2, v_2r) <= 0)
    turning = turning | (check_extra & (turning1 | turning2))

    log_size = jnp.logaddexp(t1.log_size, t2.log_size)
    lwas = jnp.logaddexp(
        t1.log_weighted_accept_sum, t2.log_weighted_accept_sum
    )
    take2 = _logbern_b(keys, t2.log_size - log_size)
    t2m = take2[:, None]
    node = TreeNode(
        left_p=t1.left_p,
        right_p=t2.right_p,
        left_v=t1.left_v,
        right_v=t2.right_v,
        p_sum=p_sum,
        q=jnp.where(t2m, t2.q, t1.q),
        energy=jnp.where(take2, t2.energy, t1.energy),
        logp=jnp.where(take2, t2.logp, t1.logp),
        log_size=log_size,
        log_weighted_accept_sum=lwas,
    )
    return node, turning


class _BuildCarry(NamedTuple):
    keys: jax.Array  # (C,)
    leaf_idx: jax.Array  # scalar
    height: jax.Array  # scalar
    cur: PhaseState  # batched; aborted lanes carry garbage (masked)
    stack: TreeNode  # leading stack dim (max_treedepth,), then batch
    building: jax.Array  # (C,) still building this subtree
    n_leaves: jax.Array  # (C,)
    max_energy_change: jax.Array  # (C,)
    diverging: jax.Array  # (C,)
    turning: jax.Array  # (C,)


class _SubtreeResult(NamedTuple):
    node: TreeNode
    end_state: PhaseState
    stack: TreeNode  # scratch, returned so the caller can thread it
    n_leaves: jax.Array
    max_energy_change: jax.Array
    diverging: jax.Array
    turning: jax.Array


def _build_subtree(
    keys,
    edge: PhaseState,
    depth,
    epsilon,
    active,
    start_energy,
    max_energy_change0,
    stack0: TreeNode,
    velocity_b,
    kinetic_b,
    logp_grad_b,
    config: NUTSConfig,
    store_velocity: bool = False,
) -> _SubtreeResult:
    """Build a complete subtree of ``2^depth`` leapfrogs from ``edge``.

    Iterative equivalent of ``_Tree._build_subtree`` (``nuts.py:377-417``),
    batched: ``depth``/``leaf_idx``/``height`` are scalars shared by all
    chains; ``active``/``building`` masks freeze chains that aborted. On
    abort only ``n_leaves``, the flags and ``max_energy_change`` are
    meaningful to the caller (reference abort semantics, ``nuts.py:316-319``).

    ``stack0`` is the caller-owned scratch stack: its contents are never
    read before being written (every ``peek`` follows a ``push`` to that
    slot), so it is threaded through the trajectory loop instead of being
    re-materialized — zeroing a fresh (max_treedepth, C, n)-sized stack on
    every doubling costs tens of MB of HBM writes per draw at scale.
    """
    n_total = jnp.left_shift(jnp.asarray(1, jnp.int32), depth)
    emax = jnp.asarray(config.Emax, edge.q.dtype)
    C = edge.q.shape[0]

    def push(stack, node, h):
        return jax.tree.map(
            lambda s, x: lax.dynamic_update_index_in_dim(s, x, h, 0), stack, node
        )

    def peek(stack, h):
        return jax.tree.map(
            lambda s: lax.dynamic_index_in_dim(s, h, 0, keepdims=False), stack
        )

    def cond(c: _BuildCarry):
        return (c.leaf_idx < n_total) & jnp.any(c.building)

    def body(c: _BuildCarry) -> _BuildCarry:
        # NOTE: aborted (non-building) lanes are NOT frozen — they keep
        # integrating garbage (possibly NaN) positions. Every downstream
        # consumer of their values is masked (div_leaf/mec/n_leaves below
        # by `building`, their stack lanes and final subtree node by the
        # caller's `ok`), so masking the state itself would only add
        # (C, n)-sized read traffic to the hot loop.
        new_state, v_new = _leapfrog_b(
            velocity_b, kinetic_b, logp_grad_b, epsilon, c.cur, config.integrator
        )

        energy_change = new_state.energy - start_energy
        energy_change = jnp.where(jnp.isnan(energy_change), jnp.inf, energy_change)
        upd = c.building & (jnp.abs(energy_change) > jnp.abs(c.max_energy_change))
        mec = jnp.where(upd, energy_change, c.max_energy_change)
        div_leaf = c.building & ~(jnp.abs(energy_change) < emax)
        n_leaves = c.n_leaves + c.building.astype(jnp.int32)

        node = _leaf_node(new_state, energy_change,
                          v=v_new if store_velocity else None)

        # Merge once per trailing one-bit of leaf_idx — the internal nodes
        # the reference recursion completes after this leaf. The schedule
        # (indices, heights) is scalar; chains that diverged at this leaf
        # or turned at an earlier merge stop applying updates
        # (``nuts.py:379-383``).
        def merge_cond(mc):
            keys_, j, node_, h, merging_ = mc
            more = jnp.bitwise_and(jnp.right_shift(c.leaf_idx, j), 1) == 1
            return more & jnp.any(merging_)

        def merge_body(mc):
            keys_, j, node_, h, merging_ = mc
            keys_next, k_merge = _split_each(keys_, 2)
            t1 = peek(c.stack, h - 1)
            merged, turning_new = _merge_nodes(
                k_merge, t1, node_, check_extra=j >= 1, velocity_b=velocity_b
            )
            # Lanes that stopped merging (turned at an earlier merge this
            # leaf, or aborted earlier) take the merged garbage and the
            # advanced keys unmasked: neither is read again this subtree,
            # and the tree-level key chain is separate.
            merging_ = merging_ & ~turning_new
            return (keys_next, j + 1, merged, h - 1, merging_)

        merging0 = c.building & ~div_leaf
        keys1, _, node, height, merging_out = lax.while_loop(
            merge_cond,
            merge_body,
            (c.keys, jnp.asarray(0, jnp.int32), node, c.height, merging0),
        )
        turned = merging0 & ~merging_out  # turned at some merge this leaf

        building = c.building & ~div_leaf & ~turned
        # Push at the scalar post-merge height. Aborted/frozen chains write
        # garbage into their lanes of this slot; they never read it again
        # (the stack is fresh per subtree and they stay masked out).
        stack = push(c.stack, node, height)

        return _BuildCarry(
            keys=keys1,
            leaf_idx=c.leaf_idx + 1,
            height=height + 1,
            cur=new_state,
            stack=stack,
            building=building,
            n_leaves=n_leaves,
            max_energy_change=mec,
            diverging=c.diverging | div_leaf,
            turning=c.turning | turned,
        )

    init = _BuildCarry(
        keys=keys,
        leaf_idx=jnp.asarray(0, jnp.int32),
        height=jnp.asarray(0, jnp.int32),
        cur=edge,
        stack=stack0,
        building=active,
        n_leaves=jnp.zeros((C,), jnp.int32),
        max_energy_change=max_energy_change0,
        diverging=jnp.zeros((C,), bool),
        turning=jnp.zeros((C,), bool),
    )
    out = lax.while_loop(cond, body, init)

    # Clean completion leaves exactly one frame on the stack (slot 0).
    final_node = peek(out.stack, 0)
    return _SubtreeResult(
        node=final_node,
        end_state=out.cur,
        stack=out.stack,
        n_leaves=out.n_leaves,
        max_energy_change=out.max_energy_change,
        diverging=out.diverging,
        turning=out.turning,
    )


class _TreeCarry(NamedTuple):
    keys: jax.Array
    stack: TreeNode  # scratch for subtree builds, allocated once
    left: PhaseState
    right: PhaseState
    left_v: Optional[jax.Array]  # edge velocities; None for diag metrics
    right_v: Optional[jax.Array]
    p_sum: jax.Array
    prop_q: jax.Array
    prop_energy: jax.Array
    prop_logp: jax.Array
    log_size: jax.Array
    log_weighted_accept_sum: jax.Array
    depth: jax.Array  # scalar schedule depth
    depth_c: jax.Array  # (C,) per-chain extends performed (the `depth` stat)
    n_proposals: jax.Array
    max_energy_change: jax.Array
    diverging: jax.Array
    turning: jax.Array


class TreeResult(NamedTuple):
    prop_q: jax.Array
    prop_energy: jax.Array
    prop_logp: jax.Array
    depth: jax.Array
    n_proposals: jax.Array
    mean_tree_accept: jax.Array
    max_energy_change: jax.Array
    diverging: jax.Array
    turning: jax.Array
    reached_max_treedepth: jax.Array


def run_nuts_tree(
    keys,
    start: PhaseState,
    step_size,
    max_depth_c,
    potential,
    logp_grad_b,
    config: NUTSConfig,
) -> TreeResult:
    """One full batched NUTS trajectory: iterative tree doubling.

    Equivalent of ``NUTS._hamiltonian_step`` + ``_Tree.extend``
    (``nuts.py:204-224, 284-342``). ``max_depth_c`` is per-chain (early
    tree-depth schedule); the scalar loop runs to the largest.
    """
    velocity_b, kinetic_b = _make_batched_potential_ops(potential)
    C = start.q.shape[0]
    dtype = start.energy.dtype
    max_depth_sched = jnp.max(max_depth_c)
    # Diagonal metrics recompute boundary velocities at the checks (the
    # elementwise multiply fuses into the dots); dense metrics store them
    # (recomputing would cost an (n, n) matvec per check).
    store_v = _diag_inverse_mass(potential) is None

    def cond(c: _TreeCarry):
        active = (~c.diverging) & (~c.turning) & (c.depth_c < max_depth_c)
        return (c.depth < max_depth_sched) & jnp.any(active)

    def body(c: _TreeCarry) -> _TreeCarry:
        active = (~c.diverging) & (~c.turning) & (c.depth_c < max_depth_c)
        keys_next, k_dir, k_sub, k_swap = _split_each(c.keys, 4)
        keys1 = _mwhere(active, keys_next, c.keys)

        go_right = jax.vmap(jax.random.bernoulli)(k_dir)
        eps_signed = jnp.where(go_right, step_size, -step_size)
        edge = _mwhere(go_right, c.right, c.left)

        sub = _build_subtree(
            k_sub, edge, c.depth, eps_signed, active,
            start.energy, c.max_energy_change, c.stack,
            velocity_b, kinetic_b, logp_grad_b, config,
            store_velocity=store_v,
        )
        ok = active & ~sub.diverging & ~sub.turning
        node = sub.node

        # Multinomial swap against the *old* tree weight (``nuts.py:321-323``).
        take_new = ok & _logbern_b(k_swap, node.log_size - c.log_size)
        tm = take_new[:, None]
        prop_q = jnp.where(tm, node.q, c.prop_q)
        prop_energy = jnp.where(take_new, node.energy, c.prop_energy)
        prop_logp = jnp.where(take_new, node.logp, c.prop_logp)
        log_size = jnp.where(ok, jnp.logaddexp(c.log_size, node.log_size), c.log_size)
        lwas = jnp.where(
            ok,
            jnp.logaddexp(c.log_weighted_accept_sum, node.log_weighted_accept_sum),
            c.log_weighted_accept_sum,
        )
        p_sum = jnp.where(ok[:, None], c.p_sum + node.p_sum, c.p_sum)

        # New span boundaries in position order: the subtree's far end (its
        # last integrated full state) replaces the extended edge.
        new_left = _mwhere(ok & ~go_right, sub.end_state, c.left)
        new_right = _mwhere(ok & go_right, sub.end_state, c.right)
        if store_v:
            v_end = velocity_b(sub.end_state.p)  # once per doubling
            okm = ok[:, None]
            new_left_v = jnp.where(okm & ~go_right[:, None], v_end, c.left_v)
            new_right_v = jnp.where(okm & go_right[:, None], v_end, c.right_v)
        else:
            new_left_v = new_right_v = None

        # 3-way generalized U-turn check on the merged span
        # (``nuts.py:332-340``). Boundary velocities: stored for dense
        # metrics, recomputed after selecting the momenta otherwise.
        go = go_right[:, None]
        if store_v:
            v_left, v_right = new_left_v, new_right_v
            v1a = jnp.where(go, c.left_v, node.right_v)
            v1b = jnp.where(go, node.left_v, c.left_v)
            v2a = jnp.where(go, c.right_v, node.left_v)
            v2b = jnp.where(go, node.right_v, c.right_v)
        else:
            v_left = velocity_b(new_left.p)
            v_right = velocity_b(new_right.p)
            p1a = jnp.where(go, c.left.p, node.right_p)
            p1b = jnp.where(go, node.left_p, c.left.p)
            v1a, v1b = velocity_b(p1a), velocity_b(p1b)
            p2a = jnp.where(go, c.right.p, node.left_p)
            p2b = jnp.where(go, node.right_p, c.right.p)
            v2a, v2b = velocity_b(p2a), velocity_b(p2b)
        turning_full = (_rowdot(p_sum, v_left) <= 0) | (_rowdot(p_sum, v_right) <= 0)
        p_sum1 = jnp.where(go, c.p_sum + node.left_p, node.p_sum + c.left.p)
        turning1 = (_rowdot(p_sum1, v1a) <= 0) | (_rowdot(p_sum1, v1b) <= 0)
        p_sum2 = jnp.where(go, c.right.p + node.p_sum, node.left_p + c.p_sum)
        turning2 = (_rowdot(p_sum2, v2a) <= 0) | (_rowdot(p_sum2, v2b) <= 0)
        turning_new = turning_full | turning1 | turning2

        return _TreeCarry(
            keys=keys1,
            stack=sub.stack,
            left=new_left,
            right=new_right,
            left_v=new_left_v,
            right_v=new_right_v,
            p_sum=p_sum,
            prop_q=prop_q,
            prop_energy=prop_energy,
            prop_logp=prop_logp,
            log_size=log_size,
            log_weighted_accept_sum=lwas,
            depth=c.depth + 1,
            depth_c=c.depth_c + active.astype(jnp.int32),
            n_proposals=c.n_proposals + jnp.where(active, sub.n_leaves, 0),
            max_energy_change=jnp.where(active, sub.max_energy_change, c.max_energy_change),
            diverging=c.diverging | (active & sub.diverging),
            turning=c.turning | (active & jnp.where(ok, turning_new, sub.turning)),
        )

    v_start = velocity_b(start.p) if store_v else None
    zero_node = _leaf_node(start, jnp.zeros((C,), dtype), v=v_start)
    stack0 = jax.tree.map(
        lambda x: jnp.zeros((config.max_treedepth,) + jnp.shape(x), x.dtype), zero_node
    )
    init = _TreeCarry(
        keys=keys,
        stack=stack0,
        left=start,
        right=start,
        left_v=v_start,
        right_v=v_start,
        p_sum=start.p,
        prop_q=start.q,
        prop_energy=start.energy,
        prop_logp=start.logp,
        log_size=jnp.zeros((C,), dtype),
        log_weighted_accept_sum=jnp.full((C,), -jnp.inf, dtype),
        depth=jnp.asarray(0, jnp.int32),
        depth_c=jnp.zeros((C,), jnp.int32),
        n_proposals=jnp.zeros((C,), jnp.int32),
        max_energy_change=jnp.zeros((C,), dtype),
        diverging=jnp.zeros((C,), bool),
        turning=jnp.zeros((C,), bool),
    )
    out = lax.while_loop(cond, body, init)

    # mean_tree_accept with the initial state's unit weight removed
    # (``nuts.py:419-425``).
    mean_tree_accept = jnp.where(
        out.log_size > 0,
        jnp.exp(
            out.log_weighted_accept_sum - (out.log_size + log1mexp(out.log_size))
        ),
        0.0,
    )
    reached_max = (~out.diverging) & (~out.turning)
    return TreeResult(
        prop_q=out.prop_q,
        prop_energy=out.prop_energy,
        prop_logp=out.prop_logp,
        depth=out.depth_c,
        n_proposals=out.n_proposals,
        mean_tree_accept=mean_tree_accept,
        max_energy_change=out.max_energy_change,
        diverging=out.diverging,
        turning=out.turning,
        reached_max_treedepth=reached_max,
    )


def _diag_inverse_mass(potential):
    """Inverse-mass diagonal of a (batched) diagonal metric, or None."""
    from .quadpotential import QuadPotentialDiag, QuadPotentialDiagAdapt

    if isinstance(potential, QuadPotentialDiagAdapt):
        return potential.var
    if isinstance(potential, QuadPotentialDiag):
        return potential.v
    return None


@functools.lru_cache(maxsize=512)
def build_nuts_kernel(
    logp_grad_fn: LogpGradFn,
    config: NUTSConfig = NUTSConfig(),
    batched_logp_grad_fn: Optional[LogpGradFn] = None,
):
    """Build the chain-batched NUTS transition ``kernel(states, tuning)``.

    Counterpart of ``BaseHMC._astep`` + ``NUTS._hamiltonian_step``
    (``base_hmc.py:140-190``, ``nuts.py:204-224``). ``states`` is a
    :class:`~littlemcmc_tpu.base.ChainState` with a leading ``chains``
    axis on every leaf; the kernel returns ``(new_states, NUTSInfo)`` with
    the same batching. Memoized on its arguments so repeated drivers
    reuse jit caches.

    ``batched_logp_grad_fn`` optionally overrides the model evaluation
    with a natively-batched ``(C, n) -> ((C,), (C, n))`` implementation;
    the default is ``vmap`` of the per-chain function. Under a sharded
    chain batch, GSPMD partitions the whole kernel over the chain axis.
    """
    logp_grad_b = (
        batched_logp_grad_fn
        if batched_logp_grad_fn is not None
        else jax.vmap(logp_grad_fn)
    )

    def kernel(states: ChainState, tuning) -> Tuple[ChainState, NUTSInfo]:
        key_next, k_mom, k_tree, k_sr = _split_each(states.rng_key, 4)

        # Fresh momentum and the trajectory start (cached model eval).
        p0 = jax.vmap(lambda pot, k: pot.sample_momentum(k))(states.potential, k_mom)
        v0 = jax.vmap(lambda pot, p: pot.velocity(p))(states.potential, p0)
        kin = jax.vmap(lambda pot, p, v: pot.kinetic(p, v))(states.potential, p0, v0)
        start = PhaseState(states.q, p0, states.q_grad, kin - states.logp, states.logp)

        adapting = jnp.logical_and(tuning, config.adapt_step_size)
        step_size = states.da.current(adapting)  # (C,)
        if config.step_rand is not None:
            step_size = jax.vmap(config.step_rand)(step_size, k_sr)

        # Early-treedepth schedule: first `early_window` tuning iterations
        # cap the tree at `early_max_treedepth` (``nuts.py:205-208``).
        early = jnp.logical_and(tuning, states.iter_count < config.early_window)
        max_depth_c = jnp.where(
            early, config.early_max_treedepth, config.max_treedepth
        ).astype(jnp.int32)

        tree = run_nuts_tree(
            k_tree, start, step_size, max_depth_c,
            states.potential, logp_grad_b, config,
        )

        # The proposal's gradient was not carried through the tree (see
        # module docstring); recompute it once at the accepted position.
        # (Deterministic model ⇒ identical to the value the reference
        # caches in its State objects.)
        prop_logp, prop_grad = logp_grad_b(tree.prop_q)

        # Adaptation updates (``base_hmc.py:161-162``).
        da = dual_average_update(
            states.da,
            tree.mean_tree_accept,
            adapting,
            target=config.target_accept,
            gamma=config.gamma,
            k=config.k,
            t0=config.t0,
        )
        potential = jax.vmap(lambda pot, q, g: pot.update(q, g, tuning))(
            states.potential, tree.prop_q, prop_grad
        )

        new_states = ChainState(
            rng_key=key_next,
            q=tree.prop_q,
            q_grad=prop_grad,
            logp=prop_logp,
            potential=potential,
            da=da,
            iter_count=states.iter_count + 1,
        )

        info = NUTSInfo(
            depth=tree.depth,
            step_size=jnp.exp(da.log_step),
            tune=jnp.broadcast_to(tuning, tree.depth.shape),
            mean_tree_accept=tree.mean_tree_accept,
            step_size_bar=jnp.exp(da.log_bar),
            tree_size=tree.n_proposals.astype(start.q.dtype),
            diverging=tree.diverging,
            energy_error=tree.prop_energy - start.energy,
            energy=tree.prop_energy,
            max_energy_error=tree.max_energy_change,
            model_logp=tree.prop_logp,
            reached_max_treedepth=jnp.logical_and(
                tree.reached_max_treedepth, jnp.logical_not(tuning)
            ),
        )
        return new_states, info

    return kernel
