"""Leapfrog integration as pure functions over an immutable phase-space state.

Counterpart of the reference's ``littlemcmc/integration.py``.
The reference's ``CpuLeapfrogIntegrator`` raises ``IntegrationError`` on
scipy LinAlg failures (``integration.py:86-98``); under XLA there are no
exceptions — non-finite values propagate through the state and are caught
by the samplers' divergence masks (NaN energy ⇒ infinite energy change ⇒
divergence), which reproduces the reference's divergence statistics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax

__all__ = ["IntegratorState", "compute_state", "leapfrog", "INTEGRATOR_COEFFS"]

# Palindromic splitting coefficients: kick weights b (len = stages + 1) and
# drift weights a (len = stages). One model (gradient) evaluation per drift.
#
# - "leapfrog": velocity Verlet, the reference's only integrator
#   (``integration.py:100-121``).
# - "two_stage": minimal-norm two-stage scheme of Blanes, Casas &
#   Sanz-Serna (2014) (McLachlan coefficients) — ~half the energy-error
#   constant of leapfrog per model eval; run with ~1.5-2x the step size.
# - "three_stage": minimal-norm three-stage scheme (ibid.).
#
# See PAPERS.md: "On the application of higher order symplectic
# integrators in Hamiltonian Monte Carlo".
_LAMBDA_2 = 0.1931833275037836
_A1_3 = 0.29619504261126
_B1_3 = 0.11888010966548
INTEGRATOR_COEFFS = {
    "leapfrog": ((0.5, 0.5), (1.0,)),
    "two_stage": ((_LAMBDA_2, 1.0 - 2.0 * _LAMBDA_2, _LAMBDA_2), (0.5, 0.5)),
    "three_stage": (
        (_B1_3, 0.5 - _B1_3, 0.5 - _B1_3, _B1_3),
        (_A1_3, 1.0 - 2.0 * _A1_3, _A1_3),
    ),
}

LogpGradFn = Callable[[jax.Array], Tuple[jax.Array, jax.Array]]


class IntegratorState(NamedTuple):
    """Phase-space point (reference ``integration.py:25``)."""

    q: jax.Array  # position, (n,)
    p: jax.Array  # momentum, (n,)
    v: jax.Array  # velocity = M^{-1} p, (n,)
    q_grad: jax.Array  # d logp / dq, (n,)
    energy: jax.Array  # scalar: kinetic - logp
    model_logp: jax.Array  # scalar


def compute_state(
    potential, logp_grad_fn: LogpGradFn, q: jax.Array, p: jax.Array
) -> IntegratorState:
    """Evaluate Hamiltonian functions at ``(q, p)`` (reference ``integration.py:52-66``)."""
    logp, grad = logp_grad_fn(q)
    v = potential.velocity(p)
    kinetic = potential.kinetic(p, v)
    return IntegratorState(q, p, v, grad, kinetic - logp, logp)


def recompute_with_momentum(
    potential, state_q: jax.Array, q_grad: jax.Array, logp: jax.Array, p: jax.Array
) -> IntegratorState:
    """Build a fresh trajectory start reusing a cached ``(logp, grad)``.

    The reference re-evaluates the model at the current position every draw
    (``base_hmc.py:143`` → ``integration.py:62``) even though the value is
    identical to the previous proposal's; caching it saves one model
    evaluation per draw at no statistical cost.
    """
    v = potential.velocity(p)
    kinetic = potential.kinetic(p, v)
    return IntegratorState(state_q, p, v, q_grad, kinetic - logp, logp)


def leapfrog(
    potential,
    logp_grad_fn: LogpGradFn,
    epsilon: jax.Array,
    state: IntegratorState,
    scheme: str = "leapfrog",
) -> IntegratorState:
    """One symplectic integrator step (default: kick-drift-kick leapfrog).

    Matches reference ``integration.py:100-121`` for the default scheme;
    ``scheme`` selects a higher-order palindromic splitting from
    :data:`INTEGRATOR_COEFFS`. Like the reference, the returned velocity
    is ``M^{-1} p_final`` (the reference's ``velocity_energy`` overwrites
    ``v_new`` in place at ``integration.py:118``), which is what the NUTS
    U-turn checks consume.
    """
    b, a = INTEGRATOR_COEFFS[scheme]

    p = state.p + (b[0] * epsilon) * state.q_grad
    q, logp, grad = state.q, state.model_logp, state.q_grad
    for i, ai in enumerate(a):
        v = potential.velocity(p)
        q = (q + (ai * epsilon) * v).astype(state.q.dtype)
        logp, grad = logp_grad_fn(q)
        p = p + (b[i + 1] * epsilon) * grad

    v = potential.velocity(p)
    kinetic = potential.kinetic(p, v)
    return IntegratorState(q, p, v, grad, kinetic - logp, logp)
