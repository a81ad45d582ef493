"""Symplectic integrators as lax.scan/fori_loop kernels.

Replaces the reference leapfrog (/root/reference/hamiltonian/inference/cpu/
hmc.py:46-54), which loops over pytree keys in Python and re-evaluates the
gradient once per variable per step (and mis-places the half-steps — a known
reference quirk, SURVEY.md §2).  Here: ONE gradient evaluation per leapfrog
step over the whole pytree, correct velocity-Verlet ordering, traced once by
XLA into a single fused program.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .tree import tree_axpy, tree_dot, tree_mul

Params = Any


class IntegratorState(NamedTuple):
    position: Params
    momentum: Params
    logdensity: jnp.ndarray
    logdensity_grad: Params


def new_integrator_state(logdensity_fn, position, momentum) -> IntegratorState:
    value, grad = jax.value_and_grad(logdensity_fn)(position)
    return IntegratorState(position, momentum, value, grad)


def velocity_verlet(
    logdensity_fn: Callable[[Params], jnp.ndarray],
    kinetic_grad_fn: Callable[[Params], Params],
) -> Callable:
    """Build one leapfrog step: (state, step_size) -> state.

    kinetic_grad_fn maps momentum -> dK/dp (= M^-1 p for diagonal mass).
    The gradient of the *log density* is used directly (position update climbs
    the density; sign convention matches potential = -logdensity).
    """
    value_and_grad = jax.value_and_grad(logdensity_fn)

    def step(state: IntegratorState, step_size) -> IntegratorState:
        q, p, _, g = state
        # half step momentum: p += (eps/2) * dlogp/dq
        p = tree_axpy(0.5 * step_size, g, p)
        # full step position: q += eps * M^-1 p
        v = kinetic_grad_fn(p)
        q = tree_axpy(step_size, v, q)
        # refresh gradient, second half momentum step
        value, g = value_and_grad(q)
        p = tree_axpy(0.5 * step_size, g, p)
        return IntegratorState(q, p, value, g)

    return step


def velocity_verlet_batched(
    value_and_grad_fn: Callable[[Params], Tuple[jnp.ndarray, Params]],
    kinetic_grad_fn: Callable[[Params], Params],
) -> Callable:
    """Chain-batched leapfrog: leaves carry a leading chain axis C,
    ``value_and_grad_fn`` maps the batched position to ((C,) values, batched
    grads) in ONE call (e.g. ops/kron_metric.make_whitened_fused_vag), and
    ``step_size`` is a per-chain (C,) vector.

    This is what vmap-of-grad cannot express: one dataset pass serving every
    chain's gradient, instead of XLA's separate forward+backward passes.
    """
    from .tree import tree_axpy_bcast

    def step(state: IntegratorState, step_size) -> IntegratorState:
        q, p, _, g = state
        p = tree_axpy_bcast(0.5 * step_size, g, p)
        v = kinetic_grad_fn(p)
        q = tree_axpy_bcast(step_size, v, q)
        value, g = value_and_grad_fn(q)
        p = tree_axpy_bcast(0.5 * step_size, g, p)
        return IntegratorState(q, p, value, g)

    return step


def trajectory(
    integrator_step: Callable,
    num_steps,
) -> Callable:
    """Integrate a full trajectory.

    ``num_steps`` may be a static int (unrolled via lax.scan) or a traced
    scalar (dynamic fori_loop — used for jittered trajectory lengths, the
    reference's L = ceil(2*U*path_length/eps), cpu/hmc.py:46).  Both lower to
    compiler-friendly loops with static shapes.
    """

    def run(state: IntegratorState, step_size) -> IntegratorState:
        if isinstance(num_steps, int):
            def body(s, _):
                return integrator_step(s, step_size), None
            state, _ = jax.lax.scan(body, state, None, length=num_steps)
            return state
        else:
            def body(_, s):
                return integrator_step(s, step_size)
            return jax.lax.fori_loop(0, num_steps, body, state)

    return run
