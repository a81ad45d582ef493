"""Hamiltonian Monte Carlo as a pure lax.scan kernel.

Capability parity with /root/reference/hamiltonian/inference/cpu/hmc.py and
gpu/hmc.py (single source here — the cpu/gpu duplication collapses into one
XLA program).  Fixes folded in by design (SURVEY.md §2):

- correct velocity-Verlet ordering with ONE grad eval per step
  (reference loops per-variable and re-evaluates grad per variable, :49-54);
- dual averaging is actually applied during warmup (reference constructs
  DualAveragingStepSize but only calls update() once after burn-in, :94-104);
- jittered trajectory length L ~ ceil(U(0,1) * L_max) reproduces the
  reference's L = ceil(2*U*path_length/eps) randomization (:46) without
  host-side control flow;
- diagonal mass-matrix adaptation (reference: identity only, :17-26).

The kernel signature is (key, state, step_size, inv_mass) -> (state, info):
step size and mass matrix are *data*, so one compiled program serves warmup,
sampling, and vmapped multi-chain execution with per-chain step sizes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.integrators import (
    IntegratorState,
    trajectory,
    velocity_verlet,
    velocity_verlet_batched,
)
from ..ops.metrics import batched_diagonal_metric, diagonal_metric
from ..ops.tree import tree_where, tree_where_bcast

Params = Any


class HMCState(NamedTuple):
    position: Params
    logdensity: jnp.ndarray
    logdensity_grad: Params


class HMCInfo(NamedTuple):
    acceptance_prob: jnp.ndarray
    is_accepted: jnp.ndarray
    energy: jnp.ndarray
    is_divergent: jnp.ndarray
    num_integration_steps: jnp.ndarray


def init(position: Params, logdensity_fn: Callable) -> HMCState:
    value, grad = jax.value_and_grad(logdensity_fn)(position)
    return HMCState(position, value, grad)


def build_kernel(
    logdensity_fn: Callable,
    num_integration_steps: int,
    jitter_steps: bool = True,
    divergence_threshold: float = 1000.0,
    metric=None,
):
    """Returns step(key, state, step_size, inv_mass) -> (state, info).

    With jitter_steps=True the number of leapfrog steps per draw is
    ceil(U(0,1) * num_integration_steps) — decorrelates trajectories the same
    way the reference's randomized path length does (cpu/hmc.py:46).

    ``metric``: an ops.metrics.Metric overriding the default diagonal metric
    (the inv_mass argument is then ignored) — e.g. the Kronecker Gauss-Newton
    metric of ops/kron_metric.py for GLM posteriors.
    """

    def step(key, state: HMCState, step_size, inv_mass):
        key_mom, key_steps, key_accept = jax.random.split(key, 3)
        m = metric if metric is not None else diagonal_metric(inv_mass)
        integ = velocity_verlet(logdensity_fn, m.kinetic_grad)

        momentum = m.sample_momentum(key_mom, state.position)
        energy0 = -state.logdensity + m.kinetic_energy(momentum)

        if jitter_steps:
            u = jax.random.uniform(key_steps)
            n_steps = jnp.ceil(u * num_integration_steps).astype(jnp.int32)
            n_steps = jnp.maximum(n_steps, 1)
        else:
            n_steps = num_integration_steps

        run = trajectory(integ, n_steps)
        start = IntegratorState(
            state.position, momentum, state.logdensity, state.logdensity_grad
        )
        end = run(start, step_size)

        energy1 = -end.logdensity + m.kinetic_energy(end.momentum)
        delta = energy0 - energy1
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        accept_prob = jnp.minimum(1.0, jnp.exp(delta))
        is_divergent = jnp.abs(delta) > divergence_threshold

        accept = jax.random.uniform(key_accept) < accept_prob
        proposal = HMCState(end.position, end.logdensity, end.logdensity_grad)
        new_state = tree_where(accept, proposal, state)

        info = HMCInfo(
            acceptance_prob=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=is_divergent,
            num_integration_steps=jnp.asarray(n_steps),
        )
        return HMCState(*new_state), info

    return step


def batched_init(positions: Params, value_and_grad_fn: Callable) -> HMCState:
    """Init a chain-batched HMCState: leaves carry a leading chain axis and
    ``value_and_grad_fn`` maps the batched positions to ((C,), batched grads)."""
    value, grad = value_and_grad_fn(positions)
    return HMCState(positions, value, grad)


def build_batched_kernel(
    value_and_grad_fn: Callable,
    num_integration_steps: int,
    divergence_threshold: float = 1000.0,
    grad_fn: Optional[Callable] = None,
):
    """Chain-batched HMC: ALL chains advance inside one kernel call.

    Instead of vmapping the per-chain kernel (which makes XLA differentiate
    the log density with separate forward/backward dataset passes), the
    integrator calls ``value_and_grad_fn`` on the full chain-stacked position
    pytree — so a batched multi-chain value+grad
    (ops/kron_metric.make_whitened_fused_vag) serves every chain with ONE
    pass over the data.

    ``grad_fn`` (optional, positions -> batched grads OR (noisy_value,
    grads)): lazy-value trajectories.  The MH accept only needs the log
    density at the trajectory ENDPOINTS, so the first L-1 leapfrog steps use
    the cheaper grad-only function and ``value_and_grad_fn`` runs once, at
    the proposal.  The gradient may be noisier
    than value_and_grad_fn's: gradient error only perturbs the proposal
    (detailed balance is preserved by the accurate endpoint energies).

    Returns step(key, state, step_sizes, inv_mass) -> (state, info) where
    state leaves have a leading chain axis C, state.logdensity is (C,),
    step_sizes is (C,), and inv_mass leaves are chain-batched.  Info fields
    are (C,)-vectors.  Trajectory length is fixed (no jitter): one compiled
    scan serves all chains, matching the flagship bench configuration.

    ``key`` may be a single key (shared randomness drawn over the full chain
    batch — the original behavior) or a (C,) PER-CHAIN key array: momentum
    and accept draws are then derived per chain, which makes the kernel's
    randomness independent of how the chain axis is blocked — the property
    the sharded path needs (parallel/chains.sample_batched_sharded shards the
    chain axis over devices; with per-chain keys the sharded run is
    numerically IDENTICAL to the single-device run, asserted in
    __graft_entry__.dryrun_multichip and tests/test_parallel.py).
    """
    from ..ops.tree import tree_axpy_bcast, tree_randn_like

    def step(key, state: HMCState, step_sizes, inv_mass):
        m = batched_diagonal_metric(inv_mass)

        if jnp.ndim(key) == 1:
            both = jax.vmap(lambda k: jax.random.split(k, 2))(key)  # (C, 2)
            key_mom, key_accept = both[:, 0], both[:, 1]
            # per-chain momentum: each chain's eps from its own key, scaled
            # by the (chain-batched) diagonal mass
            eps = jax.vmap(tree_randn_like)(key_mom, state.position)
            momentum = jax.tree_util.tree_map(
                lambda im, e: e / jnp.sqrt(im), inv_mass, eps)
        else:
            key_mom, key_accept = jax.random.split(key)
            momentum = m.sample_momentum(key_mom, state.position)

        energy0 = -state.logdensity + m.kinetic_energy(momentum)    # (C,)

        start = IntegratorState(
            state.position, momentum, state.logdensity, state.logdensity_grad
        )
        if grad_fn is None:
            integ = velocity_verlet_batched(value_and_grad_fn, m.kinetic_grad)
            run = trajectory(integ, num_integration_steps)
            end = run(start, step_sizes)
        else:
            def grad_only(q):
                out = grad_fn(q)
                return out[1] if isinstance(out, tuple) else out

            def cheap_vag(q):
                # logdensity entry stays stale through the inner steps; the
                # accurate value is evaluated once below, at the proposal
                return state.logdensity, grad_only(q)

            integ = velocity_verlet_batched(cheap_vag, m.kinetic_grad)
            run = trajectory(integ, num_integration_steps - 1)
            mid = run(start, step_sizes)
            # final leapfrog step evaluates the ACCURATE value+grad at the
            # proposal; its grad also seeds the next draw's first half-step
            q, p = mid.position, mid.momentum
            p = tree_axpy_bcast(0.5 * step_sizes, mid.logdensity_grad, p)
            v = m.kinetic_grad(p)
            q = tree_axpy_bcast(step_sizes, v, q)
            value, g = value_and_grad_fn(q)
            p = tree_axpy_bcast(0.5 * step_sizes, g, p)
            end = IntegratorState(q, p, value, g)

        energy1 = -end.logdensity + m.kinetic_energy(end.momentum)  # (C,)
        delta = energy0 - energy1
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        accept_prob = jnp.minimum(1.0, jnp.exp(delta))
        is_divergent = jnp.abs(delta) > divergence_threshold

        if jnp.ndim(key) == 1:
            u = jax.vmap(lambda k: jax.random.uniform(k))(key_accept)
        else:
            u = jax.random.uniform(key_accept, accept_prob.shape)
        accept = u < accept_prob                                    # (C,)
        proposal = HMCState(end.position, end.logdensity, end.logdensity_grad)
        new_state = tree_where_bcast(accept, proposal, state)

        info = HMCInfo(
            acceptance_prob=accept_prob,
            is_accepted=accept,
            energy=energy1,
            is_divergent=is_divergent,
            num_integration_steps=jnp.full_like(
                accept_prob, num_integration_steps
            ),
        )
        return HMCState(*new_state), info

    return step
