"""ChEES-HMC: cross-chain gradient-based trajectory-length adaptation.

New capability beyond the reference (which hand-picks `path_length` and never
adapts it — /root/reference/hamiltonian/inference/cpu/hmc.py:12,46): the
Change-in-the-Estimator-of-the-Expected-Square criterion of Hoffman, Radul &
Sountsov (AISTATS 2021) tunes the HMC trajectory length by stochastic gradient
ascent, using the chain ENSEMBLE itself as the Monte Carlo estimator.

This is the vectorized-MCMC-on-accelerators recipe (PAPERS.md): the criterion

    ChEES(T) = (1/4) E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]

needs cross-chain expectations every step — free here, because the flagship
execution model already advances all chains through one fused batched kernel
(hmc.build_batched_kernel), so E[.] is a mean over the
chain axis of arrays that are already resident in HBM.  Each adaptation step:

  1. draw a quasi-random jitter h_m (Halton, base 2) shared by all chains,
     integrate every chain for L = ceil(h_m * T / eps) leapfrog steps;
  2. ascend  d ChEES/d log T  with Adam, estimating the derivative from the
     trajectory endpoints:  dq'/dT = h_m * v'  (v' = M^-1 p'), weighting each
     chain by its MH acceptance probability;
  3. adapt the (shared) step size by dual averaging on the harmonic-mean
     acceptance, the variant recommended in the paper (penalizes the
     divergent tail harder than the arithmetic mean).

All control flow is a single lax.scan over adaptation steps with a
lax.fori_loop trajectory inside — one XLA program, static shapes, no host
round-trips.  Works on any chain-batched value_and_grad and composes with the whitened-space metric machinery
(run in whitened coordinates -> inv_mass = 1).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.adaptation import (
    DualAveragingState,
    dual_averaging_init,
    dual_averaging_update,
)
from ..ops.integrators import (
    IntegratorState,
    trajectory,
    velocity_verlet_batched,
)
from ..ops.metrics import batched_diagonal_metric
from ..ops.tree import tree_ones_like, tree_where_bcast
from .hmc import HMCState

Params = Any


class AdamState(NamedTuple):
    m: jnp.ndarray
    v: jnp.ndarray
    count: jnp.ndarray


def _adam_init() -> AdamState:
    z = jnp.float32(0.0)
    return AdamState(z, z, z)


def _adam_update(state: AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    count = state.count + 1.0
    m = b1 * state.m + (1.0 - b1) * grad
    v = b2 * state.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1 ** count)
    vhat = v / (1.0 - b2 ** count)
    return AdamState(m, v, count), lr * mhat / (jnp.sqrt(vhat) + eps)


def halton_sequence(num: int, base: int = 2) -> np.ndarray:
    """Quasi-random jitter factors in (0, 1) (radical inverse, host-side)."""
    out = np.zeros(num, np.float32)
    for i in range(num):
        f, r, n = 1.0, 0.0, i + 1
        while n > 0:
            f /= base
            r += f * (n % base)
            n //= base
        out[i] = r
    return out


class ChEESResult(NamedTuple):
    state: Any                     # final chain-batched HMCState
    step_size: jnp.ndarray         # adapted shared step size (scalar)
    trajectory_length: jnp.ndarray # adapted max trajectory time T (scalar)
    num_integration_steps: jnp.ndarray  # suggested fixed L = round(T/(2 eps))
    info: Any                      # per-step (accept_mean, step_size, T, n_steps)


def run_chees_warmup(
    value_and_grad_fn: Callable,
    initial_state: HMCState,
    key: jax.Array,
    num_steps: int,
    initial_step_size: float = 0.1,
    initial_traj_length: Optional[float] = None,
    target_acceptance: float = 0.651,
    max_leapfrog_steps: int = 256,
    learning_rate: float = 0.025,
    inv_mass: Optional[Params] = None,
    divergence_threshold: float = 1000.0,
) -> ChEESResult:
    """Joint (step size, trajectory length) adaptation over a chain ensemble.

    ``value_and_grad_fn``: chain-batched positions -> ((C,) values, grads) —
    the same callable hmc.build_batched_kernel takes, so any batched
    value+grad drops in unchanged.  ``initial_state`` is a batched HMCState
    (hmc.batched_init).  Returns shared scalars: ChEES adapts ONE (eps, T)
    pair for the whole ensemble — the regime the criterion is derived for.
    """
    positions = initial_state.position
    if inv_mass is None:
        inv_mass = tree_ones_like(positions)
    metric = batched_diagonal_metric(inv_mass)

    num_chains = initial_state.logdensity.shape[0]
    halton = jnp.asarray(halton_sequence(num_steps))
    t0 = (initial_traj_length if initial_traj_length is not None
          else 10.0 * initial_step_size)

    da0 = dual_averaging_init(initial_step_size)
    adam0 = _adam_init()
    keys = jax.random.split(key, num_steps)

    integ = velocity_verlet_batched(value_and_grad_fn, metric.kinetic_grad)

    def one_step(carry, xs):
        state, da, adam, log_T = carry
        k, h = xs
        k_mom, k_acc = jax.random.split(k)

        eps = jnp.exp(da.log_step)
        T = jnp.exp(log_T)
        # jittered trajectory time shared by all chains; dynamic leapfrog
        # count inside fori_loop (static shapes, traced bound)
        t_jit = h * T
        n_steps = jnp.clip(jnp.ceil(t_jit / eps).astype(jnp.int32),
                           1, max_leapfrog_steps)

        momentum = metric.sample_momentum(k_mom, state.position)
        energy0 = -state.logdensity + metric.kinetic_energy(momentum)

        start = IntegratorState(state.position, momentum, state.logdensity,
                                state.logdensity_grad)
        end = trajectory(integ, n_steps)(start, jnp.full((num_chains,), eps))

        energy1 = -end.logdensity + metric.kinetic_energy(end.momentum)
        delta = energy0 - energy1
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        accept_prob = jnp.minimum(1.0, jnp.exp(delta))           # (C,)
        is_divergent = jnp.abs(delta) > divergence_threshold

        u = jax.random.uniform(k_acc, accept_prob.shape)
        accept = u < accept_prob
        proposal = HMCState(end.position, end.logdensity, end.logdensity_grad)
        new_state = HMCState(*tree_where_bcast(accept, proposal, state))

        # --- ChEES gradient from the trajectory endpoints ------------------
        # center both clouds with cross-chain means (the ensemble IS the
        # estimator); all reductions are over arrays already on device
        def centered_sumsq_and_proj(q_tree, qp_tree, v_tree):
            sumsq_q = jnp.zeros((num_chains,))
            sumsq_qp = jnp.zeros((num_chains,))
            proj = jnp.zeros((num_chains,))
            for ql, qpl, vl in zip(jax.tree_util.tree_leaves(q_tree),
                                   jax.tree_util.tree_leaves(qp_tree),
                                   jax.tree_util.tree_leaves(v_tree)):
                qc = ql - ql.mean(axis=0, keepdims=True)
                qpc = qpl - qpl.mean(axis=0, keepdims=True)
                axes = tuple(range(1, qc.ndim))
                sumsq_q += jnp.sum(qc * qc, axis=axes)
                sumsq_qp += jnp.sum(qpc * qpc, axis=axes)
                proj += jnp.sum(qpc * vl, axis=axes)
            return sumsq_q, sumsq_qp, proj

        v_end = metric.kinetic_grad(end.momentum)               # M^-1 p'
        ssq_q, ssq_qp, proj = centered_sumsq_and_proj(
            state.position, end.position, v_end)
        dchees = (ssq_qp - ssq_q) * proj                         # (C,)
        # acceptance-weighted ensemble mean; d t/d log T = t = h*T, and the
        # 1/2 from d(.)^2/4 is absorbed into the Adam normalizer
        w = accept_prob * jnp.where(is_divergent, 0.0, 1.0)
        g = jnp.sum(w * dchees) / jnp.maximum(jnp.sum(w), 1e-6)
        g_logT = g * t_jit                                       # chain rule
        g_logT = jnp.where(jnp.isfinite(g_logT), g_logT, 0.0)

        adam, step = _adam_update(adam, g_logT, learning_rate)
        log_T_new = log_T + step                                 # ASCENT
        # keep T realizable: at most max_leapfrog_steps full steps
        log_T_new = jnp.clip(
            log_T_new,
            jnp.log(eps),
            jnp.log(0.95 * max_leapfrog_steps * eps),
        )
        log_T_new = jnp.where(jnp.isfinite(log_T_new), log_T_new, log_T)

        # --- harmonic-mean acceptance -> dual averaging --------------------
        hm_accept = 1.0 / jnp.mean(1.0 / jnp.maximum(accept_prob, 1e-6))
        da = dual_averaging_update(da, hm_accept, target_acceptance)

        out = (jnp.mean(accept_prob), jnp.exp(da.log_step), jnp.exp(log_T_new),
               n_steps)
        return (new_state, da, adam, log_T_new), out

    (state, da, _, log_T), info = jax.lax.scan(
        one_step,
        (initial_state, da0, adam0, jnp.log(jnp.float32(t0))),
        (keys, halton),
    )
    step_size = jnp.exp(da.log_step_avg)
    T = jnp.exp(log_T)
    # fixed-L sampling suggestion: the jittered scheme realizes E[t] = T/2.
    # Clamped to max_leapfrog_steps: T is clipped against the instantaneous
    # eps during warmup, but the returned step size is the dual-averaged one,
    # which can be smaller — without the clamp 0.5*T/eps_avg could exceed the
    # cap the caller asked for.
    n_sugg = jnp.clip(jnp.round(0.5 * T / step_size), 1.0,
                      float(max_leapfrog_steps)).astype(jnp.int32)
    return ChEESResult(state, step_size, T, n_sugg, info)
