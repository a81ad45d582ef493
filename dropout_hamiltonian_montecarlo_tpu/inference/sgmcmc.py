"""Stochastic-gradient MCMC: SGLD and SGHMC as minibatch lax.scan kernels.

Capability parity with /root/reference/hamiltonian/inference/cpu/{sgmcmc,sgld,
sghmc}.py and their gpu twins (SURVEY.md §2).  The reference's variants are
nonstandard and partially broken (N(0,2*eps)-as-std injected noise,
cpu/sgld.py:43-45; SGHMC calling undefined accept/draw_momentum,
cpu/sghmc.py:21,35); per SURVEY.md §7 we implement the *published* algorithms —
Welling & Teh (2011) SGLD and Chen et al. (2014) SGHMC with friction — while
matching the reference's observable capabilities (minibatch epochs, inverse-time
step-size decay, one retained draw per epoch, per-epoch loss trace).

Data pipeline: the dataset lives in device memory (HBM); each step gathers a
random minibatch by index inside the scan — the replacement for the
reference's producer-Process + Queue streaming (cpu/sgld_multicore.py:73-97).
Sharding the batch across a data mesh axis happens in parallel/ (psum of
gradients), not here.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.tree import tree_axpy, tree_randn_like, tree_zeros_like

Params = Any
Batch = Tuple[jnp.ndarray, ...]


# ---------------------------------------------------------------------------
# Step-size schedules
# ---------------------------------------------------------------------------


def inverse_time_decay(initial_step_size: float, decay: Optional[float] = None):
    """eps_t = eps_0 / (1 + decay * t) — the reference's lr_schedule
    (cpu/sgmcmc.py:88-89, with decay defaulting to eps_0)."""
    if decay is None:
        decay = initial_step_size

    def schedule(t):
        return initial_step_size / (1.0 + decay * t)

    return schedule


def constant_schedule(step_size: float):
    def schedule(t):
        return jnp.full((), step_size, jnp.float32)

    return schedule


def polynomial_decay(a: float, b: float, gamma: float = 0.55):
    """Welling-Teh polynomial schedule eps_t = a (b + t)^-gamma."""

    def schedule(t):
        return a * jnp.power(b + t, -gamma)

    return schedule


# ---------------------------------------------------------------------------
# SGLD (Welling & Teh 2011)
# ---------------------------------------------------------------------------


class SGLDState(NamedTuple):
    position: Params
    logdensity: jnp.ndarray   # minibatch-scaled log posterior at last step


class SGMCMCInfo(NamedTuple):
    logdensity: jnp.ndarray
    step_size: jnp.ndarray


def sgld_init(position: Params) -> SGLDState:
    return SGLDState(position, jnp.float32(0.0))


def _make_vag(logdensity_fn, keyed, value_and_grad_fn):
    """Unify the kernels' gradient source: (params, batch, key|None) ->
    (value, grad).  Default = jax.value_and_grad of ``logdensity_fn``;
    ``value_and_grad_fn`` overrides it — the hook the data-parallel path
    uses (parallel/data.make_sharded_value_and_grad psums value and grad
    over the 'data' mesh axis; grad-of-psum is NOT valid under
    check_vma=False, so the override must carry the collective itself)."""
    if value_and_grad_fn is not None:
        return value_and_grad_fn
    if keyed:
        def vag(q, b, k):
            return jax.value_and_grad(
                lambda qq: logdensity_fn(qq, b, k))(q)
    else:
        def vag(q, b, k):
            return jax.value_and_grad(lambda qq: logdensity_fn(qq, b))(q)
    return vag


def build_sgld_kernel(logdensity_fn: Callable = None,
                      temperature: float = 1.0, keyed: bool = False,
                      value_and_grad_fn: Callable = None):
    """Returns step(key, state, batch, step_size) -> (state, info).

    theta <- theta + (eps/2) grad log p_hat(theta) + N(0, eps * T)
    (the correct Langevin discretization the reference's cpu/sgld.py:31-46
    approximates with nonstandard noise scaling).

    keyed=True: ``logdensity_fn`` takes (params, batch, key) — the dropout-MLP
    potential (models/mlp.py make_batched_logdensity(dropout=True)).  A fresh
    mask key is split from the step key, so masks are deterministic per
    (chain, step) and identical between the value and grad of one step —
    the dropout-inside-MCMC capability the repo is named for (reference only
    combined dropout with SGD: cpu/sgd.py:59-66 + gpu/mlp.py:19-31).

    value_and_grad_fn: optional (params, batch, key|None) -> (value, grad)
    override — the data-parallel composition point (see _make_vag)."""
    vag = _make_vag(logdensity_fn, keyed, value_and_grad_fn)

    def step(key, state: SGLDState, batch: Batch, step_size):
        if keyed:
            key, k_mask = jax.random.split(key)
        else:
            k_mask = None
        value, grad = vag(state.position, batch, k_mask)
        noise = tree_randn_like(key, state.position)
        sigma = jnp.sqrt(step_size * temperature)
        position = jax.tree_util.tree_map(
            lambda q, g, e: q + 0.5 * step_size * g + sigma * e,
            state.position, grad, noise,
        )
        return (
            SGLDState(position, value),
            SGMCMCInfo(value, jnp.asarray(step_size)),
        )

    return step


# ---------------------------------------------------------------------------
# SGHMC (Chen, Fox & Guestrin 2014)
# ---------------------------------------------------------------------------


class SGHMCState(NamedTuple):
    position: Params
    momentum: Params
    logdensity: jnp.ndarray


def sghmc_init(position: Params) -> SGHMCState:
    return SGHMCState(position, tree_zeros_like(position), jnp.float32(0.0))


def build_sghmc_kernel(logdensity_fn: Callable = None,
                       friction: float = 1.0, temperature: float = 1.0,
                       num_leapfrog: int = 1, refresh_momentum: bool = False,
                       keyed: bool = False,
                       value_and_grad_fn: Callable = None):
    """Returns step(key, state, batch, step_size) -> (state, info).

    Per inner step (v is momentum with unit mass):
      v <- (1 - friction*eps) v + eps * grad log p_hat(q) + N(0, 2*friction*eps*T)
      q <- q + eps * v
    which is the reference's intended update (cpu/sghmc.py:28-34 — friction
    C = I there) with the published noise scale sqrt(2*friction*eps).

    refresh_momentum=False (default) keeps the momentum persistent across
    steps — the published Chen et al. (2014) dynamics, where friction+noise
    alone give the correct stationary distribution.  refresh_momentum=True
    resamples v ~ N(0, I) each outer step, matching the reference's
    draw_momentum-per-trajectory design (cpu/sghmc.py:21).

    keyed=True: ``logdensity_fn`` takes (params, batch, key); a distinct mask
    key per leapfrog step keeps masks deterministic per (chain, step) — see
    build_sgld_kernel.

    value_and_grad_fn: optional (params, batch, key|None) -> (value, grad)
    override — the data-parallel composition point (see _make_vag).
    """
    vag = _make_vag(logdensity_fn, keyed, value_and_grad_fn)

    def step(key, state: SGHMCState, batch: Batch, step_size):
        k_mom, k_noise = jax.random.split(key)
        if refresh_momentum:
            momentum = tree_randn_like(k_mom, state.position)
        else:
            momentum = state.momentum
        noise_scale = jnp.sqrt(2.0 * friction * step_size * temperature)

        def inner(carry, k):
            q, v = carry
            if keyed:
                k, k_mask = jax.random.split(k)
            else:
                k_mask = None
            _, grad = vag(q, batch, k_mask)
            eps_noise = tree_randn_like(k, q)
            v = jax.tree_util.tree_map(
                lambda vi, gi, ei: (1.0 - friction * step_size) * vi
                + step_size * gi + noise_scale * ei,
                v, grad, eps_noise,
            )
            q = tree_axpy(step_size, v, q)
            return (q, v), None

        keys = jax.random.split(k_noise, num_leapfrog)
        (position, momentum), _ = jax.lax.scan(
            inner, (state.position, momentum), keys
        )
        k_final = jax.random.fold_in(k_mom, 1) if keyed else None
        value, _ = vag(position, batch, k_final)
        return (
            SGHMCState(position, momentum, value),
            SGMCMCInfo(value, jnp.asarray(step_size)),
        )

    return step


# ---------------------------------------------------------------------------
# Minibatch scan driver
# ---------------------------------------------------------------------------


def run_sgmcmc(
    kernel: Callable,        # (key, state, batch, step_size) -> (state, info)
    initial_state,
    key: jax.Array,
    data: Batch,             # full dataset tuple of arrays, leading axis N
    batch_size: int,
    num_steps: int,
    step_size_schedule: Callable,
    collect_every: int = 1,
    burnin_steps: int = 0,
):
    """Scan num_steps minibatch updates; keep every collect_every-th draw after
    burnin_steps.  Minibatches are uniform random index gathers (with
    replacement) — unbiased, static-shape, no host round-trips.

    Returns (final_state, positions_pytree, infos) where positions has leading
    axis num_collected = (num_steps - burnin_steps) // collect_every.
    """
    n_data = data[0].shape[0]
    num_collected = max((num_steps - burnin_steps) // collect_every, 0)

    def one_step(carry, k):
        state, t = carry
        k_batch, k_step = jax.random.split(k)
        idx = jax.random.randint(k_batch, (batch_size,), 0, n_data)
        batch = tuple(d[idx] for d in data)
        step_size = step_size_schedule(t)
        state, info = kernel(k_step, state, batch, step_size)
        return (state, t + 1.0), info

    key_burn, key_sample = jax.random.split(key)
    carry = (initial_state, jnp.float32(0.0))

    if burnin_steps > 0:
        burn_keys = jax.random.split(key_burn, burnin_steps)

        def burn_body(c, k):
            c, _ = one_step(c, k)
            return c, None

        carry, _ = jax.lax.scan(burn_body, carry, burn_keys)

    # outer scan over retained draws, inner loop over collect_every steps:
    # only num_collected positions are ever materialized (the reference keeps
    # one draw per epoch the same way, cpu/sgmcmc.py:79-81).
    draw_keys = jax.random.split(key_sample, max(num_collected, 1))

    def draw_body(c, k):
        ks = jax.random.split(k, collect_every)

        def inner(i, cc):
            return one_step(cc, ks[i])[0]

        c = jax.lax.fori_loop(0, collect_every - 1, inner, c)
        c, info = one_step(c, ks[collect_every - 1])
        return c, (c[0].position, info)

    carry, (positions, infos) = jax.lax.scan(draw_body, carry, draw_keys)
    return carry[0], positions, infos


def run_sgmcmc_chains(
    kernel: Callable,
    initial_states,          # pytree with leading chain axis
    key: jax.Array,
    num_chains: int,
    data: Batch,
    **kwargs,
):
    """vmap run_sgmcmc over a chain axis (per-chain keys; shared dataset).

    The replacement for the reference's multicore SG-MCMC workers
    (cpu/sgld_multicore.py:85-104): chains are a batch axis, minibatch draws
    are per-chain random gathers, no queues.  Returns (final_states,
    positions, infos) with leading (chains, draws) axes on positions.
    """
    keys = jax.random.split(key, num_chains)

    def one_chain(state, k):
        return run_sgmcmc(kernel, state, k, data, **kwargs)

    return jax.vmap(one_chain)(initial_states, keys)
