"""Lockstep chain-batched NUTS: all chains share each leapfrog inner step.

The per-chain NUTS kernel (inference/nuts.py) under vmap makes XLA
differentiate the log density PER CHAIN — separate forward/backward dataset
passes per chain per leaf instead of one batched product for all chains,
which at MNIST scale is far slower per draw than the chain-batched HMC
path on the same posterior.

This module is the fused-path NUTS: the iterative (numpyro-style) tree
builder is restructured so that EVERY chain takes each leapfrog step
together through ONE chain-batched ``value_and_grad`` call — the same
callable hmc.build_batched_kernel takes, so one batched value+grad serves
every chain's leaf with a single pass over the dataset.  Chains whose
trees have terminated (U-turn or divergence) mask out of the state updates
(padded iteration) but ride along in the batched compute; because the
doubling schedule is shared, total leapfrog work is max-over-chains rather
than sum-over-chains — cheap when chains mix at similar depths (the
whitened Gauss-Newton regime of BASELINE config 3, typical depth 2-4).

Algorithmic content (multinomial proposals, biased progressive sampling,
Betancourt momentum-sum U-turn criterion with trailing-bits checkpoints)
matches inference/nuts.py exactly; only the execution strategy differs.
Tree bookkeeping indices (leaf parity, checkpoint slots) depend ONLY on the
shared leaf counter, so they remain scalars — the per-chain state is the
(C, D) flat phase-space arrays and (C,) accumulators.

No reference counterpart (the reference has no NUTS; north-star addition,
BASELINE.json config 3).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..ops.tree import tree_batch_ravel
from .nuts import NUTSInfo, NUTSState, _bit_count, _trailing_ones

Params = Any


class _BTree(NamedTuple):
    # every field chain-batched: (C, D) vectors or (C,) scalars
    z_left: jnp.ndarray
    r_left: jnp.ndarray
    g_left: jnp.ndarray
    z_right: jnp.ndarray
    r_right: jnp.ndarray
    g_right: jnp.ndarray
    z_prop: jnp.ndarray
    logp_prop: jnp.ndarray
    g_prop: jnp.ndarray
    energy_prop: jnp.ndarray
    r_sum: jnp.ndarray
    log_weight: jnp.ndarray
    sum_accept: jnp.ndarray
    num_leaves: jnp.ndarray
    diverging: jnp.ndarray
    turning: jnp.ndarray


def batched_init(positions: Params, value_and_grad_fn: Callable) -> NUTSState:
    """Init a chain-batched NUTSState: leaves carry a leading chain axis and
    ``value_and_grad_fn`` maps batched positions to ((C,), batched grads)."""
    value, grad = value_and_grad_fn(positions)
    return NUTSState(positions, value, grad)


def build_batched_kernel(
    value_and_grad_fn: Callable,
    max_tree_depth: int = 10,
    divergence_threshold: float = 1000.0,
):
    """Returns step(key, state, step_sizes, inv_mass) -> (state, info).

    ``value_and_grad_fn``: chain-batched positions pytree (leaves (C, ...))
    -> ((C,) log densities, batched grads).  Every leaf of every chain's
    tree costs ONE call on the full batch — plug in the whitened batched
    value+grad (ops/kron_metric.make_whitened_fused_vag), exactly as the
    headline bench does for HMC (bench.py).

    ``key``: a single key (split into per-chain keys internally — what
    warmup.run_warmup passes) or a (C,) per-chain key array (what the
    sharded driver passes; per-chain keys make the randomness independent
    of how the chain axis is blocked across devices).

    ``step_sizes``: (C,) per-chain step sizes.  ``inv_mass``: chain-batched
    diagonal inverse-mass pytree (leaves (C, ...)), or None for identity —
    use identity in whitened coordinates (the metric lives in the
    whitening maps around ``value_and_grad_fn``, not here).

    Info fields are (C,) vectors; ``num_integration_steps`` counts the
    leaves each chain actually integrated (its tree size), ``depth`` the
    doubling at which its tree stopped.
    """

    def step(key, state: NUTSState, step_sizes, inv_mass):
        z0, unravel = tree_batch_ravel(state.position)          # (C, D)
        g0, _ = tree_batch_ravel(state.logdensity_grad)
        num_chains, dim = z0.shape
        if inv_mass is None:
            im = jnp.ones_like(z0)
        else:
            im, _ = tree_batch_ravel(inv_mass)                  # (C, D)

        if jnp.ndim(key) == 0:
            keys = jax.random.split(key, num_chains)            # (C,)
        else:
            keys = key

        eps = jnp.asarray(step_sizes, jnp.float32)              # (C,)

        def vag_flat(z):
            v, g = value_and_grad_fn(unravel(z))
            return v, tree_batch_ravel(g)[0]

        def leapfrog(z, r, g, direction):
            e = (direction * eps)[:, None]                      # (C, 1)
            r = r + 0.5 * e * g
            z = z + e * im * r
            v, g = vag_flat(z)
            r = r + 0.5 * e * g
            return z, r, v, g

        def kinetic(r):
            return 0.5 * jnp.sum(im * r * r, axis=1)            # (C,)

        def is_turning(r_left, r_right, rho):
            # Betancourt's generalized criterion, boundary momenta at
            # weight 1/2 (see nuts.py:is_turning for the dimensional
            # argument) — batched over chains
            rho = rho - 0.5 * (r_left + r_right)
            dl = jnp.sum(im * r_left * rho, axis=1)
            dr = jnp.sum(im * r_right * rho, axis=1)
            return jnp.logical_or(dl <= 0.0, dr <= 0.0)         # (C,)

        split2 = jax.vmap(lambda k: tuple(jax.random.split(k)))
        unif = jax.vmap(jax.random.uniform)

        k_mom, k_tree = split2(keys)
        r0 = jnp.sqrt(1.0 / im) * jax.vmap(
            lambda k: jax.random.normal(k, (dim,))
        )(k_mom)
        energy0 = -state.logdensity + kinetic(r0)               # (C,)

        zeros_c = jnp.zeros((num_chains,), jnp.float32)
        false_c = jnp.zeros((num_chains,), bool)
        init_tree = _BTree(
            z_left=z0, r_left=r0, g_left=g0,
            z_right=z0, r_right=r0, g_right=g0,
            z_prop=z0, logp_prop=state.logdensity, g_prop=g0,
            energy_prop=energy0,
            r_sum=r0, log_weight=zeros_c,
            sum_accept=zeros_c, num_leaves=jnp.zeros((num_chains,), jnp.int32),
            diverging=false_c, turning=false_c,
        )

        # --- one depth-d subtree, all chains in lockstep -------------------
        def build_subtree(keys_sub, tree: _BTree, depth, direction, active):
            num_target = jnp.int32(1) << depth

            pos = direction > 0                                 # (C,)
            z_e = jnp.where(pos[:, None], tree.z_right, tree.z_left)
            r_e = jnp.where(pos[:, None], tree.r_right, tree.r_left)
            g_e = jnp.where(pos[:, None], tree.g_right, tree.g_left)

            ckpt_shape = (num_chains, max_tree_depth + 1, dim)

            class Carry(NamedTuple):
                leaf_idx: jnp.ndarray       # SHARED scalar
                keys: jnp.ndarray           # (C,) per-chain keys
                z: jnp.ndarray
                r: jnp.ndarray
                g: jnp.ndarray
                z_prop: jnp.ndarray
                logp_prop: jnp.ndarray
                g_prop: jnp.ndarray
                energy_prop: jnp.ndarray
                r_sum: jnp.ndarray
                log_weight: jnp.ndarray
                sum_accept: jnp.ndarray
                num_leaves: jnp.ndarray
                r_ckpts: jnp.ndarray
                rsum_ckpts: jnp.ndarray
                diverging: jnp.ndarray
                turning: jnp.ndarray

            carry0 = Carry(
                leaf_idx=jnp.int32(0), keys=keys_sub,
                z=z_e, r=r_e, g=g_e,
                z_prop=z_e, logp_prop=jnp.full((num_chains,), -jnp.inf),
                g_prop=g_e, energy_prop=jnp.full((num_chains,), jnp.inf),
                r_sum=jnp.zeros_like(r_e),
                log_weight=jnp.full((num_chains,), -jnp.inf),
                sum_accept=zeros_c,
                num_leaves=jnp.zeros((num_chains,), jnp.int32),
                r_ckpts=jnp.zeros(ckpt_shape, z0.dtype),
                rsum_ckpts=jnp.zeros(ckpt_shape, z0.dtype),
                diverging=false_c, turning=false_c,
            )

            def mask_of(c: Carry):
                return jnp.logical_and(
                    active, jnp.logical_not(
                        jnp.logical_or(c.diverging, c.turning)))

            def cond_fn(c: Carry):
                return jnp.logical_and(c.leaf_idx < num_target,
                                       jnp.any(mask_of(c)))

            def body_fn(c: Carry):
                mask = mask_of(c)                               # (C,)
                maskc = mask[:, None]
                k_next, k_mult = split2(c.keys)

                z_new, r_new, v_new, g_new = leapfrog(c.z, c.r, c.g,
                                                      direction)
                # freeze terminated chains at their last valid state so the
                # next (wasted) lockstep leapfrog integrates finite values
                z = jnp.where(maskc, z_new, c.z)
                r = jnp.where(maskc, r_new, c.r)
                g = jnp.where(maskc, g_new, c.g)

                energy = -v_new + kinetic(r_new)
                energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
                delta = energy0 - energy
                div_new = -delta > divergence_threshold
                log_w = delta
                accept = jnp.minimum(1.0, jnp.exp(delta))

                # progressive multinomial proposal within the subtree
                new_total = jnp.logaddexp(c.log_weight, log_w)
                p_take = jnp.exp(log_w - new_total)
                take = jnp.logical_and(unif(k_mult) < p_take, mask)
                takec = take[:, None]
                z_prop = jnp.where(takec, z, c.z_prop)
                logp_prop = jnp.where(take, v_new, c.logp_prop)
                g_prop = jnp.where(takec, g, c.g_prop)
                energy_prop = jnp.where(take, energy, c.energy_prop)

                r_sum = jnp.where(maskc, c.r_sum + r, c.r_sum)
                i = c.leaf_idx                                  # SHARED

                # trailing-bits checkpointing (slots depend only on the
                # shared counter): even leaves store, odd leaves check
                idx_max = _bit_count(i >> 1)
                num_trailing = _trailing_ones(i)
                idx_min = idx_max - num_trailing + 1
                is_even = (i % 2) == 0

                # single-slot dynamic_update with a mask folding in the
                # even/odd store condition: only the (C, D) slot is
                # touched; odd leaves write back the slot's own values.
                # (A lax.cond around the store breaks XLA's while-loop
                # buffer aliasing — the (C, depth+1, D) checkpoint buffers
                # get copied through the cond boundary: measured 16.3 vs
                # 9.7 ms/leaf at MNIST bench shapes.)
                storec = jnp.logical_and(is_even, mask)[..., None]
                r_ck = c.r_ckpts.at[:, idx_max].set(
                    jnp.where(storec, r, c.r_ckpts[:, idx_max]))
                rs_ck = c.rsum_ckpts.at[:, idx_max].set(
                    jnp.where(storec, r_sum, c.rsum_ckpts[:, idx_max]))

                def check_turning(_):
                    # scan the shared checkpoint range, OR over chains
                    def tcond(s):
                        j, _t = s
                        return j >= idx_min

                    def tbody(s):
                        j, t = s
                        rho = r_sum - rs_ck[:, j] + r_ck[:, j]
                        t = jnp.logical_or(t, is_turning(r_ck[:, j], r, rho))
                        return j - 1, t

                    _, t = jax.lax.while_loop(tcond, tbody,
                                              (idx_max, false_c))
                    return t

                turn_new = jax.lax.cond(
                    jnp.logical_not(is_even), check_turning,
                    lambda _: false_c, None)
                turn_new = jnp.logical_and(
                    turn_new, jnp.logical_not(div_new))

                return Carry(
                    leaf_idx=i + 1, keys=k_next, z=z, r=r, g=g,
                    z_prop=z_prop, logp_prop=logp_prop, g_prop=g_prop,
                    energy_prop=energy_prop,
                    r_sum=r_sum,
                    log_weight=jnp.where(mask, new_total, c.log_weight),
                    sum_accept=jnp.where(mask, c.sum_accept + accept,
                                         c.sum_accept),
                    num_leaves=c.num_leaves + mask.astype(jnp.int32),
                    r_ckpts=r_ck, rsum_ckpts=rs_ck,
                    diverging=jnp.where(mask, div_new, c.diverging),
                    turning=jnp.where(mask, turn_new, c.turning),
                )

            c = jax.lax.while_loop(cond_fn, body_fn, carry0)

            posc = pos[:, None]
            return _BTree(
                z_left=jnp.where(posc, z_e, c.z),
                r_left=jnp.where(posc, r_e, c.r),
                g_left=jnp.where(posc, g_e, c.g),
                z_right=jnp.where(posc, c.z, z_e),
                r_right=jnp.where(posc, c.r, r_e),
                g_right=jnp.where(posc, c.g, g_e),
                z_prop=c.z_prop, logp_prop=c.logp_prop, g_prop=c.g_prop,
                energy_prop=c.energy_prop,
                r_sum=c.r_sum, log_weight=c.log_weight,
                sum_accept=c.sum_accept, num_leaves=c.num_leaves,
                diverging=c.diverging, turning=c.turning,
            )

        # --- top-level doubling loop, shared depth counter ------------------
        class Outer(NamedTuple):
            tree: _BTree
            depth: jnp.ndarray          # SHARED scalar
            keys: jnp.ndarray           # (C,)
            chain_depth: jnp.ndarray    # (C,) doubling each chain reached

        def outer_active(t: _BTree):
            return jnp.logical_not(jnp.logical_or(t.diverging, t.turning))

        def outer_cond(o: Outer):
            return jnp.logical_and(o.depth < max_tree_depth,
                                   jnp.any(outer_active(o.tree)))

        def outer_body(o: Outer):
            tree = o.tree
            active = outer_active(tree)                         # (C,)
            activec = active[:, None]
            k_dir, rest = split2(o.keys)
            k_sub, rest = split2(rest)
            k_bias, k_next = split2(rest)

            direction = jnp.where(
                jax.vmap(jax.random.bernoulli)(k_dir),
                jnp.float32(1.0), jnp.float32(-1.0))            # (C,)
            sub = build_subtree(k_sub, tree, o.depth, direction, active)

            pos = direction > 0
            posc = pos[:, None]
            z_left = jnp.where(posc, tree.z_left, sub.z_left)
            r_left = jnp.where(posc, tree.r_left, sub.r_left)
            g_left = jnp.where(posc, tree.g_left, sub.g_left)
            z_right = jnp.where(posc, sub.z_right, tree.z_right)
            r_right = jnp.where(posc, sub.r_right, tree.r_right)
            g_right = jnp.where(posc, sub.g_right, tree.g_right)

            sub_invalid = jnp.logical_or(sub.diverging, sub.turning)

            # biased progressive sampling across subtrees (Stan)
            p_take = jnp.exp(jnp.minimum(
                sub.log_weight - tree.log_weight, 0.0))
            take = jnp.logical_and(
                jnp.logical_and(unif(k_bias) < p_take,
                                jnp.logical_not(sub_invalid)),
                active)
            takec = take[:, None]
            z_prop = jnp.where(takec, sub.z_prop, tree.z_prop)
            logp_prop = jnp.where(take, sub.logp_prop, tree.logp_prop)
            g_prop = jnp.where(takec, sub.g_prop, tree.g_prop)
            energy_prop = jnp.where(take, sub.energy_prop, tree.energy_prop)

            r_sum = jnp.where(activec, tree.r_sum + sub.r_sum, tree.r_sum)
            full_turning = is_turning(r_left, r_right, r_sum)
            turning = jnp.where(
                active, jnp.logical_or(sub.turning, full_turning),
                tree.turning)

            new_tree = _BTree(
                z_left=jnp.where(activec, z_left, tree.z_left),
                r_left=jnp.where(activec, r_left, tree.r_left),
                g_left=jnp.where(activec, g_left, tree.g_left),
                z_right=jnp.where(activec, z_right, tree.z_right),
                r_right=jnp.where(activec, r_right, tree.r_right),
                g_right=jnp.where(activec, g_right, tree.g_right),
                z_prop=z_prop, logp_prop=logp_prop, g_prop=g_prop,
                energy_prop=energy_prop,
                r_sum=r_sum,
                log_weight=jnp.where(
                    active, jnp.logaddexp(tree.log_weight, sub.log_weight),
                    tree.log_weight),
                sum_accept=jnp.where(
                    active, tree.sum_accept + sub.sum_accept,
                    tree.sum_accept),
                num_leaves=tree.num_leaves + jnp.where(
                    active, sub.num_leaves, 0),
                diverging=jnp.where(active, sub.diverging, tree.diverging),
                turning=turning,
            )
            chain_depth = jnp.where(active, o.depth + 1, o.chain_depth)
            return Outer(new_tree, o.depth + 1, k_next, chain_depth)

        out = jax.lax.while_loop(
            outer_cond, outer_body,
            Outer(init_tree, jnp.int32(0), k_tree,
                  jnp.zeros((num_chains,), jnp.int32)),
        )
        tree = out.tree

        accepted = jnp.any(tree.z_prop != z0, axis=1)           # (C,)
        new_state = NUTSState(unravel(tree.z_prop), tree.logp_prop,
                              unravel(tree.g_prop))
        info = NUTSInfo(
            acceptance_prob=tree.sum_accept
            / jnp.maximum(tree.num_leaves.astype(jnp.float32), 1.0),
            is_accepted=accepted,
            energy=tree.energy_prop,
            is_divergent=tree.diverging,
            num_integration_steps=tree.num_leaves,
            depth=out.chain_depth,
        )
        return new_state, info

    return step
