"""No-U-Turn Sampler (NUTS) — iterative multinomial variant.

North-star addition (BASELINE.json config 3: "MNIST softmax, full-batch NUTS
with dual-averaging"); the reference has no NUTS.  This is the
iterative formulation (Phan & Pradhan / numpyro-style) rather than Hoffman &
Gelman's recursion: a fixed-depth while_loop with O(max_depth) checkpoint
buffers for the sub-tree U-turn checks, so the whole sampler is one
compiler-friendly XLA program with static shapes — vmap/shard_map-safe for
multi-chain accelerator execution, unlike recursive tree building.

Internals run on flattened parameter vectors (ravel_pytree once per kernel
build); only the log-density sees pytrees.  The kernel signature matches
hmc.build_kernel — (key, state, step_size, inv_mass) -> (state, info) — so
window adaptation (warmup.py), the chain drivers (sampling.py) and sharding
(parallel/chains.py) compose unchanged.

U-turn criterion: momentum-sum (Betancourt) — turning when
<M^-1 r_{left}, rho> <= 0 or <M^-1 r_{right}, rho> <= 0 for the spanned
subtrajectory; checked iteratively over power-of-two blocks via the
trailing-bits checkpoint scheme.  Proposals are drawn multinomially within a
new subtree (progressive sampling) and combined across subtrees with the
biased (Stan-style) acceptance.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp

Params = Any


class NUTSState(NamedTuple):
    position: Params          # pytree (public, matches HMCState)
    logdensity: jnp.ndarray
    logdensity_grad: Params   # pytree


class NUTSInfo(NamedTuple):
    acceptance_prob: jnp.ndarray   # mean leaf accept-prob (dual-avg statistic)
    is_accepted: jnp.ndarray       # proposal differs from the initial point
    energy: jnp.ndarray
    is_divergent: jnp.ndarray
    num_integration_steps: jnp.ndarray
    depth: jnp.ndarray


def init(position: Params, logdensity_fn: Callable) -> NUTSState:
    value, grad = jax.value_and_grad(logdensity_fn)(position)
    return NUTSState(position, value, grad)


class _Tree(NamedTuple):
    # flat vectors throughout
    z_left: jnp.ndarray
    r_left: jnp.ndarray
    g_left: jnp.ndarray
    z_right: jnp.ndarray
    r_right: jnp.ndarray
    g_right: jnp.ndarray
    z_prop: jnp.ndarray       # multinomial proposal
    logp_prop: jnp.ndarray    # log density at proposal
    g_prop: jnp.ndarray
    energy_prop: jnp.ndarray
    r_sum: jnp.ndarray        # momentum sum over spanned leaves
    log_weight: jnp.ndarray   # logsumexp of (energy0 - energy_leaf)
    sum_accept: jnp.ndarray   # sum of min(1, exp(energy0 - energy_leaf))
    num_leaves: jnp.ndarray
    diverging: jnp.ndarray
    turning: jnp.ndarray


def build_kernel(
    logdensity_fn: Callable,
    max_tree_depth: int = 10,
    divergence_threshold: float = 1000.0,
    metric=None,
):
    """Returns step(key, state, step_size, inv_mass) -> (state, info).

    ``metric``: an ops.metrics.Metric with whiten/unwhiten (e.g. the
    Kronecker Gauss-Newton metric, ops/kron_metric.py) — NUTS then runs in
    the WHITENED coordinates e = M^{1/2} q with an identity mass matrix,
    which is algebraically identical to NUTS under mass matrix M but keeps
    every internal array O(1) in float32.  The public state (position,
    logdensity_grad) stays in ORIGINAL parameter space, so warmup/driver
    composition is unchanged; ``inv_mass`` is ignored in this mode.  Same
    capability hmc.build_kernel(metric=...) has — needed for full-batch NUTS
    on the ill-conditioned MNIST softmax posterior (BASELINE config 3), where
    a diagonal mass matrix cannot fix the cross-coordinate correlation."""
    if metric is not None and (metric.whiten is None or metric.unwhiten is None):
        raise ValueError("nuts metric support needs metric.whiten/unwhiten")

    def step(key, state: NUTSState, step_size, inv_mass):
        if metric is None:
            z0_flat, unravel = jax.flatten_util.ravel_pytree(state.position)
            g0_flat, _ = jax.flatten_util.ravel_pytree(state.logdensity_grad)
            im_flat, _ = jax.flatten_util.ravel_pytree(inv_mass)

            def value_and_grad_flat(z):
                v, g = jax.value_and_grad(logdensity_fn)(unravel(z))
                return v, jax.flatten_util.ravel_pytree(g)[0]

            def to_state(z_prop_flat, logp, g_prop_flat):
                return NUTSState(unravel(z_prop_flat), logp,
                                 unravel(g_prop_flat))
        else:
            # whitened coordinates: e = whiten(q); grads map through the
            # transposed linear maps (exact — whiten/unwhiten are linear)
            e0 = metric.whiten(state.position)
            z0_flat, unravel = jax.flatten_util.ravel_pytree(e0)
            unwhiten_t = jax.linear_transpose(metric.unwhiten, e0)
            whiten_t = jax.linear_transpose(metric.whiten, state.position)
            g0_flat, _ = jax.flatten_util.ravel_pytree(
                unwhiten_t(state.logdensity_grad)[0])
            im_flat = jnp.ones_like(z0_flat)

            def value_and_grad_flat(z):
                q = metric.unwhiten(unravel(z))
                v, gq = jax.value_and_grad(logdensity_fn)(q)
                ge = unwhiten_t(gq)[0]
                return v, jax.flatten_util.ravel_pytree(ge)[0]

            def to_state(z_prop_flat, logp, g_prop_flat):
                ge = unravel(g_prop_flat)
                return NUTSState(metric.unwhiten(unravel(z_prop_flat)), logp,
                                 whiten_t(ge)[0])

        dim = z0_flat.shape[0]

        def leapfrog(z, r, g, direction):
            eps = direction * step_size
            r = r + 0.5 * eps * g
            z = z + eps * im_flat * r
            v, g = value_and_grad_flat(z)
            r = r + 0.5 * eps * g
            return z, r, v, g

        def kinetic(r):
            return 0.5 * jnp.sum(im_flat * r * r)

        def is_turning(r_left, r_right, rho):
            # Betancourt's generalized criterion (Stan/numpyro form): the
            # boundary momenta enter the trajectory sum with weight 1/2.
            # Without this correction the edge self-term |r_edge|^2 ~ +dim
            # dominates the dot product in high dimension and U-turns are
            # never detected (trees always run to max_tree_depth — observed
            # at D=128: 173/200 draws at depth 8 before the fix, ~depth 4
            # after).
            rho = rho - 0.5 * (r_left + r_right)
            v_left = im_flat * r_left
            v_right = im_flat * r_right
            return jnp.logical_or(
                jnp.dot(v_left, rho) <= 0.0, jnp.dot(v_right, rho) <= 0.0
            )

        key_mom, key_tree = jax.random.split(key)
        r0 = jnp.sqrt(1.0 / im_flat) * jax.random.normal(key_mom, (dim,))
        energy0 = -state.logdensity + kinetic(r0)

        init_tree = _Tree(
            z_left=z0_flat, r_left=r0, g_left=g0_flat,
            z_right=z0_flat, r_right=r0, g_right=g0_flat,
            z_prop=z0_flat, logp_prop=state.logdensity, g_prop=g0_flat,
            energy_prop=energy0,
            r_sum=r0, log_weight=jnp.float32(0.0),
            sum_accept=jnp.float32(0.0), num_leaves=jnp.int32(0),
            diverging=jnp.bool_(False), turning=jnp.bool_(False),
        )

        # --- one subtree of 2^depth leaves built leaf-by-leaf ---------------
        def build_subtree(key, tree: _Tree, depth, direction):
            num_target = jnp.int32(1) << depth

            r_ckpts = jnp.zeros((max_tree_depth + 1, dim), z0_flat.dtype)
            rsum_ckpts = jnp.zeros((max_tree_depth + 1, dim), z0_flat.dtype)

            def edge(tree):
                return jax.lax.cond(
                    direction > 0,
                    lambda t: (t.z_right, t.r_right, t.g_right),
                    lambda t: (t.z_left, t.r_left, t.g_left),
                    tree,
                )

            z_e, r_e, g_e = edge(tree)

            class Carry(NamedTuple):
                leaf_idx: jnp.ndarray
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
                r_ckpts: jnp.ndarray
                rsum_ckpts: jnp.ndarray
                diverging: jnp.ndarray
                turning: jnp.ndarray
                key: jnp.ndarray

            carry0 = Carry(
                leaf_idx=jnp.int32(0), z=z_e, r=r_e, g=g_e,
                z_prop=z_e, logp_prop=jnp.float32(-jnp.inf),
                g_prop=g_e, energy_prop=jnp.float32(jnp.inf),
                r_sum=jnp.zeros_like(r_e),
                log_weight=jnp.float32(-jnp.inf),
                sum_accept=jnp.float32(0.0),
                r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts,
                diverging=jnp.bool_(False), turning=jnp.bool_(False),
                key=key,
            )

            def cond_fn(c: Carry):
                return jnp.logical_and(
                    c.leaf_idx < num_target,
                    jnp.logical_not(jnp.logical_or(c.diverging, c.turning)),
                )

            def body_fn(c: Carry):
                k_next, k_mult = jax.random.split(c.key)
                z, r, v, g = leapfrog(c.z, c.r, c.g, direction)
                energy = -v + kinetic(r)
                energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
                delta = energy0 - energy
                diverging = -delta > divergence_threshold
                log_w = delta
                accept = jnp.minimum(1.0, jnp.exp(delta))

                # progressive multinomial proposal within the subtree
                new_total = jnp.logaddexp(c.log_weight, log_w)
                p_take = jnp.exp(log_w - new_total)
                take = jax.random.uniform(k_mult) < p_take
                z_prop = jnp.where(take, z, c.z_prop)
                logp_prop = jnp.where(take, v, c.logp_prop)
                g_prop = jnp.where(take, g, c.g_prop)
                energy_prop = jnp.where(take, energy, c.energy_prop)

                r_sum = c.r_sum + r
                i = c.leaf_idx

                # trailing-bits checkpointing: even leaves store, odd check
                idx_max = _bit_count(i >> 1)
                num_trailing = _trailing_ones(i)
                idx_min = idx_max - num_trailing + 1

                is_even = (i % 2) == 0
                r_ck = jnp.where(
                    is_even, c.r_ckpts.at[idx_max].set(r), c.r_ckpts
                )
                rs_ck = jnp.where(
                    is_even, c.rsum_ckpts.at[idx_max].set(r_sum), c.rsum_ckpts
                )

                def check_turning(_):
                    def tcond(s):
                        j, turning = s
                        return jnp.logical_and(j >= idx_min,
                                               jnp.logical_not(turning))

                    def tbody(s):
                        j, _ = s
                        rho = r_sum - rs_ck[j] + r_ck[j]
                        t = is_turning(r_ck[j], r, rho)
                        return j - 1, t

                    _, t = jax.lax.while_loop(tcond, tbody,
                                              (idx_max, jnp.bool_(False)))
                    return t

                turning = jax.lax.cond(
                    jnp.logical_and(jnp.logical_not(is_even),
                                    jnp.logical_not(diverging)),
                    check_turning, lambda _: jnp.bool_(False), None,
                )

                return Carry(
                    leaf_idx=i + 1, z=z, r=r, g=g,
                    z_prop=z_prop, logp_prop=logp_prop, g_prop=g_prop,
                    energy_prop=energy_prop,
                    r_sum=r_sum, log_weight=new_total,
                    sum_accept=c.sum_accept + accept,
                    r_ckpts=r_ck, rsum_ckpts=rs_ck,
                    diverging=diverging, turning=turning,
                    key=k_next,
                )

            c = jax.lax.while_loop(cond_fn, body_fn, carry0)

            # assemble the subtree as a _Tree (edges depend on direction)
            subtree = jax.lax.cond(
                direction > 0,
                lambda: _Tree(
                    z_left=z_e, r_left=r_e, g_left=g_e,   # placeholder edges
                    z_right=c.z, r_right=c.r, g_right=c.g,
                    z_prop=c.z_prop, logp_prop=c.logp_prop, g_prop=c.g_prop,
                    energy_prop=c.energy_prop,
                    r_sum=c.r_sum, log_weight=c.log_weight,
                    sum_accept=c.sum_accept, num_leaves=c.leaf_idx,
                    diverging=c.diverging, turning=c.turning,
                ),
                lambda: _Tree(
                    z_left=c.z, r_left=c.r, g_left=c.g,
                    z_right=z_e, r_right=r_e, g_right=g_e,
                    z_prop=c.z_prop, logp_prop=c.logp_prop, g_prop=c.g_prop,
                    energy_prop=c.energy_prop,
                    r_sum=c.r_sum, log_weight=c.log_weight,
                    sum_accept=c.sum_accept, num_leaves=c.leaf_idx,
                    diverging=c.diverging, turning=c.turning,
                ),
            )
            # note: the "inner" edge of the subtree is the first NEW leaf, but
            # for the momentum-sum criterion we only ever need the subtree's
            # outer edge and its r_sum; the first-leaf momentum is r after one
            # step — we conservatively use the trajectory edge we started from
            # only for seeding, never in U-turn checks across the full tree
            # (those use the FULL tree's r_left/r_right below).
            return subtree

        # --- top-level doubling loop ---------------------------------------
        class Outer(NamedTuple):
            tree: _Tree
            depth: jnp.ndarray
            key: jnp.ndarray
            total_leaves: jnp.ndarray

        def outer_cond(o: Outer):
            t = o.tree
            ok = jnp.logical_not(jnp.logical_or(t.diverging, t.turning))
            return jnp.logical_and(o.depth < max_tree_depth, ok)

        def outer_body(o: Outer):
            key_dir, key_sub, key_bias, key_next = jax.random.split(o.key, 4)
            direction = jnp.where(
                jax.random.bernoulli(key_dir), jnp.float32(1.0),
                jnp.float32(-1.0)
            )
            sub = build_subtree(key_sub, o.tree, o.depth, direction)

            tree = o.tree
            # merge edges
            z_left = jnp.where(direction > 0, tree.z_left, sub.z_left)
            r_left = jnp.where(direction > 0, tree.r_left, sub.r_left)
            g_left = jnp.where(direction > 0, tree.g_left, sub.g_left)
            z_right = jnp.where(direction > 0, sub.z_right, tree.z_right)
            r_right = jnp.where(direction > 0, sub.r_right, tree.r_right)
            g_right = jnp.where(direction > 0, sub.g_right, tree.g_right)

            sub_invalid = jnp.logical_or(sub.diverging, sub.turning)

            # biased progressive sampling across subtrees (Stan): take the new
            # subtree's proposal with prob min(1, exp(w_new - w_old))
            p_take = jnp.exp(jnp.minimum(sub.log_weight - tree.log_weight, 0.0))
            take = jnp.logical_and(
                jax.random.uniform(key_bias) < p_take,
                jnp.logical_not(sub_invalid),
            )
            z_prop = jnp.where(take, sub.z_prop, tree.z_prop)
            logp_prop = jnp.where(take, sub.logp_prop, tree.logp_prop)
            g_prop = jnp.where(take, sub.g_prop, tree.g_prop)
            energy_prop = jnp.where(take, sub.energy_prop, tree.energy_prop)

            r_sum = tree.r_sum + sub.r_sum
            full_turning = is_turning(r_left, r_right, r_sum)
            turning = jnp.logical_or(sub.turning, full_turning)

            new_tree = _Tree(
                z_left=z_left, r_left=r_left, g_left=g_left,
                z_right=z_right, r_right=r_right, g_right=g_right,
                z_prop=z_prop, logp_prop=logp_prop, g_prop=g_prop,
                energy_prop=energy_prop,
                r_sum=r_sum,
                log_weight=jnp.logaddexp(tree.log_weight, sub.log_weight),
                sum_accept=tree.sum_accept + sub.sum_accept,
                num_leaves=tree.num_leaves + sub.num_leaves,
                diverging=sub.diverging,
                turning=turning,
            )
            return Outer(new_tree, o.depth + 1, key_next,
                         o.total_leaves + sub.num_leaves)

        out = jax.lax.while_loop(
            outer_cond,
            outer_body,
            Outer(init_tree, jnp.int32(0), key_tree, jnp.int32(0)),
        )
        tree = out.tree

        accepted = jnp.any(tree.z_prop != z0_flat)
        new_state = to_state(tree.z_prop, tree.logp_prop, tree.g_prop)
        info = NUTSInfo(
            acceptance_prob=tree.sum_accept
            / jnp.maximum(tree.num_leaves.astype(jnp.float32), 1.0),
            is_accepted=accepted,
            energy=tree.energy_prop,
            is_divergent=tree.diverging,
            num_integration_steps=out.total_leaves,
            depth=out.depth,
        )
        return new_state, info

    return step


def _bit_count(n):
    """Number of set bits in a (non-negative, < 2^15) int32 scalar."""

    def body(s):
        x, c = s
        return x >> 1, c + (x & 1)

    _, c = jax.lax.while_loop(lambda s: s[0] > 0, body, (n, jnp.int32(0)))
    return c


def _trailing_ones(n):
    """Number of contiguous trailing 1-bits."""

    def body(s):
        x, c = s
        return x >> 1, c + 1

    _, c = jax.lax.while_loop(
        lambda s: (s[0] & 1) != 0, body, (n, jnp.int32(0))
    )
    return c
