"""Sharded multi-chain sampling: vmap inside, shard_map over the chain axis.

The reference's chain parallelism is Pool.map over pickled sampler copies with
per-worker seeds and host-side posterior concatenation
(/root/reference/hamiltonian/inference/cpu/hmc_multicore.py:22-38).  Here the
vmapped chain batch is sharded across the 'chains' mesh axis with shard_map:
each device runs its chain block inside one XLA program; the stacked posterior
comes back as a global array laid out across devices (collection = the output
sharding, no explicit gather needed; cross-chain diagnostics reduce with
jnp ops over the global array).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..inference.sampling import Posterior, sample_posterior

Params = Any


def sample_posterior_sharded(
    init_fn: Callable,
    kernel: Callable,
    initial_positions: Params,   # leading chain axis, divisible by mesh chains
    key: jax.Array,
    mesh: Mesh,
    num_samples: int,
    num_warmup: int = 500,
    num_chains: int = 1,
    **kwargs,
) -> Posterior:
    """Like sampling.sample_posterior but with the chain axis sharded over
    mesh axis 'chains'.  Per-shard PRNG keys derive from the shard index, so
    results are reproducible for a fixed (key, mesh shape)."""
    n_shards = mesh.shape["chains"]
    if num_chains % n_shards != 0:
        raise ValueError(f"num_chains {num_chains} % shards {n_shards} != 0")
    chains_per_shard = num_chains // n_shards

    def shard_fn(positions_block):
        # distinct key per shard: fold in the shard's position on the mesh
        idx = jax.lax.axis_index("chains")
        shard_key = jax.random.fold_in(key, idx)
        return sample_posterior(
            init_fn, kernel, positions_block, shard_key,
            num_samples=num_samples, num_warmup=num_warmup,
            num_chains=chains_per_shard, **kwargs,
        )

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("chains"),
        out_specs=P("chains"),
        check_vma=False,
    )
    return sharded(initial_positions)


def sample_batched_sharded(
    batched_kernel: Callable,   # hmc.build_batched_kernel step
    states,                     # HMCState with leading chain axis C
    step_sizes: jnp.ndarray,    # (C,)
    inv_mass: Params,           # chain-batched pytree
    key: jax.Array,
    num_samples: int,
    mesh: Mesh,
    axis: str = "chains",
    data: Params = None,
    data_axis: str = "data",
    kernel_factory: Callable = None,
    post_step: Callable = None,
):
    """Shard the FLAGSHIP chain-batched path (hmc.build_batched_kernel — the
    one-batched-value+grad-per-leapfrog-step kernel the headline bench runs)
    over a device mesh: each device advances its chain BLOCK through the
    same kernel; the dataset is a replicated closure constant, so the only
    cross-device traffic is the output layout.

    PRNG: per-(draw, chain) keys are built OUTSIDE the shard_map and sharded
    along the chain axis, and the batched kernel consumes per-chain keys — so
    the sharded run is numerically identical to the unsharded one (asserted
    in dryrun_multichip), unlike per-shard fold_in schemes whose results
    depend on the mesh shape.

    DATA PARALLELISM (``data`` + ``kernel_factory``): when the dataset is
    too large to replicate per chip, pass the global batch tuple as ``data``
    (its example axis is laid over ``data_axis``) and a
    ``kernel_factory(local_batch) -> batched_kernel`` that builds the kernel
    on each shard's LOCAL rows with a psum'd value_and_grad — e.g.
    ``jax.vmap``-over-chains of parallel.data.make_sharded_value_and_grad
    evaluated at the full local shard (full batch => likelihood scale 1, so
    psum over ``data_axis`` reconstructs the exact full-batch posterior).
    Per-(draw, chain) keys replicate along the data axis, so every data
    shard of a chain row takes identical momentum/accept draws and chain
    states stay replicated across ``data_axis`` by construction — the
    composition is numerically identical to the replicated-dataset run up
    to psum reduction order (asserted in tests/test_parallel.py and
    dryrun_multichip stage (f)).

    ``post_step(chain_keys, state) -> state``: optional per-draw state map
    applied after the kernel (e.g. the whitened gauge Gibbs resampler,
    ops/kron_metric.make_whitened_gauge_gibbs) — it receives the draw's
    (c_block,) per-chain keys and MUST derive any randomness from them
    per-chain (fold_in), or the result would depend on the blocking.

    Returns (final_states, positions, infos) with positions leaves shaped
    (C, num_samples, ...) laid out across the mesh on the chain axis.
    """
    n_chains = step_sizes.shape[0]
    # (num_samples, C) per-draw-per-chain keys
    draw_keys = jax.vmap(
        lambda k: jax.random.split(k, n_chains)
    )(jax.random.split(key, num_samples))

    def run_block(draw_keys_blk, states_blk, ss_blk, im_blk, *data_blk):
        kernel = (kernel_factory(data_blk[0]) if kernel_factory is not None
                  else batched_kernel)

        def body(s, ks):
            ns, info = kernel(ks, s, ss_blk, im_blk)
            if post_step is not None:
                ns = post_step(ks, ns)
            return ns, (ns.position, info)

        final, (pos, infos) = jax.lax.scan(body, states_blk, draw_keys_blk)
        # (T, c, ...) -> (c, T, ...): chains leading, matching Posterior
        swap = lambda x: jnp.swapaxes(x, 0, 1)
        return (final, jax.tree_util.tree_map(swap, pos),
                jax.tree_util.tree_map(swap, infos))

    in_specs = [P(None, axis), P(axis), P(axis), P(axis)]
    extra = ()
    if data is not None:
        if kernel_factory is None:
            raise ValueError("data sharding needs a kernel_factory that "
                             "builds the psum'd kernel on the local shard")
        in_specs.append(P(data_axis))
        extra = (data,)

    sharded = jax.shard_map(
        run_block,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return sharded(draw_keys, states, step_sizes, inv_mass, *extra)
