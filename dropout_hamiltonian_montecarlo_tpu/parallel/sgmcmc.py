"""Data-parallel SG-MCMC: chains x data mesh, psum'd minibatch gradients.

The reference's ONE true distributed sampler streams minibatches from a
producer Process through a Queue to pool workers
(/root/reference/hamiltonian/inference/cpu/sgld_multicore.py:73-97,
cpu/sghmc_multicore.py:71-99).  The JAX composition (BASELINE config
4: "SGHMC/SGLD minibatch gradients with psum across data shards"):

- the dataset's example axis is laid across the 'data' mesh axis once
  (parallel/data.shard_data);
- chains are blocked across the 'chains' mesh axis, each chain's per-step
  key replicated along 'data';
- every shard gathers batch_size / n_data_shards local rows per step (same
  indices on every shard of a chain — the stratified uniform minibatch
  estimator), computes the local value/grad, and the kernel's
  value_and_grad hook psums both over 'data'
  (parallel/data.make_sharded_value_and_grad);
- the sampling loop itself is the UNCHANGED single-device scan driver
  (inference/sgmcmc.run_sgmcmc) running on the local shard — sharding is
  carried entirely by the shard_map around it and the collective inside
  the kernel.

With n_data_shards=1 this is bit-identical to the unsharded
run_sgmcmc_chains (asserted in tests/test_parallel.py); across data shards
the stratified batches differ from single-device batches by design, so
cross-data-shard parity is asserted on a constant-row dataset where every
batch realization is identical (tests/test_parallel.py) plus the
gradient-level psum identity tests.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.sgmcmc import run_sgmcmc

Params = Any
Batch = Tuple[jnp.ndarray, ...]


def run_sgmcmc_data_parallel(
    kernel: Callable,        # built with value_and_grad_fn=make_sharded_value_and_grad(...)
    initial_states,          # pytree with leading chain axis C
    key: jax.Array,
    data: Batch,             # full dataset (global arrays; sharded or not)
    mesh: Mesh,
    num_chains: int,
    batch_size: int,         # GLOBAL batch size (split across data shards)
    num_steps: int,
    step_size_schedule: Callable,
    collect_every: int = 1,
    burnin_steps: int = 0,
    chains_axis: str = "chains",
    data_axis: str = "data",
):
    """Run SG-MCMC chains under a (chains, data) mesh.

    ``kernel`` must carry the psum-over-``data_axis`` value_and_grad (see
    module docstring); a kernel built with a plain logdensity would compute
    shard-local gradients silently.  Returns (final_states, positions,
    infos) with positions leaves (num_chains, num_collected, ...) laid out
    across the chains axis.
    """
    n_data_shards = mesh.shape[data_axis]
    n_chain_shards = mesh.shape[chains_axis]
    if num_chains % n_chain_shards != 0:
        raise ValueError(
            f"num_chains {num_chains} % {n_chain_shards} chain shards != 0")
    if batch_size % n_data_shards != 0:
        raise ValueError(
            f"batch_size {batch_size} % {n_data_shards} data shards != 0")
    local_bs = batch_size // n_data_shards
    keys = jax.random.split(key, num_chains)

    def block_fn(states_blk, keys_blk, local_data):
        # per-chain driver on the LOCAL data shard; the chain's step keys
        # are replicated along 'data' so every shard draws the same local
        # indices and noise — positions stay replicated across 'data'
        def one_chain(state, k):
            return run_sgmcmc(
                kernel, state, k, local_data, batch_size=local_bs,
                num_steps=num_steps,
                step_size_schedule=step_size_schedule,
                collect_every=collect_every, burnin_steps=burnin_steps)

        return jax.vmap(one_chain)(states_blk, keys_blk)

    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P(chains_axis), P(chains_axis), P(data_axis)),
        out_specs=(P(chains_axis), P(chains_axis), P(chains_axis)),
        check_vma=False,
    )
    return sharded(initial_states, keys, data)
