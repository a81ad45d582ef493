"""Data-parallel gradients: shard the batch, psum the gradient.

The replacement for the reference's producer/consumer Queue minibatch
pipeline (/root/reference/hamiltonian/inference/cpu/sgld_multicore.py:73-97):
the dataset is laid out across the 'data' mesh axis once (one device_put), and
every minibatch gradient is a local gather + matmul followed by a psum across
devices — no host round-trips, no pickling.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Params = Any
Batch = Tuple[jnp.ndarray, ...]


def shard_data(data: Batch, mesh: Mesh, axis: str = "data") -> Batch:
    """Lay the leading (example) axis of every array across the mesh axis."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(d, sharding) for d in data)


def _local_contribution(model, data_size: int, axis: str, keyed: bool = False):
    """Per-shard log-density contribution: prior divided by the axis size so
    the psum over shards counts it exactly once; likelihood scaled by the
    GLOBAL batch size (local * n_shards) for an unbiased minibatch estimate.

    keyed=True: the model's log_likelihood takes a PRNG key (the dropout-MLP
    potential, models/mlp.py).  The key reaches every data shard replicated
    (it derives from the chain's step key, which is sharded over 'chains'
    only), so all shards of one chain apply IDENTICAL dropout masks — the
    mask is a parameter-space perturbation and must not vary across the
    data partition."""

    def contribution(params, local_batch, key=None):
        n_shards = jax.lax.axis_size(axis)
        local_bs = local_batch[0].shape[0]
        global_bs = local_bs * n_shards
        if keyed:
            ll = model.log_likelihood(params, local_batch, key)
        else:
            ll = model.log_likelihood(params, local_batch)
        ll = (data_size / global_bs) * ll
        return model.log_prior(params) / n_shards + ll

    return contribution


def make_sharded_logdensity(model, data_size: int, axis: str = "data"):
    """Minibatch log density safe for data-parallel shard_map over ``axis``.

    Differentiable only under check_vma=True (shard_map's default), where
    JAX knows the psum output is replicated and transposes it correctly.
    For gradients inside check_vma=False regions use
    make_sharded_value_and_grad, which psums the gradient explicitly."""

    contribution = _local_contribution(model, data_size, axis)

    def logdensity(params, local_batch):
        return jax.lax.psum(contribution(params, local_batch), axis)

    return logdensity


def make_sharded_value_and_grad(model, data_size: int, axis: str = "data",
                                keyed: bool = False):
    """Data-parallel (value, grad) of the minibatch log density: local
    value_and_grad followed by an explicit psum of BOTH outputs.

    This is psum-of-grad, correct by construction under any check_vma
    setting — unlike grad-of-psum, whose transpose under check_vma=False
    double-counts (the round-1 data-parallel gradient bug).  Replaces
    the reference's per-worker minibatch gradient
    (/root/reference/hamiltonian/inference/cpu/sgld_multicore.py:73-97).

    The returned callable accepts (params, local_batch[, key]) — the
    (params, batch, key|None) shape the SG-MCMC kernels' value_and_grad_fn
    hook expects (inference/sgmcmc._make_vag), so
    ``build_sghmc_kernel(value_and_grad_fn=make_sharded_value_and_grad(...),
    keyed=...)`` is the full data-parallel sampler composition."""

    contribution = _local_contribution(model, data_size, axis, keyed=keyed)

    def value_and_grad(params, local_batch, key=None):
        v, g = jax.value_and_grad(contribution)(params, local_batch, key)
        return jax.lax.psum(v, axis), jax.lax.psum(g, axis)

    return value_and_grad
