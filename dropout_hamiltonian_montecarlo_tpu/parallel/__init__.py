"""Parallelism layer: device meshes, sharded chains, data-parallel gradients.

The replacement for the reference's L3 (multiprocessing.Pool chains +
producer/consumer Queue minibatch streaming, SURVEY.md §2 parallelism table):
chains shard over a 'chains' mesh axis, minibatch gradients psum over a 'data'
axis, posterior collection is an all_gather — all XLA collectives between devices,
no pickling, no queues.
"""

from .mesh import (make_mesh, make_multihost_mesh, init_distributed,
                   chain_sharding)
from .chains import sample_batched_sharded, sample_posterior_sharded
from .data import (shard_data, make_sharded_logdensity,
                   make_sharded_value_and_grad)
from .sgmcmc import run_sgmcmc_data_parallel

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "init_distributed",
    "chain_sharding",
    "sample_posterior_sharded",
    "sample_batched_sharded",
    "shard_data",
    "make_sharded_logdensity",
    "make_sharded_value_and_grad",
    "run_sgmcmc_data_parallel",
]
