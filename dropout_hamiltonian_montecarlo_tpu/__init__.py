"""dropout_hamiltonian_montecarlo_tpu — Bayesian MCMC framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
sherna90/dropout_hamiltonian_montecarlo (reference at /root/reference): a
Bayesian model zoo with hand-checkable log-densities, HMC/NUTS/Metropolis and
stochastic-gradient MCMC sampler kernels expressed as lax.scan programs,
vmapped and chain-batched multi-chain execution, and mesh-sharded
chains/data via shard_map.
"""

__version__ = "0.1.0"

from . import diagnostics, inference, io, models, ops, utils

__all__ = [
    "models",
    "inference",
    "ops",
    "utils",
    "diagnostics",
    "io",
    "__version__",
]
