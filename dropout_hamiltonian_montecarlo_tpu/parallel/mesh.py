"""Device mesh construction for chains x data sharding.

Replaces the reference's process-pool topology (ncores workers,
/root/reference/hamiltonian/inference/cpu/hmc_multicore.py:22-38) with a
jax.sharding.Mesh over ('chains', 'data') axes.  Multi-host: call
jax.distributed.initialize() before building the mesh.  The mesh is flat:
the cards of one host reach each other all to all, so the layout follows
the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    num_chain_shards: Optional[int] = None,
    num_data_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh(('chains', 'data')) over the available devices.

    Default: all devices on the chains axis (chains are embarrassingly
    parallel — the reference's only parallelism) with data axis 1.  Set
    num_data_shards > 1 to split minibatch gradients (psum) as well.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if num_chain_shards is None:
        num_chain_shards = n // num_data_shards
    if num_chain_shards * num_data_shards != n:
        raise ValueError(
            f"mesh {num_chain_shards}x{num_data_shards} != {n} devices"
        )
    arr = np.array(devices).reshape(num_chain_shards, num_data_shards)
    return Mesh(arr, ("chains", "data"))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join a multi-host process group (jax.distributed.initialize).

    The replacement for the reference's fork-based worker pool
    (/root/reference/hamiltonian/inference/cpu/sgld_multicore.py:91-97):
    afterwards jax.devices() spans every host's devices and meshes built
    by make_mesh/make_multihost_mesh lay collectives across the group.  On
    single-host (or when already initialized) this is a no-op.  Returns
    this process's index.

    Pass all three arguments explicitly where no cluster environment
    describes the group (a single GPU host, tests): jax.distributed
    auto-detects them only under a cluster manager such as SLURM.

    NOTE: must run before anything touches the backend (jax.devices(),
    jax.process_count(), any computation) — initialize() raises after
    backend init.  Already-initialized detection therefore uses
    jax.distributed.is_initialized(), which does NOT touch the backend
    (calling jax.process_count() here would itself initialize a
    single-process backend and doom the initialize() call — the bug the
    2-process test caught, tests/test_multiprocess.py).
    """
    if jax.distributed.is_initialized():
        return jax.process_index()
    if num_processes is not None and num_processes <= 1:
        return 0
    if coordinator_address is None and num_processes is None:
        # auto-detection environment (e.g. SLURM); fall back to
        # single-process when there is nothing to detect
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError):
            return 0
        return jax.process_index()
    # explicit coordinator: failures here are real — do not mask them as a
    # silent single-process fallback
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


def make_multihost_mesh(
    num_chain_shards: Optional[int] = None,
    num_data_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over EVERY process's devices, hosts laid along the 'chains' axis.

    Device order: jax.devices() already interleaves all processes'
    devices; we sort by (process_index, device id) so each host's devices
    are contiguous along the chains axis — chain parallelism then needs no
    cross-host communication at all (the reference's multicore chains are
    embarrassingly parallel, cpu/hmc_multicore.py:22-38), while the 'data'
    axis psum stays within a host whenever num_data_shards <= devices per
    host.
    """
    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, d.id))
    return make_mesh(num_chain_shards, num_data_shards, devices)


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that lays a leading chain axis across the 'chains' mesh axis."""
    return NamedSharding(mesh, P("chains"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
