"""Worker program for the REAL 2-process jax.distributed validation.

The reference's distributed execution actually spawns OS processes
(/root/reference/hamiltonian/inference/cpu/hmc_multicore.py:22-38,
cpu/sgld_multicore.py:85-104).  The JAX counterpart is a multi-host
process group: every process calls jax.distributed.initialize, jax.devices()
spans all hosts, and meshes built by parallel.mesh.make_multihost_mesh lay
collectives across the group.  This worker exercises that path for real —
Gloo collectives between two OS processes with 4 virtual CPU devices each —
driving:

  (a) the FLAGSHIP chain-batched HMC kernel sharded over the cross-process
      'chains' axis (parallel.chains.sample_batched_sharded);
  (b) a data-axis psum of the full-batch value+grad on a (chains, data)
      multi-host mesh (parallel.data.make_sharded_value_and_grad);
  (c) per-process HDF5 shard writing + global reassembly
      (io.ShardedHDF5Backend / assemble_shards — the reference's per-worker
      backend_%i.h5 pattern, cpu/sgld_multicore.py:86-89).

The single-process 8-device run of run_workload() is the parity reference
(tests/test_multiprocess.py): per-(draw, chain) keys make the sharded draw
sequence independent of how chains are blocked across processes.

Launch (one line per process):
  JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python scripts/multiprocess_worker.py --coordinator localhost:PORT \
      --num-processes 2 --process-id {0,1} --outdir DIR
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_workload(mesh_c, mesh_cd, workdir=None):
    """The shared validation workload; deterministic given the mesh SHAPES.

    Returns (gathered, global_positions):
      gathered — dict of host numpy arrays (identical on every process):
        positions/weights (C, T, d, k), positions/bias (C, T, k),
        acceptance (C, T), dp_value_maxdiff / dp_grad_maxdiff scalars;
      global_positions — the (possibly multi-process) global positions
        pytree, for the shard-I/O stage.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.parallel import (
        make_sharded_value_and_grad,
        sample_batched_sharded,
    )

    n, d, k, chains, draws = 128, 16, 3, 16, 20
    key = jax.random.key(0)
    kx, ky, kp = jax.random.split(key, 3)
    # host numpy constants: identical on every process, safe to close over
    # in a multi-process jit (replicated by the compiler)
    X = np.asarray(jax.random.normal(kx, (n, d), jnp.float32))
    y = np.asarray(
        (jax.random.randint(ky, (n,), 0, k)[:, None] == jnp.arange(k))
        .astype(jnp.float32))
    model = Softmax(dim=d, n_classes=k, alpha=1.0)
    logdensity = model.make_logdensity(batch=(X, y))
    vag = jax.vmap(jax.value_and_grad(logdensity))
    kernel = hmc.build_batched_kernel(vag, 4)

    positions = jax.tree_util.tree_map(
        np.asarray,
        jax.vmap(model.init_params)(jax.random.split(kp, chains)))
    inv_mass = jax.tree_util.tree_map(np.ones_like, positions)
    step_sizes = np.full((chains,), 1e-2, np.float32)

    # (a) flagship batched kernel over the cross-process chains axis
    @jax.jit
    def run(pos, ss, im):
        states = hmc.batched_init(pos, vag)
        return sample_batched_sharded(
            kernel, states, ss, im, jax.random.key(7), draws, mesh_c)

    _, pos_global, infos = run(positions, step_sizes, inv_mass)
    jax.block_until_ready(infos.acceptance_prob)

    gathered = {
        "positions/weights": multihost_utils.process_allgather(
            pos_global["weights"], tiled=True),
        "positions/bias": multihost_utils.process_allgather(
            pos_global["bias"], tiled=True),
        "acceptance": multihost_utils.process_allgather(
            infos.acceptance_prob, tiled=True),
    }

    # (b) data-axis psum on the (chains, data) multi-host mesh: full-batch
    # value+grad psum'd over 'data' == the single-program full-batch result
    vag_dp = make_sharded_value_and_grad(model, data_size=n)
    q_test = jax.tree_util.tree_map(lambda x: x[0], positions)

    @jax.jit
    def dp(q, Xb, yb):
        return jax.shard_map(
            vag_dp, mesh=mesh_cd,
            in_specs=(P(), P("data")), out_specs=(P(), P()),
            check_vma=False,
        )(q, (Xb, yb))

    v_dp, g_dp = dp(q_test, X, y)
    v_ref, g_ref = jax.jit(jax.value_and_grad(logdensity))(q_test)
    gathered["dp_value_maxdiff"] = np.abs(
        np.asarray(v_dp) - np.asarray(v_ref)).max()
    gathered["dp_grad_maxdiff"] = max(
        float(jnp.max(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(g_dp),
                        jax.tree_util.tree_leaves(g_ref)))

    # (d) the FULL multi-host config-3 composition: the chunked streaming
    # driver over the multi-host chains mesh, spooling each chunk to
    # per-process shard files, reassembled into global chain order — the
    # end-to-end path a multi-host `mnist-nuts --chain-shards --save`
    # would take (streaming keys are chunk-indexed, so this sequence is
    # deliberately distinct from stage (a)'s).
    if workdir is not None:
        from dropout_hamiltonian_montecarlo_tpu.inference.sampling import (
            sample_batched_streaming,
        )
        from dropout_hamiltonian_montecarlo_tpu.io import (
            ShardedHDF5Backend,
            assemble_shards,
            shard_paths,
        )

        base = os.path.join(workdir, "stream.h5")
        with ShardedHDF5Backend(base, mode="w", chain_axis=1) as b:
            sample_batched_streaming(
                kernel,
                hmc.batched_init(
                    jax.tree_util.tree_map(jnp.asarray, positions), vag),
                jnp.asarray(step_sizes),
                jax.tree_util.tree_map(jnp.asarray, inv_mass),
                jax.random.key(9), b, num_samples=12, chunk_size=5,
                mesh=mesh_c)
        multihost_utils.sync_global_devices("stream-io-written")
        streamed = assemble_shards(
            shard_paths(base, jax.process_count()), chain_axis=1)
        for name, arr in streamed.items():
            gathered[f"streamed/{name}"] = arr

    return gathered, pos_global


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    args = ap.parse_args()

    sys.path.insert(0, _REPO)
    import jax

    from dropout_hamiltonian_montecarlo_tpu.utils.runtime import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from dropout_hamiltonian_montecarlo_tpu.parallel.mesh import (
        init_distributed,
        make_multihost_mesh,
    )

    pid = init_distributed(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id)
    assert jax.process_count() == args.num_processes, (
        f"process group did not form: count={jax.process_count()}")
    assert pid == args.process_id

    import numpy as np
    from jax.experimental import multihost_utils

    ndev = len(jax.devices())
    mesh_c = make_multihost_mesh(num_chain_shards=ndev)
    mesh_cd = make_multihost_mesh(num_chain_shards=ndev // 2,
                                  num_data_shards=2)
    # each host's chips must be contiguous along 'chains' (the
    # make_multihost_mesh contract: chain parallelism needs no cross-host
    # traffic)
    procs_in_order = [d.process_index for d in mesh_c.devices.ravel()]
    assert procs_in_order == sorted(procs_in_order), procs_in_order

    gathered, pos_global = run_workload(mesh_c, mesh_cd,
                                        workdir=args.outdir)

    # (c) per-process shard writing + reassembly (positions: chain axis 0)
    from dropout_hamiltonian_montecarlo_tpu.io import (
        ShardedHDF5Backend,
        assemble_shards,
        shard_paths,
    )

    base = os.path.join(args.outdir, "draws.h5")
    with ShardedHDF5Backend(base, mode="w", chain_axis=0) as b:
        b.append(pos_global)
        my_path = b.path
    multihost_utils.sync_global_devices("shard-io-written")

    if pid == 0:
        stored = assemble_shards(
            shard_paths(base, args.num_processes), chain_axis=0)
        io_maxdiff = max(
            float(np.abs(stored[name] - gathered[f"positions/{name}"]).max())
            for name in ("weights", "bias"))
        out = dict(gathered)
        out["io_maxdiff"] = io_maxdiff
        np.savez(os.path.join(args.outdir, "result_p0.npz"), **out)

    print(json.dumps({
        "process_id": pid,
        "num_processes": int(jax.process_count()),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "shard_file": my_path,
        "ok": True,
    }))


if __name__ == "__main__":
    main()
