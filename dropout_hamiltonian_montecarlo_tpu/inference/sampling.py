"""High-level sampling driver: warmup + sampling, vmapped over chains.

The replacement for the reference's multiprocessing chain parallelism
(/root/reference/hamiltonian/inference/cpu/hmc_multicore.py:22-38 — Pool.map
over pickled sampler copies): chains become a vmapped batch axis inside one
compiled program, with per-chain PRNG keys from jax.random.split and per-chain
adapted step sizes / mass matrices.  Sharding the chain axis across devices is
layered on top in dropout_hamiltonian_montecarlo_tpu/parallel/.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .base import run_inference
from .warmup import run_warmup

Params = Any


class Posterior(NamedTuple):
    """Stacked draws + diagnostics info.

    positions: pytree with leading axes (num_chains, num_samples, ...)
    (the reference's posterior dict-of-arrays, generalized to chains).
    """

    positions: Params
    infos: Any
    step_size: jnp.ndarray
    inv_mass: Params
    final_state: Any


def sample_posterior(
    init_fn: Callable,          # (position) -> state
    kernel: Callable,           # (key, state, step_size, inv_mass) -> (state, info)
    initial_positions: Params,  # pytree with leading chain axis
    key: jax.Array,
    num_samples: int,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    thin: int = 1,
    adapt_mass: bool = True,
) -> Posterior:
    """Run (warmup -> sampling) for each chain under vmap; one XLA program.

    adapt_mass=False: warmup adapts the step size only — the right choice
    when the kernel carries its own metric (e.g. whitened NUTS/HMC under the
    Kronecker Gauss-Newton metric), where the diagonal inv_mass argument is
    ignored anyway."""

    def one_chain(chain_key, position):
        warm_key, sample_key = jax.random.split(chain_key)
        state = init_fn(position)
        if num_warmup > 0:
            warm = run_warmup(
                kernel, state, warm_key, num_warmup,
                initial_step_size=initial_step_size,
                target_acceptance=target_acceptance,
                adapt_mass=adapt_mass,
            )
            state, step_size, inv_mass = warm.state, warm.step_size, warm.inv_mass
        else:
            from ..ops.tree import tree_ones_like
            step_size = jnp.float32(initial_step_size)
            inv_mass = tree_ones_like(position)

        def fixed_kernel(k, s):
            return kernel(k, s, step_size, inv_mass)

        final_state, (states, infos) = run_inference(
            fixed_kernel, state, sample_key, num_samples, thin=thin
        )
        return Posterior(states.position, infos, step_size, inv_mass, final_state)

    # initial_positions must carry a leading chain axis (use stack_chains to
    # build one); a single chain is just num_chains == 1.
    keys = jax.random.split(key, num_chains)
    return jax.vmap(one_chain)(keys, initial_positions)


def stack_chains(position: Params, num_chains: int) -> Params:
    """Tile one position pytree into a leading chain axis."""
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (num_chains,) + x.shape), position
    )


def init_chain_positions(init_params_fn: Callable, key: jax.Array,
                         num_chains: int, jitter: float = 0.0) -> Params:
    """Draw per-chain initial positions (optionally jittered) from a model's
    init_params — the reference seeds every worker chain at the same start_p
    (cpu/hmc_multicore.py:27); overdispersed starts make R-hat meaningful."""
    keys = jax.random.split(key, num_chains)
    positions = jax.vmap(init_params_fn)(keys)
    if jitter > 0.0:
        jkeys = jax.random.split(jax.random.fold_in(key, 1), num_chains)

        def add_noise(k, p):
            from ..ops.tree import tree_randn_like, tree_axpy
            return tree_axpy(jitter, tree_randn_like(k, p), p)

        positions = jax.vmap(add_noise)(jkeys, positions)
    return positions


def sample_posterior_streaming(
    init_fn: Callable,
    kernel: Callable,
    initial_positions: Params,
    key: jax.Array,
    backend,                    # io.HDF5Backend (or anything with .append)
    num_samples: int,
    chunk_size: int = 100,
    num_warmup: int = 500,
    num_chains: int = 1,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    adapt_mass: bool = True,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
):
    """Warmup once, then sample in CHUNKS, spooling each chunk's draws to the
    backend while sampling continues — the reference streams every draw to
    per-worker HDF5 files (cpu/sgld_multicore.py:38-57); here one
    device->host transfer per chunk keeps draws bounded in HBM so long runs
    never materialize the full (chains, draws, params) block on device.

    Backend datasets get shape (total_draws, num_chains, ...): draws leading
    so appends are resizes on axis 0; read back and transpose for per-chain
    diagnostics.  Returns (final_states, step_size, inv_mass, num_appended).

    checkpoint_path: after every chunk, atomically save the full resumable
    state (chain states, adapted step sizes / inverse mass, the sampling PRNG
    key, draws-done counter) — io/checkpoint.py.  With resume=True and an
    existing checkpoint, warmup is SKIPPED, the saved key replaces the
    caller's, and sampling continues at the next chunk; chunk keys are
    fold_in(sample_key, chunk_index), so an interrupted+resumed run appends
    exactly the draws the uninterrupted run would have (tested in
    tests/test_io.py).  The reference had no resume path at all — 'nothing
    ever reads the files back' (SURVEY.md §5).  The chunk append and the
    checkpoint write are two operations; a crash BETWEEN them leaves the
    backend one chunk ahead of the checkpoint's draw counter — on resume the
    backend is TRUNCATED back to the counter (backends expose
    truncate/num_draws; io/backend.py), so the resumed file always equals
    the uninterrupted run's (tested in tests/test_io.py).
    """
    warm_key, sample_key = jax.random.split(key)
    appended = 0

    resumed = False
    if resume and checkpoint_path is not None:
        import os

        if os.path.exists(checkpoint_path):
            from ..io.checkpoint import load_checkpoint

            template_states = jax.vmap(init_fn)(initial_positions)
            extras_like = {
                "step_size": jnp.zeros((num_chains,), jnp.float32),
                "inv_mass": jax.tree_util.tree_map(
                    jnp.zeros_like, initial_positions),
            }
            states, sample_key, appended, extras = load_checkpoint(
                checkpoint_path, template_states, extras_like=extras_like)
            step_sizes = extras["step_size"]
            inv_mass = extras["inv_mass"]
            resumed = True
            if appended < num_samples and appended % chunk_size != 0:
                raise ValueError(
                    f"resume draw counter {appended} is not a multiple of "
                    f"chunk_size {chunk_size}: chunk keys are per-chunk-"
                    f"index, so a different chunk size changes the draw "
                    f"sequence — use the original chunk size")
            # crash-between-append-and-checkpoint recovery: drop any draws
            # past the checkpoint's counter so the resumed chunk sequence
            # (fold_in(sample_key, i)) lines up with the file contents
            if hasattr(backend, "truncate"):
                backend.truncate(appended)

    if not resumed:
        @jax.jit
        def warm_all(keys, positions):
            def one(k, p):
                st = init_fn(p)
                w = run_warmup(kernel, st, k, num_warmup,
                               initial_step_size=initial_step_size,
                               target_acceptance=target_acceptance,
                               adapt_mass=adapt_mass)
                return w.state, w.step_size, w.inv_mass

            return jax.vmap(one)(keys, positions)

        keys = jax.random.split(warm_key, num_chains)
        states, step_sizes, inv_mass = warm_all(keys, initial_positions)

    @jax.jit
    def run_chunk(states, k):
        def one(s, kk, ss, im):
            def fixed(k2, st):
                return kernel(k2, st, ss, im)

            fs, (sts, _) = run_inference(fixed, s, kk, chunk_size)
            return fs, sts.position

        ks = jax.random.split(k, num_chains)
        return jax.vmap(one)(states, ks, step_sizes, inv_mass)

    n_chunks = -(-num_samples // chunk_size)
    start = n_chunks if appended >= num_samples else appended // chunk_size
    for i in range(start, n_chunks):
        states, pos = run_chunk(states, jax.random.fold_in(sample_key, i))
        take = min(chunk_size, num_samples - appended)
        # (chains, chunk, ...) -> (chunk, chains, ...), draws leading
        block = jax.tree_util.tree_map(
            lambda x: jnp.swapaxes(x, 0, 1)[:take], pos)
        backend.append(block)            # one D2H transfer per chunk
        appended += take
        if checkpoint_path is not None:
            from ..io.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_path, states, key=sample_key, step=appended,
                extras={"step_size": step_sizes, "inv_mass": inv_mass})
    return states, step_sizes, inv_mass, appended


def sample_batched_streaming(
    kernel: Callable,        # chain-BATCHED: (keys (C,), state, (C,) eps, im)
    states,                  # chain-batched state (leaves (C, ...))
    step_sizes: jnp.ndarray,
    inv_mass: Params,
    key: jax.Array,
    backend,
    num_samples: int,
    chunk_size: int = 100,
    transform: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    mesh=None,
    mesh_axis: str = "chains",
):
    """Chunked streaming driver for the chain-BATCHED kernels
    (hmc.build_batched_kernel / nuts_batched.build_batched_kernel): one jit'd
    scan of ``chunk_size`` draws per device program, draws spooled to the
    backend per chunk, so device memory for draws is bounded by the chunk
    and a checkpoint can follow every chunk.

    ``transform``: optional map applied ON DEVICE to the chunk's stacked
    positions (leaves (C, chunk, ...)) before the device->host transfer —
    e.g. unwhitening Kronecker-metric draws back to parameter space.

    PRNG: per-(draw, chain) keys derived as split(fold_in(key, chunk), n)
    — the draw sequence therefore depends on the chunking, and a resumed
    run MUST use the same chunk_size as the original (enforced: resuming at
    a draw count that is not a chunk boundary raises).  The checkpoint also
    persists the (adapted) per-chain step sizes AND the inverse-mass pytree,
    so callers can skip warmup entirely on resume and pass placeholder
    step_sizes/inv_mass — the saved ones take precedence.  Checkpoint/resume semantics otherwise match
    sample_posterior_streaming (backend truncated to the checkpoint counter
    on resume).  Returns (final_states, num_appended_total,
    info_summaries) — info_summaries is a list (one entry per chunk run
    THIS session) of the kernel info pytree averaged over (chunk, chains):
    cheap scalar diagnostics (acceptance, tree depth, divergences) without
    spooling the full info arrays.

    ``mesh``: optional jax.sharding.Mesh — shard the chain axis over
    ``mesh_axis`` (shard_map per chunk; both batched kernels accept the
    per-chain key arrays this passes).  The per-(draw, chain) key
    construction is identical to the unsharded path, so the draw sequence
    does not depend on the blocking (parity tested in
    tests/test_parallel.py::test_batched_streaming_sharded_parity).
    """
    num_chains = step_sizes.shape[0]
    appended = 0

    if resume and checkpoint_path is not None:
        import os

        if os.path.exists(checkpoint_path):
            import numpy as _np

            from ..io.checkpoint import load_checkpoint

            # checkpoints from before inv_mass was persisted carry only
            # step_size extras — resume them with the caller's inv_mass
            # instead of KeyError'ing the run
            with _np.load(checkpoint_path) as _d:
                has_im = any(k.startswith("extra.inv_mass::")
                             for k in _d.files)
            extras_like = {"step_size": step_sizes}
            if has_im:
                extras_like["inv_mass"] = inv_mass
            states, key, appended, extras = load_checkpoint(
                checkpoint_path, states, extras_like=extras_like)
            step_sizes = extras["step_size"]
            inv_mass = extras.get("inv_mass", inv_mass)
            if appended < num_samples and appended % chunk_size != 0:
                raise ValueError(
                    f"resume draw counter {appended} is not a multiple of "
                    f"chunk_size {chunk_size}: resuming with a different "
                    f"chunk size would silently change/duplicate the draw "
                    f"sequence — use the original chunk size")
            if hasattr(backend, "truncate"):
                backend.truncate(appended)

    def chunk_scan(states_blk, draw_keys_blk, ss_blk, im_blk):
        """One chunk's scan over a chain BLOCK (the whole batch when
        unsharded, a device's block under shard_map).  transform is applied
        per block (it is per-chain: unwhitening etc.), draws axis leading on
        the returned positions."""

        def body(s, ks):
            ns, info = kernel(ks, s, ss_blk, im_blk)
            return ns, (ns.position, info)

        final, (pos, infos) = jax.lax.scan(body, states_blk, draw_keys_blk)
        pos = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), pos)
        if transform is not None:
            pos = transform(pos)
        return (final,
                jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), pos),
                infos)

    if mesh is None:
        @jax.jit
        def run_chunk(states, chunk_key):
            draw_keys = jax.vmap(
                lambda k: jax.random.split(k, num_chains)
            )(jax.random.split(chunk_key, chunk_size))  # (chunk, C) keys
            final, pos, infos = chunk_scan(states, draw_keys,
                                           step_sizes, inv_mass)
            info_mean = jax.tree_util.tree_map(
                lambda x: jnp.mean(jnp.asarray(x, jnp.float32)), infos)
            return final, pos, info_mean
    else:
        # chain axis sharded over mesh[mesh_axis]: each device scans its
        # chain block through the same kernel.  Per-(draw, chain) keys are
        # built OUTSIDE the shard_map and sharded along the chain axis, so
        # the draw sequence is numerically identical to the unsharded run
        # (the sample_batched_sharded PRNG contract; parity asserted in
        # tests/test_parallel.py) — a pod slice is a flag, not a rewrite.
        from jax.sharding import PartitionSpec as P

        if num_chains % mesh.shape[mesh_axis] != 0:
            raise ValueError(
                f"num_chains {num_chains} % mesh[{mesh_axis!r}]="
                f"{mesh.shape[mesh_axis]} != 0")

        sharded_scan = jax.shard_map(
            chunk_scan, mesh=mesh,
            in_specs=(P(mesh_axis), P(None, mesh_axis), P(mesh_axis),
                      P(mesh_axis)),
            out_specs=(P(mesh_axis), P(None, mesh_axis), P(None, mesh_axis)),
            check_vma=False,
        )

        @jax.jit
        def run_chunk(states, chunk_key):
            draw_keys = jax.vmap(
                lambda k: jax.random.split(k, num_chains)
            )(jax.random.split(chunk_key, chunk_size))
            final, pos, infos = sharded_scan(states, draw_keys,
                                             step_sizes, inv_mass)
            info_mean = jax.tree_util.tree_map(
                lambda x: jnp.mean(jnp.asarray(x, jnp.float32)), infos)
            return final, pos, info_mean

    info_summaries = []
    n_chunks = -(-num_samples // chunk_size)
    # a fully-completed run resumes as a no-op (no zero-take chunk that
    # would advance the checkpointed states past the last appended draw)
    start = n_chunks if appended >= num_samples else appended // chunk_size
    for i in range(start, n_chunks):
        states, block, info_mean = run_chunk(
            states, jax.random.fold_in(key, i))
        take = min(chunk_size, num_samples - appended)
        block = jax.tree_util.tree_map(lambda x: x[:take], block)
        backend.append(block)
        info_summaries.append(jax.tree_util.tree_map(float, info_mean))
        appended += take
        if checkpoint_path is not None:
            from ..io.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, states, key=key, step=appended,
                            extras={"step_size": step_sizes,
                                    "inv_mass": inv_mass})
    return states, appended, info_summaries
