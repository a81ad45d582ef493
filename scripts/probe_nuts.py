"""Micro-probe: steady-state per-leaf cost of the chain-batched NUTS kernel
on the MNIST softmax posterior (compile excluded).  Usage:
    python scripts/probe_nuts.py [draws=50] [target_accept=0.65] [max_depth=6]
Prints one JSON line with per-draw / per-leaf timings."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dropout_hamiltonian_montecarlo_tpu.utils.runtime import configure  # noqa: E402

configure()


def main():
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    target = float(sys.argv[2]) if len(sys.argv) > 2 else 0.65
    max_depth = int(sys.argv[3]) if len(sys.argv) > 3 else 6

    from dropout_hamiltonian_montecarlo_tpu.inference import nuts_batched
    from dropout_hamiltonian_montecarlo_tpu.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        cached_gn_setup,
        make_whitened_fused_vag,
    )

    chains, d, k = 128, 784, 10
    X, yi = datasets.mnist()
    y = (yi[:, None] == jnp.arange(k)).astype(jnp.float32)
    model = Softmax(dim=d, n_classes=k, alpha=1.0)
    metric, _aux, qmap, hit = cached_gn_setup(
        X, y, model, alpha=1.0, newton_steps=60,
        cache_dir=os.path.join(os.path.dirname(__file__), "..", ".data_cache"),
        provenance=datasets.mnist_provenance())
    print(f"setup cache hit: {hit}", file=sys.stderr)

    e_ex = {"weights": jnp.zeros((d, k)), "bias": jnp.zeros((k,))}
    batched_vag, _ = make_whitened_fused_vag(model, metric, qmap, (X, y))

    kernel = nuts_batched.build_batched_kernel(batched_vag,
                                               max_tree_depth=max_depth)

    @jax.jit
    def warm(key):
        ks = jax.random.split(key, 2)
        E0 = {"weights": jax.random.normal(ks[0], (chains, d, k)),
              "bias": jax.random.normal(ks[1], (chains, k))}
        st = nuts_batched.batched_init(E0, batched_vag)
        return run_warmup(kernel, st, ks[1], 50,
                          initial_step_size=jnp.full((chains,), 0.1),
                          target_acceptance=target, adapt_mass=False)

    t0 = time.time()
    w = warm(jax.random.key(1))
    jax.block_until_ready(w.step_size)
    t_warm = time.time() - t0

    inv_mass = jax.tree_util.tree_map(
        lambda x: jnp.ones((chains,) + x.shape), e_ex)

    @jax.jit
    def sample(state, key):
        keys = jax.vmap(lambda kk: jax.random.split(kk, chains))(
            jax.random.split(key, draws))

        def body(s, ks):
            ns, info = kernel(ks, s, w.step_size, inv_mass)
            return ns, (info.num_integration_steps, info.depth,
                        info.acceptance_prob)

        final, (leaves, depth, acc) = jax.lax.scan(body, state, keys)
        return final, leaves, depth, acc

    t0 = time.time()
    final, leaves, depth, acc = sample(w.state, jax.random.key(2))
    jax.block_until_ready(leaves)
    t_cold = time.time() - t0

    t0 = time.time()
    final, leaves, depth, acc = sample(w.state, jax.random.key(3))
    jax.block_until_ready(leaves)
    t_hot = time.time() - t0

    mean_leaves = float(np.asarray(leaves, np.float64).mean())
    print(json.dumps({
        "draws": draws, "target_accept": target, "max_depth": max_depth,
        "warm_s": round(t_warm, 1),
        "cold_s": round(t_cold, 2), "hot_s": round(t_hot, 2),
        "s_per_batched_draw": round(t_hot / draws, 4),
        "ms_per_leaf": round(1e3 * t_hot / draws / mean_leaves, 2),
        "mean_leaves": round(mean_leaves, 1),
        "mean_depth": round(float(np.asarray(depth, np.float64).mean()), 2),
        "mean_accept": round(float(np.asarray(acc, np.float64).mean()), 3),
        "chain_draws_per_sec": round(chains * draws / t_hot, 1),
    }))


if __name__ == "__main__":
    main()
