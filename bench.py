"""Headline benchmark: effective samples/sec on the MNIST softmax posterior.

North-star metric (BASELINE.json): >= 1000 effective samples/s/chip for HMC on
the 10k-parameter (784x10+10) MNIST softmax model.  The reference's comparable
numbers (BASELINE.md): CPU HMC on a 3-param logistic took ~8-15 s/draw; MNIST
softmax was only ever run with SGD (24.3 s / 50 epochs) — full-batch HMC on
MNIST was computationally out of reach for it.

Pipeline (see ops/kron_metric.py for the math):
  1. Kronecker Gauss-Newton metric at the uniform Fisher -> natural-gradient
     (Newton) MAP.
  2. Metric refreshed with the empirical Fisher AT the MAP (K-FAC) — tracks
     the true posterior curvature.
  3. HMC runs in WHITENED coordinates e = M^{1/2}(q - qmap): the posterior is
     near N(0, I) there, every array is O(1) in float32 (no mixed scales),
     and dual averaging adapts per-chain step sizes.
  4. Draws map back to parameter space on-device; ESS is computed per
     parameter coordinate in PARAMETER space.

Execution: 128 chains advance together through one chain-batched
value+grad per leapfrog step (ops/kron_metric.make_whitened_fused_vag): XLA
turns the chain axis into one (N, D) @ (D, C*K) product.  Warmup runs on the
same batched kernel with per-chain dual averaging (one compiled scan for all
chains).  No (n, D) array crosses device->host; ESS is computed on device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
value = MEDIAN ESS/s over all 7850 parameter coordinates; detail carries the
honest tails (p10/min ESS and ESS/s, the chains*draws saturation cap, and
the amortized setup costs excluded from the rate).  Extra logging on stderr.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from dropout_hamiltonian_montecarlo_tpu.utils.runtime import configure

configure()  # compile cache + float32 matmul precision (utils/runtime.py)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Defaults (128 chains, L=10, warmup acceptance target 0.5, NUTS depth cap 4)
# were swept on the previous accelerator and are still to be re-derived on
# the H100; ChEES (BENCH_CHEES=1) tunes the trajectory length itself.
NUM_CHAINS = int(os.environ.get("BENCH_CHAINS", "128"))
NUM_WARMUP = int(os.environ.get("BENCH_WARMUP", "300"))
NUM_SAMPLES = int(os.environ.get("BENCH_DRAWS", "1000"))
# BENCH_DATASET=digits: real bundled sklearn 8x8 pixels (1797 x 64) instead
# of MNIST — the non-synthetic provenance check of the whole bench pipeline
BENCH_DATASET = os.environ.get("BENCH_DATASET", "mnist")
# fixed trajectory length; BENCH_L overrides, BENCH_CHEES=1 instead tunes it
# with the cross-chain ChEES criterion (inference/chees.py) during warmup.
# Larger steps at fixed L pay on this light-tailed whitened posterior: each
# draw travels farther for the same compute while the energy error grows
# slowly, hence the low acceptance target below.
NUM_INTEGRATION_STEPS = int(os.environ.get("BENCH_L", "10"))
USE_CHEES = os.environ.get("BENCH_CHEES", "0") == "1"
# BENCH_SAMPLER=nuts: the lockstep chain-batched NUTS kernel instead of
# fixed-L HMC — adaptive trajectories on the same batched path + gauge Gibbs.
# BENCH_NUTS_DEPTH bounds the doubling (4 => <=15-leaf trees), or "auto":
# warm up at an exploratory cap of 6 (trees stop at their natural U-turn)
# and derive the sampling cap from the OBSERVED trajectory lengths.
BENCH_SAMPLER = os.environ.get("BENCH_SAMPLER", "hmc")
_NUTS_DEPTH_RAW = os.environ.get("BENCH_NUTS_DEPTH", "4")
NUTS_AUTO = _NUTS_DEPTH_RAW == "auto"
NUTS_DEPTH = 6 if NUTS_AUTO else int(_NUTS_DEPTH_RAW)
# BENCH_CHAIN_SHARDS>1: lay the chain axis across that many devices and run
# the sampling scan through parallel.chains.sample_batched_sharded
# (per-(draw, chain) keys + per-chain gauge-Gibbs keys keep results
# independent of the blocking).
CHAIN_SHARDS = int(os.environ.get("BENCH_CHAIN_SHARDS", "1"))
# warmup acceptance target, BENCH_TARGET_ACCEPT overrides.  Multinomial NUTS
# never rejects, so bigger steps pay for it too until the tree weights
# degenerate.  NOTE: posterior-specific — on sklearn-digits 0.5 halves min
# ESS (the CLI keeps 0.65 for that reason).
TARGET_ACCEPT = float(os.environ.get("BENCH_TARGET_ACCEPT", "0.5"))
ALPHA = 1.0


def main():
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.inference.base import run_inference
    from dropout_hamiltonian_montecarlo_tpu.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.diagnostics.ess import (
        effective_sample_size,
    )
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        cached_gn_setup,
        make_whitened_gauge_gibbs,
    )
    from dropout_hamiltonian_montecarlo_tpu.ops.tree import tree_add

    t_setup0 = time.time()
    if BENCH_DATASET == "digits":
        dataset_provenance = "sklearn-digits"
        X, yi = datasets.digits()
    else:
        dataset_provenance = datasets.mnist_provenance()
        X, yi = datasets.mnist()
    y = (yi[:, None] == jnp.arange(10)).astype(jnp.float32)
    X, y = jax.device_put(X), jax.device_put(y)
    jax.block_until_ready((X, y))
    d = int(X.shape[1])
    model = Softmax(dim=d, n_classes=10, alpha=ALPHA)
    log(f"data: {X.shape}; params={d * 10 + 10} chains={NUM_CHAINS}")

    logdensity = model.make_logdensity(batch=(X, y))

    # Metric pipeline (uniform-Fisher Kronecker metric -> Newton MAP ->
    # K-FAC metric at the MAP probs), DISK-CACHED keyed on the dataset
    # fingerprint: the ~150 s of Gram eigh + Newton MAP amortizes to a
    # ~seconds npz load across bench reruns (BENCH_SETUP_CACHE=0 disables).
    cache_dir = (None if os.environ.get("BENCH_SETUP_CACHE", "1") == "0"
                 else os.path.join(os.path.dirname(__file__), ".data_cache"))
    metric, metric_aux, qmap, from_cache = cached_gn_setup(
        X, y, model, alpha=ALPHA, newton_steps=60, cache_dir=cache_dir,
        provenance=dataset_provenance)
    acc = float((model.predict(qmap, X) == yi).mean())
    t_setup = time.time() - t_setup0
    log(f"metric setup ({'cache hit' if from_cache else 'computed'}): "
        f"{t_setup:.1f}s; MAP train acc {acc:.4f}")

    # exact Gibbs on the softmax gauge subspace (the likelihood-blind
    # directions that dominate the min-ESS tail): resampled after every HMC
    # draw, driving their ESS to the cap at zero dataset-pass cost
    gauge_gibbs = make_whitened_gauge_gibbs(metric, metric_aux, qmap)

    # --- whitened-space HMC: e = M^{1/2}(q - qmap), posterior ~ N(0, I) ---
    e_example = {
        "weights": jnp.zeros((d, 10), jnp.float32),
        "bias": jnp.zeros((10,), jnp.float32),
    }

    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        make_whitened_fused_vag,
    )

    # The dataset is an argument of every program below, and the value+grad
    # and kernels are built from it inside them: a closed-over array would
    # be compiled in as a constant, which makes each compile far slower.
    data = (X, y)

    def vag_of(batch):
        return make_whitened_fused_vag(model, metric, qmap, batch)[0]

    def laplace_init(key):
        # Laplace init is exactly e ~ N(0, I) in whitened coordinates
        ks = jax.random.split(key, 2)
        return {
            "weights": jax.random.normal(ks[0], (NUM_CHAINS, d, 10),
                                         jnp.float32),
            "bias": jax.random.normal(ks[1], (NUM_CHAINS, 10), jnp.float32),
        }

    use_chees = USE_CHEES and BENCH_SAMPLER != "nuts"  # ChEES tunes HMC's T
    if use_chees:
        # cross-chain ChEES warmup (inference/chees.py): jointly adapts a
        # SHARED (step size, trajectory length); the sampling kernel then
        # runs at the tuned fixed L instead of the hand-picked BENCH_L
        from dropout_hamiltonian_montecarlo_tpu.inference.chees import (
            run_chees_warmup,
        )

        @jax.jit
        def warm_chees(key, batch):
            E0 = laplace_init(jax.random.fold_in(key, 0))
            state = hmc.batched_init(E0, vag_of(batch))
            return run_chees_warmup(
                vag_of(batch), state, jax.random.fold_in(key, 1), NUM_WARMUP,
                initial_step_size=0.1, target_acceptance=TARGET_ACCEPT,
                max_leapfrog_steps=64)

        t0 = time.time()
        cres = warm_chees(jax.random.key(1), data)
        jax.block_until_ready(cres.step_size)
        t_warm = time.time() - t0
        num_steps = max(int(cres.num_integration_steps), 1)
        log(f"ChEES warmup ({NUM_WARMUP} steps, incl compile): {t_warm:.1f}s; "
            f"eps={float(cres.step_size):.4f} "
            f"T={float(cres.trajectory_length):.3f} -> L={num_steps}")

        warm_state = cres.state
        warm_step_size = jnp.full((NUM_CHAINS,), cres.step_size, jnp.float32)
        warm_inv_mass = jax.tree_util.tree_map(jnp.ones_like, e_example)
        warm_inv_mass = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (NUM_CHAINS,) + x.shape),
            warm_inv_mass)
    else:
        num_steps = NUM_INTEGRATION_STEPS

    if BENCH_SAMPLER == "nuts":
        # adaptive trajectories on the SAME batched path; every tree leaf
        # needs the accurate value (multinomial weights + divergence), so
        # there is no lazy grad-only variant here
        from dropout_hamiltonian_montecarlo_tpu.inference import nuts_batched

        def make_kernel(batch):
            return nuts_batched.build_batched_kernel(
                vag_of(batch), max_tree_depth=NUTS_DEPTH)

        num_steps = 2 ** NUTS_DEPTH - 1   # grad-eval accounting upper bound
        batched_init_fn = nuts_batched.batched_init
    else:
        # lazy-value trajectories (L-1 grad-only leapfrog steps + ONE
        # accurate value+grad at the proposal) once make_whitened_fused_vag
        # supplies a grad-only function; until then it returns None
        def make_kernel(batch):
            vag, grad_only = make_whitened_fused_vag(model, metric, qmap,
                                                     batch)
            return hmc.build_batched_kernel(vag, num_steps,
                                            grad_fn=grad_only)

        batched_init_fn = hmc.batched_init

    if not use_chees:
        @jax.jit
        def warm(key, batch):
            E0 = laplace_init(jax.random.fold_in(key, 0))
            state = batched_init_fn(E0, vag_of(batch))
            # per-chain dual averaging on the SAME batched kernel: one
            # compiled scan, one dataset pass per leapfrog step for all
            # chains.  adapt_mass=False: the Kronecker metric already
            # whitens; Welford variance from short unmixed windows only
            # degrades the scale.
            return run_warmup(make_kernel(batch), state,
                              jax.random.fold_in(key, 1), NUM_WARMUP,
                              initial_step_size=jnp.full((NUM_CHAINS,), 0.1,
                                                         jnp.float32),
                              target_acceptance=TARGET_ACCEPT,
                              adapt_mass=False)

        t0 = time.time()
        warmres = warm(jax.random.key(1), data)
        jax.block_until_ready(warmres.step_size)
        t_warm = time.time() - t0
        warm_state = warmres.state
        warm_step_size = warmres.step_size
        warm_inv_mass = warmres.inv_mass
        ss = np.asarray(warmres.step_size)
        log(f"warmup ({NUM_WARMUP} steps, incl compile): {t_warm:.1f}s; "
            f"step size median={np.median(ss):.4f} min={ss.min():.4f} "
            f"max={ss.max():.4f}")

    warmup_median_leaves = None
    if BENCH_SAMPLER == "nuts" and NUTS_AUTO:
        # derive the sampling depth cap from the warmup's natural tree
        # sizes (warmup ran uncapped-in-practice at depth 6): truncate at
        # ~0.55 of the median U-turn trajectory
        from dropout_hamiltonian_montecarlo_tpu.inference import nuts_batched

        winfos, _ = warmres.info
        leaves_w = np.asarray(winfos.num_integration_steps, np.float64)
        warmup_median_leaves = float(np.median(leaves_w[-100:]))
        # nearest cap IN LEAF COUNT to the target trajectory (floor-in-log2
        # can undershoot by up to ~2x for medians far from a 2^k boundary).
        # The truncation fraction depends on the acceptance target: at high
        # targets (small eps) trees overshoot the ESS optimum and 0.55x the
        # natural U-turn wins; at low targets (<=0.55, big eps) the U-turn
        # already lands near the optimum and truncating below it loses.
        frac = 1.0 if TARGET_ACCEPT <= 0.55 else 0.55
        target_leaves = max(frac * warmup_median_leaves, 3.0)
        auto_cap = min(range(2, NUTS_DEPTH + 1),
                       key=lambda c: abs((2 ** c - 1) - target_leaves))
        log(f"auto depth cap: warmup median leaves "
            f"{warmup_median_leaves:.0f} -> cap {auto_cap} "
            f"({2 ** auto_cap - 1} leaves max)")
        def make_kernel(batch):
            return nuts_batched.build_batched_kernel(
                vag_of(batch), max_tree_depth=auto_cap)

        num_steps = 2 ** auto_cap - 1
        nuts_cap = auto_cap

        # short dual-averaging refinement ON the capped kernel: the
        # exploratory warmup tuned eps for natural-U-turn trees, but the
        # truncated sampler accepts more at the same eps (no far-end
        # leaves), so eps re-adapts upward here
        refine_steps = min(100, NUM_WARMUP)

        @jax.jit
        def refine(state, ss, key, batch):
            return run_warmup(make_kernel(batch), state, key, refine_steps,
                              initial_step_size=ss,
                              target_acceptance=TARGET_ACCEPT,
                              adapt_mass=False)

        t0 = time.time()
        rres = refine(warm_state, warm_step_size, jax.random.key(4), data)
        jax.block_until_ready(rres.step_size)
        t_warm += time.time() - t0
        warm_state, warm_step_size = rres.state, rres.step_size
        rs = np.asarray(warm_step_size)
        log(f"refined step size at cap {auto_cap}: median={np.median(rs):.4f}")
    else:
        nuts_cap = NUTS_DEPTH

    if CHAIN_SHARDS > 1:
        if len(jax.devices()) < CHAIN_SHARDS:
            raise SystemExit(f"BENCH_CHAIN_SHARDS={CHAIN_SHARDS} needs "
                             f">= that many devices")
        if NUM_CHAINS % CHAIN_SHARDS != 0:
            raise SystemExit(
                f"BENCH_CHAIN_SHARDS={CHAIN_SHARDS} must divide "
                f"BENCH_CHAINS={NUM_CHAINS}")
        from dropout_hamiltonian_montecarlo_tpu.parallel import (
            sample_batched_sharded,
        )
        from dropout_hamiltonian_montecarlo_tpu.parallel.mesh import (
            make_mesh,
        )

        bench_mesh = make_mesh(num_chain_shards=CHAIN_SHARDS,
                               devices=jax.devices()[:CHAIN_SHARDS])
        log(f"chain axis sharded over {CHAIN_SHARDS} devices")

        def gibbs_post(chain_keys, s):
            gk = jax.vmap(lambda k: jax.random.fold_in(k, 1))(chain_keys)
            return gauge_gibbs(gk, s)

        @jax.jit
        def sample(states, step_sizes, inv_mass, key, batch):
            st = batched_init_fn(states.position, vag_of(batch))
            # the mesh's data axis has size 1: every device holds the batch
            _, pos, infos = sample_batched_sharded(
                None, st, step_sizes, inv_mass, key, NUM_SAMPLES,
                bench_mesh, data=batch, kernel_factory=make_kernel,
                post_step=gibbs_post)
            return pos, infos
    else:
        @jax.jit
        def sample(states, step_sizes, inv_mass, key, batch):
            st = batched_init_fn(states.position, vag_of(batch))
            keys = jax.random.split(key, NUM_SAMPLES)
            kernel = make_kernel(batch)

            def body(s, k):
                ns, info = kernel(k, s, step_sizes, inv_mass)
                ns = gauge_gibbs(jax.random.fold_in(k, 1), ns)
                return ns, (ns.position, info)

            _, (pos, infos) = jax.lax.scan(body, st, keys)
            # (T, C, ...) -> (C, T, ...): chains leading, draws second
            swap = lambda x: jnp.swapaxes(x, 0, 1)
            return (jax.tree_util.tree_map(swap, pos),
                    jax.tree_util.tree_map(swap, infos))

    @jax.jit
    def ess_of(e_draws):
        # back to parameter space ON DEVICE, one chain at a time (lax.map):
        # unwhitening all chains*draws at once would materialize ~10x the
        # 4 GB draw block in Kronecker-matmul temporaries
        def per_chain(e_c):
            return jax.vmap(lambda e: tree_add(qmap, metric.unwhiten(e)))(e_c)

        q_draws = jax.lax.map(per_chain, e_draws)
        # blocked ESS: the FFT buffer at (7850, 128, 2048) complex is ~16 GB
        # all-at-once; 512-coordinate blocks bound it at ~1 GB
        return jnp.concatenate([
            effective_sample_size(q_draws["weights"], block_size=512).ravel(),
            effective_sample_size(q_draws["bias"]).ravel(),
        ])

    import contextlib

    from dropout_hamiltonian_montecarlo_tpu.utils.profiling import (
        SamplerStats,
        device_trace,
    )

    t0 = time.time()
    e_draws, infos = sample(warm_state, warm_step_size,
                            warm_inv_mass, jax.random.key(2), data)
    jax.block_until_ready(e_draws["bias"])
    log(f"sampling (incl compile): {time.time() - t0:.1f}s")

    trace_dir = os.environ.get("BENCH_TRACE")  # e.g. /tmp/bench_trace
    ctx = device_trace(trace_dir) if trace_dir else contextlib.nullcontext()
    stats = SamplerStats(num_chains=NUM_CHAINS).start()
    with ctx:
        e_draws, infos = sample(warm_state, warm_step_size,
                                warm_inv_mass, jax.random.key(3), data)
        jax.block_until_ready(e_draws["bias"])
    # grad-eval accounting from the kernels' own reports.  For NUTS the
    # lockstep kernel EXECUTES max-over-chains leaves per draw (terminated
    # chains ride along masked), so the executed-work rate uses the
    # per-draw max; the retained per-chain mean is reported separately.
    leaves = np.asarray(infos.num_integration_steps, np.float64)  # (C, T)
    mean_evals = float(leaves.mean())
    executed_evals = (float(leaves.max(axis=0).mean())
                      if leaves.ndim == 2 else mean_evals)
    stats.stop(draws=NUM_CHAINS * NUM_SAMPLES,
               grad_evals=int(NUM_CHAINS * NUM_SAMPLES * executed_evals))
    t_sample = stats.seconds
    ess = np.asarray(ess_of(e_draws))

    accept = float(np.asarray(infos.acceptance_prob).mean())
    div = float(np.asarray(infos.is_divergent).mean())
    log(f"sampling: {t_sample:.2f}s for {NUM_CHAINS}x{NUM_SAMPLES} draws; "
        f"accept={accept:.3f} divergent={div:.4f}")

    cap = NUM_CHAINS * NUM_SAMPLES
    med_ess = float(np.median(ess))
    p10_ess = float(np.percentile(ess, 10))
    min_ess = float(np.min(ess))
    frac_capped = float(np.mean(ess >= cap * 0.999))
    ess_per_sec = med_ess / t_sample
    log(f"ESS: median={med_ess:.0f} p10={p10_ess:.0f} min={min_ess:.0f} "
        f"(cap={cap}, {frac_capped:.0%} of coords at cap) | "
        f"ESS/s: median={ess_per_sec:.0f} p10={p10_ess / t_sample:.0f} "
        f"min={min_ess / t_sample:.0f}")
    log(f"amortized (excluded from rate): setup {t_setup:.0f}s "
        f"(Gram eigh + Newton MAP + metric), warmup {t_warm:.0f}s")

    result = {
        "metric": "median_ess_per_sec_mnist_softmax_hmc",
        "value": round(ess_per_sec, 1),
        "unit": "eff_samples/s/chip",
        "vs_baseline": round(ess_per_sec / 1000.0, 3),
        "detail": {
            "chains": NUM_CHAINS,
            "draws": NUM_SAMPLES,
            "sample_seconds": round(t_sample, 2),
            "ess_median": round(med_ess, 1),
            "ess_p10": round(p10_ess, 1),
            "ess_min": round(min_ess, 1),
            "ess_nonfinite": int(np.sum(~np.isfinite(ess))),
            "ess_cap_chains_x_draws": cap,
            "frac_coords_at_cap": round(frac_capped, 4),
            "ess_per_sec_p10": round(p10_ess / t_sample, 1),
            "ess_per_sec_min": round(min_ess / t_sample, 1),
            "acceptance": round(accept, 4),
            "divergent_frac": round(div, 6),
            "draws_per_sec": round(stats.draws_per_sec, 1),
            "grad_evals_per_sec": round(stats.grads_per_sec, 1),
            "amortized_setup_seconds": round(t_setup, 1),
            "setup_from_cache": from_cache,
            "amortized_warmup_seconds": round(t_warm, 1),
            "warmup_step_size_median": float(np.median(
                np.asarray(warm_step_size))),
            "chain_shards": CHAIN_SHARDS,
            "sampler": BENCH_SAMPLER,
            "nuts_depth_cap": nuts_cap if BENCH_SAMPLER == "nuts" else None,
            "nuts_depth_mode": ("auto" if NUTS_AUTO else "fixed")
            if BENCH_SAMPLER == "nuts" else None,
            "warmup_median_leaves": warmup_median_leaves,
            "num_integration_steps": round(mean_evals, 2),
            "lockstep_evals_per_draw": round(executed_evals, 2),
            "warmup": "chees" if use_chees else "dual-averaging",
            "dataset": dataset_provenance,
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
