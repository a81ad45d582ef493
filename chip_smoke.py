"""Smoke test of the main path on a GPU, at the full width of the MNIST
softmax posterior (N=60000, D=784, K=10, 7,850 parameters, 128 chains,
whitened with the Kronecker Gauss-Newton metric).

    python chip_smoke.py              # one card
    python chip_smoke.py --multi-gpu  # four cards: sharded paths vs one card

One card runs four phases in this process, each through the entry points a
user calls:

1. parity: the whitened batched value+grad (ops/kron_metric.
   make_whitened_fused_vag) against a plain float32 reference at Laplace
   draws, plus its warm time against the float32 compute bound;
2. hmc: bench.py's pipeline with a short warmup and few draws;
3. nuts: ``cli mnist-nuts`` (lockstep NUTS + on-device diagnostics);
4. sghmc: ``cli mnist-mlp-sgmcmc --algorithm sghmc`` (dropout in the
   sampled potential).

``--multi-gpu`` runs only the sharded paths, each against one card: the
headline sampling scan with the chain axis over 4 cards, data-sharded SGHMC,
and ``mnist-nuts --chain-shards 4``.

Any failed check exits non-zero.  Without a GPU the script exits non-zero
before doing any work.  The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances of the parity phase.  The Metropolis-Hastings accept needs energy
# errors well below 1 nat; the gradient only steers the proposal.
VALUE_ATOL = 0.1          # nats, absolute, per chain
GRAD_RTOL = 1e-3          # relative L2 norm, per chain
# Guards on the HMC phase (whitened units, posterior ~ N(0, I)).  A step size
# below MIN_STEP is the signature of energies too noisy for the accept.
MIN_STEP = 1e-2
ACCEPT_RANGE = (0.2, 0.99)
MAX_DIVERGENT = 0.01
# Four-card parity: fraction of chains whose sharded draws must match the
# one-card draws to SHARD_ATOL (an accept decision may flip where the two
# energies, summed in another order, straddle the uniform draw).
SHARD_ATOL = 1e-3
SHARD_AGREE = 0.97

MNIST_N, MNIST_D, MNIST_K = 60000, 784, 10
F32_PEAK_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores


def vag_flops(n, d, k, chains):
    """FLOPs of one batched value+grad: the logits GEMM and the gradient's
    transposed GEMM, 2*N*D*K*C each."""
    return 2 * (2 * n * d * k * chains)


# --------------------------------------------------------------------------
# checks (pure functions of the numbers; each returns a list of failures)
# --------------------------------------------------------------------------

def parity_errors(value, grad, ref_value, ref_grad):
    """(max |value - ref| over chains, max relative L2 gradient error)."""
    def flat(g):
        return np.concatenate([np.asarray(g["weights"], np.float64).reshape(
            len(value), -1), np.asarray(g["bias"], np.float64)], axis=1)

    v_err = np.abs(np.asarray(value, np.float64)
                   - np.asarray(ref_value, np.float64))
    g, rg = flat(grad), flat(ref_grad)
    g_err = np.linalg.norm(g - rg, axis=1) / np.linalg.norm(rg, axis=1)
    return float(np.max(v_err)), float(np.max(g_err))


def check_parity(value_err, grad_err):
    out = []
    if not value_err <= VALUE_ATOL:
        out.append(f"value error {value_err:.3g} > {VALUE_ATOL} nats")
    if not grad_err <= GRAD_RTOL:
        out.append(f"relative gradient error {grad_err:.3g} > {GRAD_RTOL}")
    return out


def check_hmc(detail):
    out = []
    step = detail["warmup_step_size_median"]
    if not step >= MIN_STEP:
        out.append(f"median warmup step size {step:.3g} < {MIN_STEP}")
    acc = detail["acceptance"]
    if not ACCEPT_RANGE[0] < acc < ACCEPT_RANGE[1]:
        out.append(f"mean acceptance {acc:.3g} outside {ACCEPT_RANGE}")
    div = detail["divergent_frac"]
    if not div <= MAX_DIVERGENT:
        out.append(f"divergent fraction {div:.3g} > {MAX_DIVERGENT}")
    ess = [detail[k] for k in ("ess_min", "ess_p10", "ess_median")]
    if detail["ess_nonfinite"] or not np.all(np.isfinite(ess)):
        out.append(f"non-finite ESS ({detail['ess_nonfinite']} coords)")
    return out


def check_finite(j, keys):
    bad = [k for k in keys if not np.isfinite(j[k])]
    return [f"non-finite {', '.join(bad)}"] if bad else []


def check_shard_parity(agree_frac, accept_diff):
    out = []
    if not agree_frac >= SHARD_AGREE:
        out.append(f"only {agree_frac:.3f} of chains match to {SHARD_ATOL}")
    if not accept_diff <= 0.02:
        out.append(f"mean acceptance differs by {accept_diff:.3g}")
    return out


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def mnist_setup():
    """Synthetic MNIST, the Softmax model and the Kronecker metric computed
    in this run (no disk cache)."""
    import jax
    import jax.numpy as jnp

    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        cached_gn_setup,
    )

    X, yi = datasets.mnist()
    y = (yi[:, None] == jnp.arange(MNIST_K)).astype(jnp.float32)
    X, y = jax.device_put(X), jax.device_put(y)
    model = Softmax(dim=X.shape[1], n_classes=MNIST_K, alpha=1.0)
    metric, aux, qmap, _ = cached_gn_setup(X, y, model, alpha=1.0,
                                           newton_steps=60, cache_dir=None)
    return model, metric, aux, qmap, (X, y)


def laplace_draws(key, chains, d, k):
    """Whitened Laplace draws e ~ N(0, I) (the bench's chain init)."""
    import jax

    kw, kb = jax.random.split(key)
    return {"weights": jax.random.normal(kw, (chains, d, k)),
            "bias": jax.random.normal(kb, (chains, k))}


def reference_vag(model, metric, qmap):
    """Plain float32 reference of the whitened batched value+grad:
    jax.value_and_grad of Softmax.log_posterior at q = qmap + unwhiten(e),
    vmapped over chains, the gradient mapped to whitened coordinates by the
    transpose of unwhiten, all under "highest" matmul precision.  Returns a
    jitted (E, batch) -> (values, whitened grads)."""
    import jax

    e_example = jax.tree_util.tree_map(jax.numpy.zeros_like, qmap)
    unwhiten_t = jax.linear_transpose(metric.unwhiten, e_example)

    def one(e, batch):
        q = jax.tree_util.tree_map(lambda m, d: m + d, qmap,
                                   metric.unwhiten(e))
        v, gq = jax.value_and_grad(model.log_posterior)(q, batch)
        return v, unwhiten_t(gq)[0]

    def ref(E, batch):
        with jax.default_matmul_precision("highest"):
            return jax.vmap(one, in_axes=(0, None))(E, batch)

    return jax.jit(ref)


def _median_seconds(fn, *args, calls=20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def run_json(fn):
    """Run fn with stdout captured; return the last JSON line it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError("no JSON line in the output")
    return json.loads(lines[-1])


def run_cli(argv):
    from dropout_hamiltonian_montecarlo_tpu import cli

    j = run_json(lambda: cli.main(argv))
    print(json.dumps(j), flush=True)
    return j


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def phase_parity(chains=128):
    import jax

    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        make_whitened_fused_vag,
    )
    from dropout_hamiltonian_montecarlo_tpu.utils.runtime import (
        MATMUL_PRECISION,
    )

    model, metric, _, qmap, batch = mnist_setup()
    n, d = batch[0].shape
    # the batch is an argument so the dataset is not compiled in as a
    # constant (see ops/kron_metric.cached_gn_setup)
    vag = jax.jit(lambda E, batch: make_whitened_fused_vag(
        model, metric, qmap, batch)[0](E))
    E = laplace_draws(jax.random.key(0), chains, d, MNIST_K)
    value, grad = vag(E, batch)
    ref_value, ref_grad = reference_vag(model, metric, qmap)(E, batch)
    v_err, g_err = parity_errors(value, grad, ref_value, ref_grad)
    secs = _median_seconds(vag, E, batch)
    bound = vag_flops(n, d, MNIST_K, chains) / F32_PEAK_FLOPS
    print(f"parity: precision={MATMUL_PRECISION} "
          f"max_value_err={v_err:.4g} nats (tol {VALUE_ATOL}) "
          f"max_grad_rel_err={g_err:.4g} (tol {GRAD_RTOL}) "
          f"|value| median={float(np.median(np.abs(value))):.6g}", flush=True)
    print(f"value+grad N={n} D={d} K={MNIST_K} C={chains}: median of 20 "
          f"warm calls {secs * 1e3:.3f} ms; float32 compute bound "
          f"{bound * 1e3:.3f} ms ({bound / secs:.2f} of it)", flush=True)
    return check_parity(v_err, g_err)


def phase_hmc(chains=128, warmup=50, draws=20):
    os.environ.update({
        "BENCH_CHAINS": str(chains), "BENCH_WARMUP": str(warmup),
        "BENCH_DRAWS": str(draws), "BENCH_DATASET": "mnist",
        "BENCH_SETUP_CACHE": "0", "BENCH_SAMPLER": "hmc",
        "BENCH_CHAIN_SHARDS": "1"})
    import bench

    j = run_json(bench.main)
    print(json.dumps(j), flush=True)
    print(f"setup_from_cache={j['detail']['setup_from_cache']}", flush=True)
    return check_hmc(j["detail"])


NUTS_KEYS = ("min_ess", "median_ess", "max_rhat")


def nuts_cli(chains=128, warmup=30, draws=20, extra=()):
    return run_cli(["mnist-nuts", "--chains", str(chains), "--warmup",
                    str(warmup), "--samples", str(draws), "--max-depth", "4",
                    "--stream-chunk", "10", *extra])


def phase_nuts():
    return check_finite(nuts_cli(), NUTS_KEYS)


def sghmc_cli(steps=300, sgd_steps=200, extra=()):
    return run_cli(["mnist-mlp-sgmcmc", "--algorithm", "sghmc",
                    "--num-steps", str(steps), "--burnin-steps",
                    str(steps // 3), "--sgd-init-steps", str(sgd_steps),
                    *extra])


def check_sghmc(j):
    out = check_finite(j, ("predictive_accuracy", "predictive_nll",
                           "logdensity_rhat"))
    if not j["predictive_accuracy"] > 0.5:
        out.append(f"predictive accuracy {j['predictive_accuracy']} <= 0.5")
    return out


def phase_sghmc():
    return check_sghmc(sghmc_cli())


# --------------------------------------------------------------------------
# four-card phases (each against the same computation on one card)
# --------------------------------------------------------------------------

def phase_chain_sharded_hmc(shards=4, chains=128, warmup=30, draws=10):
    """The headline sampling scan (batched HMC + gauge Gibbs) with the chain
    axis over ``shards`` cards vs one card, same per-chain keys and step
    sizes."""
    import jax
    import jax.numpy as jnp

    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        make_whitened_fused_vag,
        make_whitened_gauge_gibbs,
    )
    from dropout_hamiltonian_montecarlo_tpu.parallel import (
        make_mesh,
        sample_batched_sharded,
    )

    model, metric, aux, qmap, batch = mnist_setup()
    d = batch[0].shape[1]
    gibbs = make_whitened_gauge_gibbs(metric, aux, qmap)
    inv_mass = {"weights": jnp.ones((chains, d, MNIST_K)),
                "bias": jnp.ones((chains, MNIST_K))}

    # kernels are built from the batch inside each program, so the dataset
    # is an argument and not a compiled-in constant
    def vag_for(batch):
        return make_whitened_fused_vag(model, metric, qmap, batch)[0]

    def kernel_for(batch):
        return hmc.build_batched_kernel(vag_for(batch), 10)

    @jax.jit
    def warm(key, batch):
        st = hmc.batched_init(laplace_draws(key, chains, d, MNIST_K),
                              vag_for(batch))
        w = run_warmup(kernel_for(batch), st, jax.random.fold_in(key, 1),
                       warmup, initial_step_size=jnp.full((chains,), 0.1),
                       target_acceptance=0.5, adapt_mass=False)
        return w.state, w.step_size

    state, step = warm(jax.random.key(1), batch)

    def gibbs_post(chain_keys, s):
        return gibbs(jax.vmap(lambda k: jax.random.fold_in(k, 1))(chain_keys),
                     s)

    def run(n):
        # the mesh's data axis has size 1: every card holds the whole batch
        mesh = make_mesh(num_chain_shards=n, devices=jax.devices()[:n])
        f = jax.jit(lambda st, ss, batch: sample_batched_sharded(
            None, st, ss, inv_mass, jax.random.key(2), draws, mesh,
            data=batch, kernel_factory=kernel_for, post_step=gibbs_post)[1:])
        pos, infos = f(state, step, batch)
        return (np.concatenate([np.asarray(pos["weights"]).reshape(
            chains, draws, -1), np.asarray(pos["bias"])], axis=2),
            np.asarray(infos.acceptance_prob))

    pos_1, acc_1 = run(1)
    pos_n, acc_n = run(shards)
    per_chain = np.max(np.abs(pos_n - pos_1), axis=(1, 2))
    agree = float(np.mean(per_chain <= SHARD_ATOL))
    acc_diff = abs(float(acc_n.mean()) - float(acc_1.mean()))
    print(f"chain-sharded HMC ({shards} cards vs 1, {chains} chains x {draws} "
          f"draws): chains matching to {SHARD_ATOL}: {agree:.4f} (need "
          f">= {SHARD_AGREE}); median per-chain max|diff| "
          f"{float(np.median(per_chain)):.3g}; mean acceptance "
          f"{acc_n.mean():.4f} vs {acc_1.mean():.4f}", flush=True)
    return check_shard_parity(agree, acc_diff)


def phase_data_sharded_sghmc(shards=4, chains=4, steps=50):
    """Data-parallel SGHMC (parallel/sgmcmc.run_sgmcmc_data_parallel, the
    path of ``cli mnist-mlp-sgmcmc --data-shards``) of the MNIST-width MLP
    with the batch over ``shards`` cards vs one card.  Stratified per-shard
    minibatches differ from one card's by design, so the rows are constant
    and dropout is off: every minibatch realization is then the same and
    the runs agree up to the psum's summation order."""
    import jax
    import jax.numpy as jnp

    from dropout_hamiltonian_montecarlo_tpu.inference import sgmcmc
    from dropout_hamiltonian_montecarlo_tpu.models import DropoutMLP
    from dropout_hamiltonian_montecarlo_tpu.parallel import (
        make_mesh,
        make_sharded_value_and_grad,
        run_sgmcmc_data_parallel,
    )

    n, batch_size = 4096, 1024
    model = DropoutMLP(dim=MNIST_D, hidden=256, n_classes=MNIST_K,
                       alpha=1.0, p_drop=0.0)
    X = jnp.tile(jnp.linspace(0.0, 1.0, MNIST_D)[None], (n, 1))
    y = jnp.tile(jax.nn.one_hot(3, MNIST_K)[None], (n, 1))
    pos0 = jax.vmap(model.init_params)(jax.random.split(jax.random.key(5),
                                                        chains))
    states = jax.vmap(sgmcmc.sghmc_init)(pos0)
    vag = make_sharded_value_and_grad(model, data_size=n)
    kernel = sgmcmc.build_sghmc_kernel(friction=1.0, value_and_grad_fn=vag)

    def run(n_data):
        mesh = make_mesh(num_chain_shards=1, num_data_shards=n_data,
                         devices=jax.devices()[:n_data])
        _, pos, _ = jax.jit(lambda st, data: run_sgmcmc_data_parallel(
            kernel, st, jax.random.key(6), data, mesh, num_chains=chains,
            batch_size=batch_size, num_steps=steps,
            step_size_schedule=sgmcmc.constant_schedule(1e-5)))(states,
                                                                (X, y))
        return pos

    p1, pn = (jax.tree_util.tree_leaves(run(n)) for n in (1, shards))
    diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(p1, pn))
    scale = max(float(np.max(np.abs(np.asarray(a)))) for a in p1)
    print(f"data-sharded SGHMC ({shards} cards vs 1, MLP 784-256-256-10, "
          f"constant rows, {steps} steps): max|diff| {diff:.3g} (|param| max "
          f"{scale:.3g}, tol 1e-4 relative)", flush=True)
    return [] if diff <= 1e-4 * scale else [f"data-sharded diff {diff:.3g}"]


def phase_nuts_chain_shards(shards=4):
    """mnist-nuts with the chain axis over ``shards`` cards vs one card.
    Warmup keys fold in the shard index, so the draws differ; the posterior
    summaries must agree."""
    one = nuts_cli()
    many = nuts_cli(extra=("--chain-shards", str(shards)))
    fails = check_finite(one, NUTS_KEYS) + check_finite(many, NUTS_KEYS)
    for key in ("train_accuracy", "predictive_accuracy"):
        diff = abs(one[key] - many[key])
        print(f"mnist-nuts {key}: {shards} cards {many[key]:.4f} vs 1 card "
              f"{one[key]:.4f} (tol 0.01)", flush=True)
        if not diff <= 0.01:
            fails.append(f"{key} differs by {diff:.3g}")
    if many["chain_shards"] != shards:
        fails.append(f"chain_shards={many['chain_shards']}")
    return fails


# --------------------------------------------------------------------------

def _print_card():
    """Card name and power limit, from a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(out.stdout.strip(), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run the four-card sharded paths against one card")
    args = ap.parse_args(argv)

    from dropout_hamiltonian_montecarlo_tpu.utils.runtime import configure

    cache_dir = configure()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    need = 4 if args.multi_gpu else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs; found {len(devices)}",
              file=sys.stderr)
        return 2

    _print_card()
    print(f"device_kind: {devices[0].device_kind}")
    print(f"jax {jax.__version__}")
    print(f"compile cache: {cache_dir}", flush=True)

    if args.multi_gpu:
        phases = [("chain-sharded hmc", phase_chain_sharded_hmc),
                  ("data-sharded sghmc", phase_data_sharded_sghmc),
                  ("mnist-nuts --chain-shards 4", phase_nuts_chain_shards)]
    else:
        phases = [("parity", phase_parity), ("hmc", phase_hmc),
                  ("nuts", phase_nuts), ("sghmc", phase_sghmc)]
    for name, phase in phases:
        t0 = time.time()
        print(f"== phase {name}", flush=True)
        failures = phase()
        print(f"== phase {name}: {'FAIL' if failures else 'ok'} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if failures:
            for f in failures:
                print(f"FAIL {name}: {f}", flush=True)
            return 1

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
