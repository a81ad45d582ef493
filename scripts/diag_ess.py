"""Diagnose the bench's min-ESS tail (VERDICT r2 item 4).

Reproduces the headline bench pipeline (Kron Gauss-Newton metric, whitened
chain-batched HMC) at reduced draw count, then computes ESS of the
WHITENED (eigenbasis) coordinates directly and reports the slowest ones with
their curvature decomposition:

  - (i, j) eigen index, data eigenvalue product s_f[i]*s_a[j], metric mass
    d_w = c*s_f*s_a + alpha;
  - the empirical whitened std (should be ~1 if the K-FAC mass matches the
    true curvature; >>1 means the metric OVERestimates curvature there and
    HMC random-walks; <<1 means underestimate);
  - the empirical whitened mean offset (|mean| >> 0 means the Newton MAP is
    off along that direction).

Usage: python scripts/diag_ess.py [num_samples]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dropout_hamiltonian_montecarlo_tpu.utils.runtime import configure  # noqa: E402

configure()

NUM_CHAINS = 128
NUM_WARMUP = 300
NUM_SAMPLES = int(sys.argv[1]) if len(sys.argv) > 1 else 400
NUM_INTEGRATION_STEPS = 12
TARGET_ACCEPT = 0.65
ALPHA = 1.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.inference.warmup import run_warmup
    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.diagnostics.ess import (
        effective_sample_size,
    )
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        gram_eigh_augmented,
        make_whitened_fused_vag,
        natural_gradient_map,
        softmax_gauss_newton_metric,
    )

    X, yi = datasets.mnist()
    y = (yi[:, None] == jnp.arange(10)).astype(jnp.float32)
    X, y = jax.device_put(X), jax.device_put(y)
    model = Softmax(dim=784, n_classes=10, alpha=ALPHA)

    gram = gram_eigh_augmented(X)
    s_f = np.asarray(gram[0])
    metric0 = softmax_gauss_newton_metric(X, 10, alpha=ALPHA, gram=gram,
                                          augmented=True)
    logdensity = model.make_logdensity(batch=(X, y))

    @jax.jit
    def map_stage1(key):
        q0 = model.init_params(key)
        qmap = natural_gradient_map(logdensity, metric0, q0, num_steps=60)
        return qmap, model.predict(qmap, X, prob=True)

    qmap, probs = map_stage1(jax.random.key(0))
    jax.block_until_ready(qmap)

    # class-Fisher eigenvalues at the MAP (for the report)
    P = jnp.asarray(probs)
    A = np.asarray(jnp.diag(jnp.mean(P, 0)) - (P.T @ P) / P.shape[0],
                   np.float64)
    s_a = np.maximum(np.linalg.eigvalsh(A), 0.0)

    metric = softmax_gauss_newton_metric(X, 10, alpha=ALPHA, gram=gram,
                                         probs=probs, augmented=True)

    batched_vag, batched_grad = make_whitened_fused_vag(model, metric, qmap,
                                                        (X, y))

    kernel_b = hmc.build_batched_kernel(batched_vag, NUM_INTEGRATION_STEPS,
                                        grad_fn=batched_grad)

    def laplace_init(key):
        ks = jax.random.split(key, 2)
        return {"weights": jax.random.normal(ks[0], (NUM_CHAINS, 784, 10)),
                "bias": jax.random.normal(ks[1], (NUM_CHAINS, 10))}

    @jax.jit
    def warm(key):
        E0 = laplace_init(jax.random.fold_in(key, 0))
        state = hmc.batched_init(E0, batched_vag)
        return run_warmup(kernel_b, state, jax.random.fold_in(key, 1),
                          NUM_WARMUP,
                          initial_step_size=jnp.full((NUM_CHAINS,), 0.1),
                          target_acceptance=TARGET_ACCEPT, adapt_mass=False)

    t0 = time.time()
    warmres = warm(jax.random.key(1))
    jax.block_until_ready(warmres.step_size)
    log(f"warmup {time.time()-t0:.1f}s; step median "
        f"{np.median(np.asarray(warmres.step_size)):.4f}")

    @jax.jit
    def sample(states, step_sizes, inv_mass, key):
        st = hmc.batched_init(states.position, batched_vag)
        keys = jax.random.split(key, NUM_SAMPLES)

        def body(s, k):
            ns, info = kernel_b(k, s, step_sizes, inv_mass)
            return ns, (ns.position, info.acceptance_prob)

        _, (pos, acc) = jax.lax.scan(body, st, keys)
        swap = lambda x: jnp.swapaxes(x, 0, 1)
        return jax.tree_util.tree_map(swap, pos), acc

    t0 = time.time()
    e_draws, acc = sample(warmres.state, warmres.step_size, warmres.inv_mass,
                          jax.random.key(2))
    jax.block_until_ready(e_draws["bias"])
    t_sample = time.time() - t0
    log(f"sampling {t_sample:.1f}s accept={float(np.asarray(acc).mean()):.3f}")

    # ESS in EIGEN (whitened) coordinates — the mechanistic view
    @jax.jit
    def eigen_stats(e_draws):
        ew = e_draws["weights"]              # (C, T, 784, 10)
        ess_w = effective_sample_size(ew, block_size=512)
        ess_b = effective_sample_size(e_draws["bias"])
        mean_w = ew.mean(axis=(0, 1))
        std_w = ew.std(axis=(0, 1))
        mean_b = e_draws["bias"].mean(axis=(0, 1))
        std_b = e_draws["bias"].std(axis=(0, 1))
        return ess_w, ess_b, mean_w, std_w, mean_b, std_b

    ess_w, ess_b, mean_w, std_w, mean_b, std_b = map(
        np.asarray, eigen_stats(e_draws))

    cap = NUM_CHAINS * NUM_SAMPLES
    flat = ess_w.ravel()
    order = np.argsort(flat)
    print(f"\neigen-coordinate ESS: median={np.median(flat):.0f} "
          f"min={flat.min():.0f} cap={cap}")
    print(f"bias ESS: {np.sort(ess_b).astype(int)}")
    print("\nworst 25 weight eigen-coords  (i=gram idx, j=class-fisher idx; "
          "s_f asc, s_a asc):")
    print(f"{'i':>4} {'j':>2} {'ESS':>8} {'s_f':>10} {'s_a':>10} "
          f"{'s_f*s_a':>10} {'white_std':>9} {'white_mean':>10}")
    for idx in order[:25]:
        i, j = np.unravel_index(idx, ess_w.shape)
        print(f"{i:>4} {j:>2} {flat[idx]:>8.0f} {s_f[i]:>10.3e} "
              f"{s_a[j]:>10.3e} {s_f[i]*s_a[j]:>10.3e} "
              f"{std_w[i, j]:>9.3f} {mean_w[i, j]:>10.3f}")
    # where do the healthy coords sit?
    print(f"\nwhitened std: median={np.median(std_w):.3f} "
          f"p99={np.percentile(std_w, 99):.3f} max={std_w.max():.3f}")
    print(f"whitened |mean|: median={np.median(np.abs(mean_w)):.3f} "
          f"max={np.abs(mean_w).max():.3f}")
    # gauge column report (j0 = argmin s_a)
    j0 = int(np.argmin(s_a))
    print(f"\ngauge column j0={j0}: ESS min={ess_w[:, j0].min():.0f} "
          f"median={np.median(ess_w[:, j0]):.0f} "
          f"std median={np.median(std_w[:, j0]):.3f} bias ESS={ess_b[j0]:.0f}")


if __name__ == "__main__":
    main()
