"""Config-4 hyperparameter sweep (MNIST dropout MLP + SGD warm start +
SGHMC/SGLD): find settings where the sampled posterior's predictive accuracy
is near the SGD baseline (VERDICT r2 item 1 'Done =' criterion).

Usage: python scripts/sweep_mlp.py
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


def main():
    from dropout_hamiltonian_montecarlo_tpu.models import DropoutMLP
    from dropout_hamiltonian_montecarlo_tpu.inference import sgd, sgmcmc
    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    X, yi = datasets.mnist()
    y = one_hot(yi, 10)
    X, y, yi = jax.device_put(X), jax.device_put(y), jax.device_put(yi)
    model = DropoutMLP(dim=784, hidden=256, n_classes=10, alpha=1.0,
                       p_drop=0.1)
    plain_ld = model.make_batched_logdensity(data_size=X.shape[0])
    drop_ld = model.make_batched_logdensity(data_size=X.shape[0],
                                            dropout=True)
    params0 = model.init_params(jax.random.key(0))

    def acc_of(p):
        return float(jnp.mean((model.predict(p, X) == yi).astype(jnp.float32)))

    # --- SGD warm-start sweep ---
    sgd_kernel = sgd.build_sgd_kernel(plain_ld)
    fit = jax.jit(lambda st, k, eps: sgd.fit(
        sgd_kernel, st, k, (X, y), batch_size=1024, num_steps=3000,
        step_size=eps), static_argnums=())

    best = (None, -1.0)
    for eps in [5e-8, 1e-7, 2e-7, 5e-7, 1e-6]:
        t0 = time.time()
        st, losses = jax.jit(lambda s, k: sgd.fit(
            sgd_kernel, s, k, (X, y), batch_size=1024, num_steps=3000,
            step_size=eps))(sgd.sgd_init(params0), jax.random.key(1))
        jax.block_until_ready(st.position)
        a = acc_of(st.position)
        print(f"SGD eps={eps:.0e}: train acc {a:.4f} "
              f"loss {float(losses[-1]):.1f} ({time.time()-t0:.1f}s)",
              flush=True)
        if a > best[1]:
            best = (st.position, a)
    warm, warm_acc = best
    print(f"best SGD acc {warm_acc:.4f}")

    # --- SGHMC sweep from the warm start ---
    for eps in [3e-6, 1e-5, 3e-5]:
        for friction in [1.0, 10.0]:
            kernel = sgmcmc.build_sghmc_kernel(drop_ld, friction=friction,
                                               keyed=True)
            t0 = time.time()
            _, positions, infos = sgmcmc.run_sgmcmc(
                kernel, sgmcmc.sghmc_init(warm), jax.random.key(2), (X, y),
                batch_size=1024, num_steps=3000,
                step_size_schedule=sgmcmc.constant_schedule(eps),
                collect_every=10, burnin_steps=1000)
            jax.block_until_ready(positions["b3"])
            pm = jax.tree_util.tree_map(lambda p: p.mean(0), positions)
            a = acc_of(pm)
            ld_last = float(np.asarray(infos.logdensity)[-1])
            print(f"SGHMC eps={eps:.0e} fric={friction}: posterior-mean acc "
                  f"{a:.4f} logp {ld_last:.0f} ({time.time()-t0:.1f}s)",
                  flush=True)

    # --- SGLD sweep ---
    for eps in [1e-6, 3e-6, 1e-5]:
        kernel = sgmcmc.build_sgld_kernel(drop_ld, keyed=True)
        t0 = time.time()
        _, positions, infos = sgmcmc.run_sgmcmc(
            kernel, sgmcmc.sgld_init(warm), jax.random.key(3), (X, y),
            batch_size=1024, num_steps=3000,
            step_size_schedule=sgmcmc.constant_schedule(eps),
            collect_every=10, burnin_steps=1000)
        jax.block_until_ready(positions["b3"])
        pm = jax.tree_util.tree_map(lambda p: p.mean(0), positions)
        a = acc_of(pm)
        print(f"SGLD eps={eps:.0e}: posterior-mean acc {a:.4f} "
              f"logp {float(np.asarray(infos.logdensity)[-1]):.0f} "
              f"({time.time()-t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
