"""Chain-batched value+grad and HMC kernel tests.

The chain-batched leapfrog must match the vmapped per-chain leapfrog given
the same inputs; the whitened batched value+grad (the main path's
ops/kron_metric.make_whitened_fused_vag) must match a plain float32
reference within the tolerances chip_smoke.py holds it to on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dropout_hamiltonian_montecarlo_tpu.models import Softmax
from dropout_hamiltonian_montecarlo_tpu.inference import hmc
from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
    make_whitened_fused_vag,
    softmax_gauss_newton_metric,
)
from dropout_hamiltonian_montecarlo_tpu.ops.integrators import (
    IntegratorState,
    velocity_verlet,
    velocity_verlet_batched,
)
from dropout_hamiltonian_montecarlo_tpu.ops.metrics import (
    batched_diagonal_metric,
    diagonal_metric,
)
from dropout_hamiltonian_montecarlo_tpu.ops.tree import (
    tree_ones_like,
    tree_randn_like,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N, D, K, C = 300, 32, 7, 5
ALPHA = 0.7


def _data(key):
    kx, ky, kw = jax.random.split(key, 3)
    X = jax.random.normal(kx, (N, D), jnp.float32)
    yi = jax.random.randint(ky, (N,), 0, K)
    Y = (yi[:, None] == jnp.arange(K)).astype(jnp.float32)
    W = 0.3 * jax.random.normal(kw, (C, D, K), jnp.float32)
    b = 0.1 * jax.random.normal(jax.random.fold_in(kw, 1), (C, K), jnp.float32)
    return X, Y, W, b


def test_batched_leapfrog_matches_vmapped():
    """velocity_verlet_batched == vmap(velocity_verlet) on the same inputs."""
    X, Y, W, b = _data(jax.random.key(2))
    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    ld = model.make_logdensity(batch=(X, Y))
    positions = {"weights": W, "bias": b}
    momenta = tree_randn_like(jax.random.key(3), positions)
    step_sizes = jnp.linspace(1e-3, 3e-3, C)

    # per-chain reference: vmapped single-chain verlet with unit mass
    def one(q, p, eps):
        m = diagonal_metric(tree_ones_like(q))
        integ = velocity_verlet(ld, m.kinetic_grad)
        v, g = jax.value_and_grad(ld)(q)
        out = integ(IntegratorState(q, p, v, g), eps)
        return out.position, out.momentum, out.logdensity

    ref_q, ref_p, ref_v = jax.vmap(one)(positions, momenta, step_sizes)

    # batched: one call over the chain-stacked pytree
    bvag = jax.vmap(jax.value_and_grad(ld))
    bm = batched_diagonal_metric(tree_ones_like(positions))
    binteg = velocity_verlet_batched(bvag, bm.kinetic_grad)
    v0, g0 = bvag(positions)
    out = binteg(IntegratorState(positions, momenta, v0, g0), step_sizes)

    np.testing.assert_allclose(np.asarray(out.logdensity), np.asarray(ref_v),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.position["weights"]),
                               np.asarray(ref_q["weights"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.momentum["bias"]),
                               np.asarray(ref_p["bias"]), rtol=1e-6,
                               atol=1e-6)


def test_batched_kernel_samples():
    """Chain-batched HMC kernel (XLA vag) mixes on a separable posterior:
    finite energies, reasonable acceptance, per-chain info shapes."""
    X, Y, W, b = _data(jax.random.key(4))
    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    ld = model.make_logdensity(batch=(X, Y))
    bvag = jax.vmap(jax.value_and_grad(ld))

    positions = {"weights": 0.01 * W, "bias": 0.01 * b}
    state = hmc.batched_init(positions, bvag)
    kernel = hmc.build_batched_kernel(bvag, num_integration_steps=8)
    inv_mass = tree_ones_like(positions)
    step_sizes = jnp.full((C,), 5e-3, jnp.float32)

    def body(s, k):
        ns, info = kernel(k, s, step_sizes, inv_mass)
        return ns, info

    keys = jax.random.split(jax.random.key(5), 50)
    final, infos = jax.lax.scan(body, state, keys)

    assert infos.acceptance_prob.shape == (50, C)
    assert bool(jnp.all(jnp.isfinite(final.logdensity)))
    assert float(infos.acceptance_prob.mean()) > 0.5
    assert float(infos.is_accepted.mean()) > 0.3
    # chains actually moved
    assert float(jnp.abs(final.position["weights"] -
                         positions["weights"]).max()) > 1e-4


def test_lazy_value_kernel_matches_standard():
    """build_batched_kernel(grad_fn=...) with an EXACT grad_fn must reproduce
    the standard batched kernel up to XLA refusion noise (same keys, same
    math, only the evaluation schedule differs); with a lower-precision
    gradient (bf16-rounded data and positions) it must stay close (the
    endpoint energies are still accurate)."""
    X, Y, W, b = _data(jax.random.key(10))
    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    vag = jax.vmap(jax.value_and_grad(model.make_logdensity(batch=(X, Y))))
    bf16 = lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)
    rounded = jax.vmap(jax.grad(model.make_logdensity(batch=(bf16(X), Y))))

    def cheap(params):
        return rounded(jax.tree_util.tree_map(bf16, params))

    positions = {"weights": 0.1 * W, "bias": 0.1 * b}
    inv_mass = tree_ones_like(positions)
    step_sizes = jnp.full((C,), 2e-3, jnp.float32)
    keys = jax.random.split(jax.random.key(11), 8)

    def run(kernel):
        state = hmc.batched_init(positions, vag)

        def body(s, k):
            ns, info = kernel(k, s, step_sizes, inv_mass)
            return ns, info.acceptance_prob

        return jax.lax.scan(body, state, keys)

    k_std = hmc.build_batched_kernel(vag, num_integration_steps=4)
    k_lazy = hmc.build_batched_kernel(vag, num_integration_steps=4,
                                      grad_fn=vag)
    k_cheap = hmc.build_batched_kernel(vag, num_integration_steps=4,
                                       grad_fn=cheap)

    f_std, a_std = run(k_std)
    f_lazy, a_lazy = run(k_lazy)
    # same math, different program structure -> only refusion-level drift
    np.testing.assert_allclose(np.asarray(a_std), np.asarray(a_lazy),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(f_std.position["weights"]),
                               np.asarray(f_lazy.position["weights"]),
                               rtol=1e-4, atol=1e-5)

    f_cheap, a_cheap = run(k_cheap)
    assert not np.array_equal(np.asarray(f_cheap.position["weights"]),
                              np.asarray(f_std.position["weights"]))
    np.testing.assert_allclose(np.asarray(a_cheap), np.asarray(a_std),
                               atol=0.05)
    assert bool(jnp.all(jnp.isfinite(f_cheap.logdensity)))


def _whitened_problem(n, chains):
    X, Y, _, _ = _data(jax.random.key(20))
    X, Y = X[:n], Y[:n]
    model = Softmax(dim=D, n_classes=K, alpha=ALPHA)
    metric = softmax_gauss_newton_metric(X, K, alpha=ALPHA, augmented=True)
    kq = jax.random.split(jax.random.key(21))
    qmap = {"weights": 0.3 * jax.random.normal(kq[0], (D, K)),
            "bias": 0.1 * jax.random.normal(kq[1], (K,))}
    E = chip_smoke.laplace_draws(jax.random.key(22), chains, D, K)
    return model, metric, qmap, (X, Y), E


@pytest.mark.parametrize("chains", [1, 5])
@pytest.mark.parametrize("n", [256, 299])
def test_whitened_vag_matches_f32_reference(chains, n):
    """The main path's whitened batched value+grad against the plain float32
    reference, with chip_smoke's tolerances (0.1 nats per chain, 1e-3
    relative L2 gradient error per chain)."""
    model, metric, qmap, batch, E = _whitened_problem(n, chains)
    vag, grad_only = make_whitened_fused_vag(model, metric, qmap, batch)
    assert grad_only is None
    value, grad = jax.jit(vag)(E)
    assert value.shape == (chains,)
    assert grad["weights"].shape == (chains, D, K)
    ref = chip_smoke.reference_vag(model, metric, qmap)(E, batch)
    errs = chip_smoke.parity_errors(value, grad, *ref)
    assert chip_smoke.check_parity(*errs) == [], errs


@pytest.mark.gpu
def test_whitened_vag_matches_f32_reference_full_width():
    """Full MNIST width on the card: N=60000, D=784, K=10, 128 chains, the
    metric computed in the run."""
    model, metric, _, qmap, batch = chip_smoke.mnist_setup()
    E = chip_smoke.laplace_draws(jax.random.key(0), 128, 784, 10)
    vag = jax.jit(make_whitened_fused_vag(model, metric, qmap, batch)[0])
    ref = chip_smoke.reference_vag(model, metric, qmap)(E, batch)
    errs = chip_smoke.parity_errors(*vag(E), *ref)
    assert chip_smoke.check_parity(*errs) == [], errs

