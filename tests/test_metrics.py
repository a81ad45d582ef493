"""Metric tests: diagonal + Kronecker Gauss-Newton mass matrices are
self-consistent (momentum covariance == M, K(p) and dK/dp agree) and the GN
metric actually isotropizes a GLM posterior."""

import jax
import jax.numpy as jnp
import numpy as np

from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
    logistic_gauss_newton_metric,
    softmax_gauss_newton_metric,
)
from dropout_hamiltonian_montecarlo_tpu.ops.metrics import diagonal_metric
from dropout_hamiltonian_montecarlo_tpu.ops.tree import tree_dot


def _autodiff_kinetic_grad(metric, p):
    g = jax.grad(lambda q: metric.kinetic_energy(q))(p)
    return np.asarray(jax.flatten_util.ravel_pytree(g)[0])


def test_diagonal_metric_consistency():
    inv_mass = {"x": jnp.array([0.5, 2.0, 1.0])}
    m = diagonal_metric(inv_mass)
    p = {"x": jnp.array([1.0, -2.0, 3.0])}
    # K = 0.5 p^T M^-1 p
    expected = 0.5 * float(jnp.sum(inv_mass["x"] * p["x"] ** 2))
    assert np.isclose(float(m.kinetic_energy(p)), expected)
    kg = m.kinetic_grad(p)
    assert np.allclose(kg["x"], inv_mass["x"] * p["x"])


def test_softmax_gn_metric_consistency():
    key = jax.random.key(0)
    X = jax.random.normal(key, (50, 6))
    metric = softmax_gauss_newton_metric(np.asarray(X), n_classes=3, alpha=0.7)
    p = {"weights": jax.random.normal(key, (6, 3)),
         "bias": jax.random.normal(jax.random.fold_in(key, 1), (3,))}

    # kinetic grad == d/dp kinetic energy
    kg_flat, _ = jax.flatten_util.ravel_pytree(metric.kinetic_grad(p))
    fd = _autodiff_kinetic_grad(metric, p)
    assert np.allclose(np.asarray(kg_flat), fd, rtol=1e-2, atol=1e-2)

    # momentum covariance matches M: E[K(p)] = dim/2 for p ~ N(0, M)
    keys = jax.random.split(jax.random.key(2), 400)
    ks = jax.vmap(lambda k: metric.kinetic_energy(
        metric.sample_momentum(k, p)))(keys)
    dim = 6 * 3 + 3
    assert abs(float(ks.mean()) - dim / 2) < 0.15 * dim, float(ks.mean())


def test_logistic_gn_metric_consistency():
    key = jax.random.key(0)
    X = jax.random.normal(key, (40, 5))
    metric = logistic_gauss_newton_metric(np.asarray(X), alpha=0.5)
    p = {"weights": jax.random.normal(key, (5,)),
         "bias": jnp.float32(0.3)}
    kg_flat, _ = jax.flatten_util.ravel_pytree(metric.kinetic_grad(p))
    fd = _autodiff_kinetic_grad(metric, p)
    assert np.allclose(np.asarray(kg_flat), fd, rtol=1e-2, atol=1e-2)

    keys = jax.random.split(jax.random.key(2), 400)
    ks = jax.vmap(lambda k: metric.kinetic_energy(
        metric.sample_momentum(k, p)))(keys)
    dim = 6
    assert abs(float(ks.mean()) - dim / 2) < 0.2 * dim


def test_gn_metric_improves_hmc_mixing():
    """HMC with the GN metric on a softmax posterior should accept large steps
    (near-isotropic target) where the unit metric cannot."""
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    key = jax.random.key(0)
    n, d, k = 2000, 8, 3
    X = jax.random.normal(key, (n, d))
    yi = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, k)
    y = one_hot(yi, k)
    model = Softmax(dim=d, n_classes=k, alpha=1.0)
    logdensity = model.make_logdensity(batch=(X, y))
    metric = softmax_gauss_newton_metric(np.asarray(X), k, alpha=1.0)

    kernel = hmc.build_kernel(logdensity, 8, metric=metric)
    state = hmc.init(model.init_params(key), logdensity)
    inv_mass = jax.tree_util.tree_map(jnp.ones_like, state.position)

    accepts = []
    for i in range(20):
        state, info = kernel(jax.random.key(i), state, jnp.float32(0.5),
                             inv_mass)
        accepts.append(float(info.acceptance_prob))
    # unit-metric HMC at eps=0.5 on n=2000 data would reject everything;
    # the GN metric makes eps=0.5 cheap
    assert np.mean(accepts) > 0.5, np.mean(accepts)


def test_whitened_gauge_gibbs_exact_update():
    """make_whitened_gauge_gibbs: the analytic logdensity/grad updates must
    match a full recomputation at the moved position (the move is along the
    EXACTLY likelihood-flat softmax gauge subspace), and non-gauge whitened
    coordinates must be untouched."""
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        make_whitened_gauge_gibbs,
        natural_gradient_map,
    )
    from dropout_hamiltonian_montecarlo_tpu.ops.tree import tree_add
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    key = jax.random.key(0)
    n, d, k, chains = 400, 12, 4, 3
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (n, d))
    yi = jnp.argmax(X @ jax.random.normal(kw, (d, k)), -1)
    Y = one_hot(yi, k)
    model = Softmax(dim=d, n_classes=k, alpha=0.8)
    logdensity = model.make_logdensity(batch=(X, Y))

    metric0 = softmax_gauss_newton_metric(X, k, alpha=0.8)
    qmap = natural_gradient_map(logdensity, metric0,
                                model.init_params(key), num_steps=40)
    probs = model.predict(qmap, X, prob=True)
    metric, aux = softmax_gauss_newton_metric(X, k, alpha=0.8, probs=probs,
                                              return_aux=True)

    def logdensity_e(e):
        return logdensity(tree_add(qmap, metric.unwhiten(e)))

    batched_vag = jax.vmap(jax.value_and_grad(logdensity_e))
    e0 = {
        "weights": 0.5 * jax.random.normal(jax.random.key(1), (chains, d, k)),
        "bias": 0.5 * jax.random.normal(jax.random.key(2), (chains, k)),
    }
    state = hmc.batched_init(e0, batched_vag)

    gibbs = make_whitened_gauge_gibbs(metric, aux, qmap)
    new = gibbs(jax.random.key(3), state)

    j0 = int(np.argmin(np.asarray(aux["s_a"])))
    # non-gauge coordinates untouched
    mask = np.ones(k, bool); mask[j0] = False
    np.testing.assert_array_equal(
        np.asarray(new.position["weights"])[:, :, mask],
        np.asarray(e0["weights"])[:, :, mask])
    # the gauge coordinates actually moved
    assert float(jnp.abs(new.position["weights"][:, :, j0]
                         - e0["weights"][:, :, j0]).max()) > 1e-3

    # analytic value/grad == recomputation at the moved position
    val_ref, grad_ref = batched_vag(new.position)
    np.testing.assert_allclose(np.asarray(new.logdensity),
                               np.asarray(val_ref), rtol=2e-5, atol=5e-3)
    for leaf, ref in ((new.logdensity_grad["weights"], grad_ref["weights"]),
                      (new.logdensity_grad["bias"], grad_ref["bias"])):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref),
                                   rtol=1e-3, atol=2e-3)

    # the move preserves the target: MH-style check — since the conditional
    # is exact, logp(new) - logp(old) must equal the analytic delta
    val_old, _ = batched_vag(e0)
    np.testing.assert_allclose(
        np.asarray(new.logdensity - val_old),
        np.asarray(val_ref - val_old), rtol=2e-5, atol=5e-3)


def test_augmented_metric_whitens_positive_feature_softmax():
    """augmented=True (VERDICT r2 item 4, the min-ESS mechanism): for
    all-positive features the top Gram direction is quasi-constant across
    examples and aliases the bias; the separate-blocks Kronecker metric
    cannot represent that weights<->bias cross-block curvature and
    overestimates the soft difference direction's mass by orders of
    magnitude.  Test: the EXACT posterior Hessian at the MAP, pulled back
    through unwhiten, must be ~identity under the augmented-feature metric —
    and must have a far-out eigenvalue under the block one."""
    import jax.flatten_util
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        gram_eigh,
        gram_eigh_augmented,
        natural_gradient_map,
    )
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    key = jax.random.key(0)
    n, d, k = 600, 8, 3
    # all-positive features with a large shared mean -> quasi-constant top
    # Gram direction (the MNIST pixel situation)
    X = 1.0 + 0.3 * jnp.abs(jax.random.normal(key, (n, d)))
    yi = jax.random.randint(jax.random.key(1), (n,), 0, k)
    Y = one_hot(yi, k)
    model = Softmax(dim=d, n_classes=k, alpha=0.5)
    logdensity = model.make_logdensity(batch=(X, Y))

    def build(augmented):
        gram = (gram_eigh_augmented(X) if augmented else gram_eigh(X))
        m0 = softmax_gauss_newton_metric(X, k, alpha=0.5, gram=gram,
                                         augmented=augmented)
        qmap = natural_gradient_map(logdensity, m0,
                                    model.init_params(key), num_steps=60)
        probs = model.predict(qmap, X, prob=True)
        return softmax_gauss_newton_metric(X, k, alpha=0.5, gram=gram,
                                           probs=probs,
                                           augmented=augmented), qmap

    def whitened_hessian_eigs(metric, qmap):
        e0 = metric.whiten(qmap)
        flat, unravel = jax.flatten_util.ravel_pytree(e0)

        def ld_e(ef):
            q = metric.unwhiten(unravel(ef))
            return logdensity(q)

        H = jax.hessian(ld_e)(flat)
        return np.linalg.eigvalsh(-np.asarray(H))

    m_c, qmap_c = build(True)
    eig_c = whitened_hessian_eigs(m_c, qmap_c)
    # augmented: every whitened curvature within a small factor of 1
    assert eig_c.min() > 0.2 and eig_c.max() < 5.0, (eig_c.min(), eig_c.max())

    m_u, qmap_u = build(False)
    eig_u = whitened_hessian_eigs(m_u, qmap_u)
    # separate blocks: the aliased soft direction shows up as a tiny
    # whitened curvature (mass overestimated)
    assert eig_u.min() < 0.05, eig_u.min()

    # transform consistency: unwhiten(whiten(x)) == x, kinetic_grad is the
    # gradient of kinetic_energy, through the P-wrapped maps
    p = {"weights": jax.random.normal(jax.random.key(2), (d, k)),
         "bias": jax.random.normal(jax.random.key(3), (k,))}
    rt = m_c.unwhiten(m_c.whiten(p))
    # rtol covers accelerator matmul rounding through the ill-conditioned
    # sqrt_d scaling (exact-ish on the CPU backend)
    np.testing.assert_allclose(np.asarray(rt["weights"]),
                               np.asarray(p["weights"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rt["bias"]),
                               np.asarray(p["bias"]), rtol=1e-3, atol=1e-4)
    kg = m_c.kinetic_grad(p)
    kg_ad = jax.grad(lambda q: m_c.kinetic_energy(q))(p)
    np.testing.assert_allclose(np.asarray(kg["weights"]),
                               np.asarray(kg_ad["weights"]),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(kg["bias"]),
                               np.asarray(kg_ad["bias"]), rtol=1e-3, atol=1e-4)


def test_cached_gn_setup_roundtrip(tmp_path):
    """cached_gn_setup: second call is a cache hit and reproduces the same
    metric (whitening map) and MAP (VERDICT r3 weak #5 — amortized setup
    collapses to an npz load)."""
    import numpy as np
    from dropout_hamiltonian_montecarlo_tpu.io import datasets
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        cached_gn_setup,
    )
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    X, yi = datasets.digits()
    y = one_hot(yi, 10)
    model = Softmax(dim=X.shape[1], n_classes=10, alpha=1.0)

    m1, aux1, q1, hit1 = cached_gn_setup(
        X, y, model, alpha=1.0, newton_steps=20, cache_dir=str(tmp_path),
        provenance="digits-test")
    m2, aux2, q2, hit2 = cached_gn_setup(
        X, y, model, alpha=1.0, newton_steps=20, cache_dir=str(tmp_path),
        provenance="digits-test")
    assert not hit1 and hit2
    np.testing.assert_allclose(np.asarray(q1["weights"]),
                               np.asarray(q2["weights"]), rtol=1e-6)
    probe = {"weights": jnp.ones((X.shape[1], 10)), "bias": jnp.ones((10,))}
    w1, w2 = m1.whiten(probe), m2.whiten(probe)
    np.testing.assert_allclose(np.asarray(w1["weights"]),
                               np.asarray(w2["weights"]), rtol=1e-5)
    # a different alpha keys a different cache entry
    _, _, _, hit3 = cached_gn_setup(
        X, y, model, alpha=2.0, newton_steps=20, cache_dir=str(tmp_path),
        provenance="digits-test")
    assert not hit3


def test_whitened_gauge_gibbs_per_chain_keys():
    """The (C,) per-chain-key mode (the sharded post_step path) must keep
    the exact analytic value/grad property, and each chain's draw must
    depend only on its own key — permuting the keys permutes the draws."""
    from dropout_hamiltonian_montecarlo_tpu.models import Softmax
    from dropout_hamiltonian_montecarlo_tpu.ops.kron_metric import (
        make_whitened_gauge_gibbs,
        natural_gradient_map,
    )
    from dropout_hamiltonian_montecarlo_tpu.ops.tree import tree_add
    from dropout_hamiltonian_montecarlo_tpu.inference import hmc
    from dropout_hamiltonian_montecarlo_tpu.utils import one_hot

    key = jax.random.key(0)
    n, d, k, chains = 200, 8, 3, 4
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (n, d))
    yi = jnp.argmax(X @ jax.random.normal(kw, (d, k)), -1)
    Y = one_hot(yi, k)
    model = Softmax(dim=d, n_classes=k, alpha=0.8)
    logdensity = model.make_logdensity(batch=(X, Y))

    metric0 = softmax_gauss_newton_metric(X, k, alpha=0.8)
    qmap = natural_gradient_map(logdensity, metric0,
                                model.init_params(key), num_steps=30)
    probs = model.predict(qmap, X, prob=True)
    metric, aux = softmax_gauss_newton_metric(X, k, alpha=0.8, probs=probs,
                                              return_aux=True)

    def logdensity_e(e):
        return logdensity(tree_add(qmap, metric.unwhiten(e)))

    batched_vag = jax.vmap(jax.value_and_grad(logdensity_e))
    e0 = {
        "weights": 0.5 * jax.random.normal(jax.random.key(1), (chains, d, k)),
        "bias": 0.5 * jax.random.normal(jax.random.key(2), (chains, k)),
    }
    state = hmc.batched_init(e0, batched_vag)
    gibbs = make_whitened_gauge_gibbs(metric, aux, qmap)

    keys = jax.random.split(jax.random.key(3), chains)
    new = gibbs(keys, state)
    # exact analytic value/grad at the moved position
    val_ref, grad_ref = batched_vag(new.position)
    np.testing.assert_allclose(np.asarray(new.logdensity),
                               np.asarray(val_ref), rtol=1e-4, atol=1e-2)
    for a, b in zip(jax.tree_util.tree_leaves(new.logdensity_grad),
                    jax.tree_util.tree_leaves(grad_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=5e-3)

    # per-chain streams: reversing the key order reverses the gauge draws
    rev = gibbs(keys[::-1], state)
    j0 = int(np.argmin(np.asarray(aux["s_a"])))
    np.testing.assert_allclose(
        np.asarray(rev.position["weights"])[::-1, :, j0],
        np.asarray(new.position["weights"])[:, :, j0],
        rtol=0, atol=1e-6)
