"""Kronecker-factored Gauss-Newton metric for GLM posteriors.

The mixing bottleneck for Bayesian softmax/logistic regression at large n is
posterior conditioning: cov^-1 ~ X^T D X (x) Fisher_class + alpha*I spans many
orders of magnitude (pixel-scale spread plus the soft class-mean direction the
prior barely constrains).  A diagonal mass matrix cannot fix cross-coordinate
correlation, so HMC needs O(condition) leapfrog steps per effective sample
(measured: median ESS 31 of 8000 draws on MNIST softmax, bench @ 12 ESS/s).

This module builds the EXACT Gauss-Newton mass matrix in closed form.  With
F = X^T X = U_F S_F U_F^T  (D x D eigendecomposition, done once on host) and
A = Fisher of the uniform categorical = I/K - 11^T/K^2 = U_A S_A U_A^T,

    M_W = (U_F (x) U_A) diag(S_F (x) S_A + alpha) (U_F (x) U_A)^T

— the +alpha*I prior term is diagonal in ANY orthonormal basis, so the
Kronecker eigenbasis diagonalizes the full Gauss-Newton Hessian exactly.
Sampling momenta / kinetic gradients cost two (D x D)@(D x K) and (D x K)@
(K x K) matmuls — noise vs the data GEMM.  Under this metric the GLM
posterior is near-isotropic and HMC mixes in a handful of steps.

The metric is position-independent (a constant mass matrix), so plain HMC
remains exactly valid — no Riemannian correction terms needed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from .metrics import Metric
from .tree import tree_randn_like

Params = Any


def gram_eigh(X):
    """Eigendecomposition of the Gram matrix X^T X.

    The (n, D) @ (D, n) GEMM runs on the accelerator; only the (D, D) result
    crosses to the host.  Returns host (s_f, U_f), float64.
    """
    F = np.asarray(jnp.matmul(jnp.asarray(X).T, jnp.asarray(X),
                              preferred_element_type=jnp.float32), np.float64)
    s_f, U_f = np.linalg.eigh(F)
    return np.maximum(s_f, 0.0), U_f


def gram_eigh_augmented(X):
    """Eigendecomposition of the AUGMENTED Gram [X, 1]^T [X, 1] =
    [[X^T X, n xbar], [n xbar^T, n]] — the feature factor of the exact
    Gauss-Newton metric with the bias treated as the constant feature's
    weight (softmax_gauss_newton_metric(augmented=True)).  Returns host
    (s_g, U_g) of shape ((D+1,), (D+1, D+1)), float64."""
    Xd = jnp.asarray(X)
    n = Xd.shape[0]
    F = np.asarray(jnp.matmul(Xd.T, Xd,
                              preferred_element_type=jnp.float32), np.float64)
    xbar_n = np.asarray(jnp.sum(Xd, axis=0), np.float64)    # n * xbar
    G = np.block([[F, xbar_n[:, None]], [xbar_n[None, :], np.array([[float(n)]])]])
    s_g, U_g = np.linalg.eigh(G)
    return np.maximum(s_g, 0.0), U_g


def softmax_gauss_newton_metric(
    X,
    n_classes: int,
    alpha: float,
    likelihood_scale: float = 1.0,
    probs=None,
    gram=None,
    return_aux: bool = False,
    augmented: bool = False,
    fisher=None,
):
    """Metric for params {'weights': (D, K), 'bias': (K,)}.

    likelihood_scale rescales the data term (use data_size/batch_size when the
    log density is a scaled minibatch estimator).

    probs: optional (n, K) predicted class probabilities (e.g. at the MAP).
    The class factor A becomes the empirical mean Fisher
    mean_i[diag(p_i) - p_i p_i^T] (K-FAC), which tracks the true curvature at
    the expansion point; default is the uniform-categorical Fisher
    I/K - 11^T/K^2 — exact only when predictions are maximally uncertain.

    gram: optional precomputed (s_f, U_f) from gram_eigh(X) so a two-stage
    build (uniform metric -> MAP -> refreshed metric at MAP probs) pays for
    the D x D eigendecomposition once.  With augmented=True pass
    gram_eigh_augmented(X) instead.

    return_aux=True: returns (metric, aux) where aux carries the spectral
    pieces {s_f, s_a, d_w, d_b} (host numpy / device arrays) — needed by
    make_whitened_gauge_gibbs and by diagnostics that map slow coordinates
    back to curvature.

    augmented=True: treat the bias as the weight of a CONSTANT feature and
    build the Kronecker metric over the (D+1)-dim augmented feature space
    [x, 1]: M = A (x) G_aug + alpha I with G_aug = [X,1]^T [X,1].  This is
    the EXACT Gauss-Newton-plus-prior metric — the prior is isotropic in
    augmented coordinates (alpha ||W||^2 + alpha ||b||^2 = alpha
    ||W_aug||^2), so unlike separate weight/bias blocks there is NO
    factorization error across the weights<->bias boundary.  That boundary
    is where the un-augmented metric fails on all-positive pixel data: the
    top Gram eigendirection u has X u ~ const across examples, so the
    weight direction u (x) a aliases the bias direction a — only their sum
    is data-identified, and the block-diagonal metric overestimates the
    soft difference direction's curvature ~350x (measured whitened std
    17-19 on exactly those coordinates — the entire min-ESS tail of the
    headline bench).  The augmented eigenbasis represents the aliasing
    exactly.  Whitened coordinates keep the {'weights','bias'} pytree
    structure (rows 0..D-1 and row D of the augmented eigen array), so all
    downstream drivers are unchanged.
    """
    if augmented:
        return _augmented_gn_metric(X, n_classes, alpha, likelihood_scale,
                                    probs, gram, return_aux, fisher)
    n, d = X.shape
    k = n_classes

    s_f, U_f = gram if gram is not None else gram_eigh(X)

    if probs is None:
        A = np.eye(k) / k - np.ones((k, k)) / (k * k)
    else:
        # mean Fisher on the device (P may be a device array; only the
        # (K, K) result crosses to host)
        P = jnp.asarray(probs)
        A_dev = jnp.diag(jnp.mean(P, 0)) - (P.T @ P) / P.shape[0]
        A = np.asarray(A_dev, np.float64)
    s_a, U_a = np.linalg.eigh(A)
    s_a = np.maximum(s_a, 0.0)

    c = likelihood_scale
    U_f = jnp.asarray(U_f, jnp.float32)
    U_a = jnp.asarray(U_a, jnp.float32)
    # eigenvalue core of the mass matrix (curvature): data + prior
    d_w = jnp.asarray(
        c * np.outer(s_f, s_a) + alpha, jnp.float32
    )                                    # (D, K)
    d_b = jnp.asarray(c * n * s_a + alpha, jnp.float32)   # (K,)

    def to_eigen(p):
        return {
            "weights": U_f.T @ p["weights"] @ U_a,
            "bias": p["bias"] @ U_a,
        }

    def from_eigen(e):
        return {
            "weights": U_f @ e["weights"] @ U_a.T,
            "bias": e["bias"] @ U_a.T,
        }

    def sample_momentum(key, position):
        eps = tree_randn_like(key, position)
        scaled = {
            "weights": jnp.sqrt(d_w) * eps["weights"],
            "bias": jnp.sqrt(d_b) * eps["bias"],
        }
        return from_eigen(scaled)

    def kinetic_energy(momentum):
        e = to_eigen(momentum)
        return 0.5 * (
            jnp.sum(e["weights"] ** 2 / d_w) + jnp.sum(e["bias"] ** 2 / d_b)
        )

    def kinetic_grad(momentum):
        e = to_eigen(momentum)
        return from_eigen({
            "weights": e["weights"] / d_w,
            "bias": e["bias"] / d_b,
        })

    def sample_position(key, mean):
        """q ~ N(mean, M^-1): a Laplace-approximation posterior draw when
        ``mean`` is the MAP — chain initialization inside the typical set."""
        eps = tree_randn_like(key, mean)
        delta = from_eigen({
            "weights": eps["weights"] / jnp.sqrt(d_w),
            "bias": eps["bias"] / jnp.sqrt(d_b),
        })
        return {
            "weights": mean["weights"] + delta["weights"],
            "bias": mean["bias"] + delta["bias"],
        }

    def whiten(dq):
        """e = M^{1/2} dq (eigen coordinates, unit posterior scale)."""
        e = to_eigen(dq)
        return {
            "weights": jnp.sqrt(d_w) * e["weights"],
            "bias": jnp.sqrt(d_b) * e["bias"],
        }

    def unwhiten(e):
        """dq = M^{-1/2} e."""
        return from_eigen({
            "weights": e["weights"] / jnp.sqrt(d_w),
            "bias": e["bias"] / jnp.sqrt(d_b),
        })

    metric = Metric(sample_momentum, kinetic_energy, kinetic_grad,
                    sample_position, whiten, unwhiten)
    if return_aux:
        return metric, {"s_f": s_f, "s_a": s_a, "d_w": d_w,
                        "d_b": d_b, "alpha": float(alpha)}
    return metric


def _class_fisher_eigh(n_classes, probs):
    k = n_classes
    if probs is None:
        A = np.eye(k) / k - np.ones((k, k)) / (k * k)
    else:
        P = jnp.asarray(probs)
        A_dev = jnp.diag(jnp.mean(P, 0)) - (P.T @ P) / P.shape[0]
        A = np.asarray(A_dev, np.float64)
    s_a, U_a = np.linalg.eigh(A)
    return np.maximum(s_a, 0.0), U_a


def _augmented_gn_metric(X, n_classes, alpha, likelihood_scale, probs, gram,
                         return_aux, fisher=None):
    """See softmax_gauss_newton_metric(augmented=True).  ``fisher``:
    optional precomputed (s_a, U_a) class-Fisher eigendecomposition (the
    disk-cache path, cached_gn_setup) — takes precedence over ``probs``."""
    s_g, U_g = gram if gram is not None else gram_eigh_augmented(X)
    if fisher is not None:
        s_a, U_a = fisher
    else:
        s_a, U_a = _class_fisher_eigh(n_classes, probs)

    c = likelihood_scale
    U_g = jnp.asarray(U_g, jnp.float32)      # (D+1, D+1)
    U_a = jnp.asarray(U_a, jnp.float32)      # (K, K)
    d_aug = jnp.asarray(c * np.outer(s_g, s_a) + alpha, jnp.float32)  # (D+1,K)
    sqrt_d = jnp.sqrt(d_aug)

    def pack(p):
        return jnp.concatenate([p["weights"], p["bias"][None, :]], axis=0)

    def unpack(wa):
        return {"weights": wa[:-1], "bias": wa[-1]}

    def to_eigen(p):
        return U_g.T @ pack(p) @ U_a

    def from_eigen(e):
        return unpack(U_g @ e @ U_a.T)

    def sample_momentum(key, position):
        eps = jax.random.normal(key, d_aug.shape, jnp.float32)
        return from_eigen(sqrt_d * eps)

    def kinetic_energy(momentum):
        e = to_eigen(momentum)
        return 0.5 * jnp.sum(e * e / d_aug)

    def kinetic_grad(momentum):
        return from_eigen(to_eigen(momentum) / d_aug)

    def sample_position(key, mean):
        eps = jax.random.normal(key, d_aug.shape, jnp.float32)
        delta = from_eigen(eps / sqrt_d)
        return {"weights": mean["weights"] + delta["weights"],
                "bias": mean["bias"] + delta["bias"]}

    def whiten(dq):
        e = sqrt_d * to_eigen(dq)
        return unpack(e)

    def unwhiten(e):
        return from_eigen(pack(e) / sqrt_d)

    metric = Metric(sample_momentum, kinetic_energy, kinetic_grad,
                    sample_position, whiten, unwhiten)
    if return_aux:
        return metric, {"s_f": s_g[:-1], "s_g": s_g, "s_a": s_a,
                        "d_w": d_aug[:-1], "d_b": d_aug[-1],
                        "alpha": float(alpha), "augmented": True}
    return metric


def make_whitened_gauge_gibbs(metric: Metric, aux, qmap):
    """Exact Gibbs resampler for the softmax GAUGE subspace, in the metric's
    whitened coordinates.

    The softmax likelihood is exactly invariant under uniform logit shifts
    W += v 1_K^T, b += beta 1_K (for any v in R^D): every row of the logits
    moves by the same constant, which softmax normalizes away.  In the
    Kronecker eigenbasis that (D+1)-dimensional subspace is the class-Fisher
    null column j0 = argmin s_a (A 1 = p_bar - P^T P 1 / n = 0 exactly), so
    the posterior conditional of those whitened coordinates is pure prior —
    Gaussian, INDEPENDENT of every other coordinate:

        e_(i,j0) ~ N(-whiten(qmap)_(i,j0), d_w(i,j0)/alpha)

    (the variance is ~1 up to the numerically-zero null eigenvalue).
    Resampling them i.i.d. each draw is an exact Gibbs move: it drives their
    ESS to the draw-count cap, where plain HMC leaves them as the slowest
    directions in the posterior (prior-dominated, likelihood-blind — the
    min-ESS tail of the headline bench).  The density is separable across
    the gauge block, so the state's cached logdensity/grad are updated
    ANALYTICALLY — no extra dataset pass.

    Returns gibbs(key, state) -> state for chain-batched whitened HMCState
    (position/grad leaves (C, D, K) and (C, K), logdensity (C,)).
    """
    alpha_w = np.asarray(aux["d_w"])  # (D, K)
    s_a = np.asarray(aux["s_a"])
    j0 = int(np.argmin(s_a))
    # conditional scale sqrt(d/alpha): ~1 + O(s_f * s_a_null / alpha)
    d_col = jnp.asarray(alpha_w[:, j0], jnp.float32)            # (D,)
    alpha = float(aux["alpha"])
    sig_w = jnp.sqrt(d_col / alpha)                             # (D,)
    d_b0 = float(np.asarray(aux["d_b"])[j0])
    sig_b = jnp.float32(np.sqrt(d_b0 / alpha))

    wq = metric.whiten(qmap)
    m_w = -wq["weights"][:, j0]                                 # (D,)
    m_b = -wq["bias"][j0]                                       # ()

    def gibbs(key, state):
        e = state.position
        g = state.logdensity_grad
        c = e["bias"].shape[0]
        if jnp.ndim(key) == 0:
            kw, kb = jax.random.split(key)
            eps_w = jax.random.normal(kw, (c, m_w.shape[0]), jnp.float32)
            eps_b = jax.random.normal(kb, (c,), jnp.float32)
        else:
            # (C,) per-chain keys (the sharded path): each chain's stream
            # depends only on its own key, so the Gibbs draws are
            # independent of how the chain axis is blocked across devices
            # (the single-key form draws a (C, D) block whose content
            # shifts with the block size)
            def draw(k):
                kw, kb = jax.random.split(k)
                return (jax.random.normal(kw, (m_w.shape[0],), jnp.float32),
                        jax.random.normal(kb, (), jnp.float32))

            eps_w, eps_b = jax.vmap(draw)(key)

        old_w = e["weights"][:, :, j0]                          # (C, D)
        old_b = e["bias"][:, j0]                                # (C,)
        zold_w = (old_w - m_w[None]) / sig_w[None]
        zold_b = (old_b - m_b) / sig_b
        new_w = m_w[None] + sig_w[None] * eps_w
        new_b = m_b + sig_b * eps_b

        # log N(e; m, sig^2) difference, dropping the shared normalizer
        delta = -0.5 * (
            jnp.sum(eps_w**2 - zold_w**2, axis=-1) + eps_b**2 - zold_b**2
        )
        position = {
            "weights": e["weights"].at[:, :, j0].set(new_w),
            "bias": e["bias"].at[:, j0].set(new_b),
        }
        # d logp / d e = -(e - m)/sig^2 at the gauge coords, others unchanged
        grad = {
            "weights": g["weights"].at[:, :, j0].set(
                -eps_w / sig_w[None]),
            "bias": g["bias"].at[:, j0].set(-eps_b / sig_b),
        }
        return state._replace(position=position,
                              logdensity=state.logdensity + delta,
                              logdensity_grad=grad)

    return gibbs


def cached_gn_setup(X, y_onehot, model, alpha: float,
                    newton_steps: int = 60, cache_dir=None,
                    provenance: str = "", n_classes: int = 10,
                    seed: int = 0):
    """Disk-cached end-to-end metric setup for the softmax posterior:
    augmented Gram eigh -> uniform-Fisher Newton MAP -> MAP-probs class
    Fisher eigh -> final augmented Gauss-Newton metric.

    The uncached pipeline is the bench's amortized setup (host Gram eigh +
    Newton MAP compile and run); the artifacts are tiny ((D+1)^2 f64
    eigenbasis ~5 MB at MNIST scale, (K,K) Fisher, (D+1,K) MAP), so they are
    cached under ``cache_dir`` keyed by a sha256 of (provenance, shapes,
    cheap device-side moments, alpha, newton_steps) — the fingerprint needs
    no large device->host transfer.

    Returns (metric, aux, qmap, from_cache)."""
    import hashlib
    import os

    fp = (provenance, tuple(int(s) for s in X.shape),
          tuple(int(s) for s in y_onehot.shape),
          float(jnp.sum(X)), float(jnp.sum(X * X)),
          float(jnp.sum(y_onehot * jnp.arange(y_onehot.shape[1]))),
          float(alpha), int(newton_steps), int(seed))
    h = hashlib.sha256(repr(fp).encode()).hexdigest()[:16]
    path = (os.path.join(cache_dir, f"kron_setup_{h}.npz")
            if cache_dir else None)

    if path is not None and os.path.exists(path):
        z = np.load(path)
        gram = (z["s_g"], z["U_g"])
        fisher = (z["s_a"], z["U_a"])
        qmap = {"weights": jnp.asarray(z["qw"]),
                "bias": jnp.asarray(z["qb"])}
        metric, aux = softmax_gauss_newton_metric(
            X, n_classes, alpha=alpha, gram=gram, fisher=fisher,
            return_aux=True, augmented=True)
        return metric, aux, qmap, True

    gram = gram_eigh_augmented(X)
    metric0 = softmax_gauss_newton_metric(X, n_classes, alpha=alpha,
                                          gram=gram, augmented=True)
    # the dataset is an argument, not a closure: a closed-over array is
    # embedded in the compiled program as a constant (N*D floats), which
    # makes compiling and caching the program far slower
    @jax.jit
    def map_stage(key, batch):
        logdensity = model.make_logdensity(batch=batch)
        q0 = model.init_params(key)
        qmap = natural_gradient_map(logdensity, metric0, q0,
                                    num_steps=newton_steps)
        return qmap, model.predict(qmap, batch[0], prob=True)

    qmap, probs = map_stage(jax.random.key(seed), (X, y_onehot))
    jax.block_until_ready(qmap)
    fisher = _class_fisher_eigh(n_classes, probs)
    metric, aux = softmax_gauss_newton_metric(
        X, n_classes, alpha=alpha, gram=gram, fisher=fisher,
        return_aux=True, augmented=True)
    if path is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, s_g=gram[0], U_g=gram[1],
                         s_a=fisher[0], U_a=fisher[1],
                         qw=np.asarray(qmap["weights"]),
                         qb=np.asarray(qmap["bias"]))
            os.replace(tmp, path)
        except OSError:
            pass
    return metric, aux, qmap, False


def make_whitened_fused_vag(model, metric: Metric, qmap, batch):
    """Chain-batched value+grad of the WHITENED log posterior
    e -> logpost(qmap + unwhiten(e)) — the composition every whitened
    driver needs (bench.py, the mnist-nuts CLI, scripts/probe_nuts.py share
    this single definition).

    Plain vmapped autodiff: XLA turns the chain axis into one (N, D) @
    (D, C*K) product for the logits and one transposed product for the
    gradient.  Returns (batched_vag, batched_grad); ``batched_grad`` is a
    cheaper grad-only function for hmc.build_batched_kernel's lazy-value
    trajectories, None until one exists (the full value+grad serves)."""
    from .tree import tree_add

    logdensity = model.make_logdensity(batch=batch)

    def logdensity_e(e):
        return logdensity(tree_add(qmap, metric.unwhiten(e)))

    return jax.vmap(jax.value_and_grad(logdensity_e)), None


def natural_gradient_map(logdensity_fn, metric: Metric, init_params,
                         num_steps: int = 50, learning_rate: float = 1.0):
    """MAP estimation by natural-gradient ascent: q += lr * M^-1 grad.

    With M the Gauss-Newton Hessian this is Newton's method for GLMs —
    converges in a handful of full-batch steps; used to start HMC warmup
    inside the typical set (starting at W=0 puts chains hundreds of
    Mahalanobis-sigmas from the posterior; dual averaging collapses during
    that transient)."""
    import jax as _jax

    grad_fn = _jax.grad(logdensity_fn)

    def body(q, _):
        nat = metric.kinetic_grad(grad_fn(q))   # M^-1 grad
        q = _jax.tree_util.tree_map(
            lambda x, g: x + learning_rate * g, q, nat)
        return q, None

    q, _ = _jax.lax.scan(body, init_params, None, length=num_steps)
    return q


def logistic_gauss_newton_metric(X, alpha: float,
                                 likelihood_scale: float = 1.0) -> Metric:
    """Same idea for logistic regression params {'weights': (D,), 'bias': ()}:
    H ~ 0.25 * X^T X + alpha I (0.25 = max Bernoulli variance)."""
    Xn = np.asarray(X, np.float64)
    n, d = Xn.shape
    F = 0.25 * (Xn.T @ Xn)
    s_f, U_f = np.linalg.eigh(F)
    s_f = np.maximum(s_f, 0.0)
    U_f = jnp.asarray(U_f, jnp.float32)
    d_w = jnp.asarray(likelihood_scale * s_f + alpha, jnp.float32)
    d_b = jnp.asarray(likelihood_scale * 0.25 * n + alpha, jnp.float32)

    def sample_momentum(key, position):
        eps = tree_randn_like(key, position)
        return {
            "weights": U_f @ (jnp.sqrt(d_w) * eps["weights"]),
            "bias": jnp.sqrt(d_b) * eps["bias"],
        }

    def kinetic_energy(momentum):
        e = U_f.T @ momentum["weights"]
        return 0.5 * (jnp.sum(e * e / d_w) + momentum["bias"] ** 2 / d_b)

    def kinetic_grad(momentum):
        e = U_f.T @ momentum["weights"]
        return {
            "weights": U_f @ (e / d_w),
            "bias": momentum["bias"] / d_b,
        }

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)
