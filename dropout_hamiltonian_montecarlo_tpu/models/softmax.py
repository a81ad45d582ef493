"""Bayesian softmax (multinomial logistic) regression — the MNIST workhorse.

Capability parity with /root/reference/hamiltonian/models/cpu/softmax.py
(logsumexp cross-entropy :17-20, stable softmax :32-36, analytic grad :45-61,
predict :82-89, MC-dropout predict_stochastic :91-100).  The (X @ W) GEMM is
the hot op: under vmap over chains XLA batches it into one large matmul
(X shared, W stacked), which replaces the reference's per-chain
multiprocessing.

Params: {'weights': (D,K), 'bias': (K,)} ; batch: (X[B,D], y[B,K] one-hot).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .base import Model


class Softmax(Model):
    def __init__(self, dim: int, n_classes: int, alpha: float = 1e-2):
        self.dim = dim
        self.n_classes = n_classes
        self.alpha = jnp.float32(alpha)

    def log_prior(self, params):
        k = sum(p.size for p in jax.tree_util.tree_leaves(params))
        sq = sum(jnp.sum(p * p) for p in jax.tree_util.tree_leaves(params))
        return 0.5 * k * jnp.log(self.alpha / (2.0 * jnp.pi)) - 0.5 * self.alpha * sq

    def logits(self, params, X):
        return X @ params["weights"] + params["bias"]

    def log_likelihood(self, params, batch):
        X, y = batch
        z = self.logits(params, X)
        logp = z - jax.scipy.special.logsumexp(z, axis=-1, keepdims=True)
        return jnp.sum(y * logp)

    def init_params(self, key):
        kw, _ = jax.random.split(key)
        return {
            "weights": 1e-2
            * jax.random.normal(kw, (self.dim, self.n_classes), jnp.float32),
            "bias": jnp.zeros((self.n_classes,), jnp.float32),
        }

    def predict(self, params, X, prob: bool = False):
        p = jax.nn.softmax(self.logits(params, X), axis=-1)
        return p if prob else jnp.argmax(p, axis=-1)

    def predict_stochastic(self, params, X, key, p_drop: float = 0.5,
                           prob: bool = False):
        """MC-dropout prediction: Bernoulli(1-p_drop) mask over input features,
        fresh per call — reference cpu/softmax.py:91-100 (keep-prob semantics:
        the reference passes p as the Binomial keep probability)."""
        mask = jax.random.bernoulli(key, 1.0 - p_drop, X.shape).astype(X.dtype)
        return self.predict(params, X * mask, prob=prob)

    def analytic_grad(self, params, batch):
        """Closed-form grad of the log posterior (golden test vs jax.grad);
        reference form at /root/reference/hamiltonian/models/cpu/softmax.py:45-61."""
        X, y = batch
        resid = y - jax.nn.softmax(self.logits(params, X), axis=-1)
        return {
            "weights": X.T @ resid - self.alpha * params["weights"],
            "bias": jnp.sum(resid, axis=0) - self.alpha * params["bias"],
        }
