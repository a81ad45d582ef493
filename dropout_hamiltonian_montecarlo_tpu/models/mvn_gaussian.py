"""Multivariate normal density target.

Capability parity with /root/reference/hamiltonian/models/cpu/mvn_gaussian.py:14-31
(the HMC-vs-Metropolis demo target behind hmc_mvn.png / mh_mvn.png).  The
reference recomputes inv(cov) and logdet per call; here the Cholesky factor is
precomputed once at construction so the per-step cost is one triangular solve —
a batched matmul-shaped op under vmap over chains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Model


class MVNGaussian(Model):
    """Target N(mu, cov) over params['x']; exact moments known for tests."""

    def __init__(self, mu, cov):
        self.mu = jnp.asarray(mu, jnp.float32)
        self.cov = jnp.asarray(cov, jnp.float32)
        self.dim = self.mu.shape[0]
        self.chol = jnp.linalg.cholesky(self.cov)
        self.log_det = 2.0 * jnp.sum(jnp.log(jnp.diag(self.chol)))
        self.prec = jnp.linalg.inv(self.cov)

    def log_prior(self, params):
        return jnp.float32(0.0)

    def log_likelihood(self, params, batch=None):
        x = params["x"]
        diff = x - self.mu
        # Solve L z = diff  =>  diff^T Sigma^-1 diff = ||z||^2
        z = jax.scipy.linalg.solve_triangular(self.chol, diff, lower=True)
        return -0.5 * (
            self.dim * jnp.log(2.0 * jnp.pi) + self.log_det + jnp.sum(z * z)
        )

    def init_params(self, key):
        return {"x": jnp.zeros((self.dim,), jnp.float32)}

    def analytic_grad(self, params, batch=None):
        """Closed-form grad of the log density: -(x-mu) @ Sigma^-1
        (reference /root/reference/hamiltonian/models/cpu/mvn_gaussian.py:14-20
        computes the positive gradient of the negative log posterior)."""
        diff = params["x"] - self.mu
        return {"x": -diff @ self.prec}
