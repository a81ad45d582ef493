"""Model protocol for the Bayesian inference engine.

Capability parity with the reference model layer
(/root/reference/hamiltonian/models/model.py:1-7 and the duck-typed interface of
/root/reference/hamiltonian/models/cpu/softmax.py:22-100) — redesigned as *pure
functions over pytrees* so that samplers can consume a single
``logdensity_fn(params) -> scalar`` closure and let ``jax.grad`` do the work the
reference did with hand-derived gradients.

Conventions
-----------
- ``params`` is a pytree (the reference's flat ``dict[str, ndarray]`` is one).
- ``batch`` is a tuple ``(X, y)`` (or ``(X,)`` / ``None`` for density targets).
- ``log_likelihood`` returns the SUM of per-datum log-likelihoods over the batch.
- ``log_posterior(params, batch, data_size)`` = log_prior + scale * log_lik with
  ``scale = data_size / batch_size`` — the standard unbiased minibatch estimator
  (the reference instead rescaled NLP by 1/n_data but not the gradient,
  /root/reference/hamiltonian/models/cpu/logistic.py:57-62; we implement the
  consistent estimator, matching observable results, not the bug).
- Samplers maximize log-density (minimize potential = -log_posterior).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

Params = Any
Batch = Optional[Tuple[jnp.ndarray, ...]]


class Model:
    """Base class: subclasses implement log_prior / log_likelihood / init_params.

    All methods are pure and jit/vmap/grad-safe; instances hold only static
    hyperparameters (shapes, prior precision) and are safe to close over.
    """

    def log_prior(self, params: Params) -> jnp.ndarray:
        raise NotImplementedError

    def log_likelihood(self, params: Params, batch: Batch) -> jnp.ndarray:
        raise NotImplementedError

    def init_params(self, key: jax.Array) -> Params:
        raise NotImplementedError

    # ---- derived quantities -------------------------------------------------

    def log_posterior(
        self, params: Params, batch: Batch = None, data_size: Optional[int] = None
    ) -> jnp.ndarray:
        ll = self.log_likelihood(params, batch)
        if data_size is not None and batch is not None:
            batch_size = batch[0].shape[0]
            ll = (data_size / batch_size) * ll
        return self.log_prior(params) + ll

    def potential(self, params: Params, batch: Batch = None,
                  data_size: Optional[int] = None) -> jnp.ndarray:
        """Negative log posterior (the reference's ``negative_log_posterior``)."""
        return -self.log_posterior(params, batch, data_size)

    def make_logdensity(self, batch: Batch = None,
                        data_size: Optional[int] = None) -> Callable[[Params], jnp.ndarray]:
        """Close over a (full or mini) batch: the sampler-facing callable."""
        def logdensity(params: Params) -> jnp.ndarray:
            return self.log_posterior(params, batch, data_size)
        return logdensity

    def make_batched_logdensity(
        self, data_size: int
    ) -> Callable[[Params, Batch], jnp.ndarray]:
        """Minibatch form for SG-MCMC: ``(params, batch) -> scaled log posterior``."""
        def logdensity(params: Params, batch: Batch) -> jnp.ndarray:
            return self.log_posterior(params, batch, data_size)
        return logdensity
