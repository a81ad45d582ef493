"""Euclidean metric (mass matrix) for Hamiltonian samplers.

The reference hard-codes a unit diagonal mass matrix
(/root/reference/hamiltonian/inference/cpu/hmc.py:17-26, kinetic energy
0.5*||p||^2 at :74-79).  Here the metric is a pytree of per-coordinate inverse
masses (diagonal metric), adapted during warmup (see adaptation.py) — momentum
draws, kinetic energy, and kinetic gradient all stay single fused elementwise
programs.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .tree import tree_dot, tree_mul, tree_ones_like, tree_randn_like

Params = Any


class Metric(NamedTuple):
    """Euclidean metric: p ~ N(0, M); K(p) = 0.5 p^T M^-1 p.

    sample_position (optional): draw q ~ N(mean, M^-1) — the Laplace
    approximation to the posterior when M is the Hessian at the MAP; used for
    overdispersion-free chain initialization.

    whiten / unwhiten (optional): the change of variables e = M^{1/2} dq and
    dq = M^{-1/2} e.  Sampling the REPARAMETRIZED posterior p(e) with an
    identity mass matrix is algebraically identical to sampling p(q) under
    this metric, but numerically far better in float32: every coordinate of
    (e, momentum) is O(1) instead of spanning the metric's condition number.
    """

    sample_momentum: Callable
    kinetic_energy: Callable
    kinetic_grad: Callable
    sample_position: Callable = None
    whiten: Callable = None
    unwhiten: Callable = None


def diagonal_metric(inv_mass: Params) -> Metric:
    """Build a metric from a pytree of diagonal inverse masses (M^-1)."""
    sqrt_mass = jax.tree_util.tree_map(lambda im: 1.0 / jnp.sqrt(im), inv_mass)

    def sample_momentum(key, position):
        eps = tree_randn_like(key, position)
        return tree_mul(sqrt_mass, eps)

    def kinetic_energy(momentum):
        return 0.5 * tree_dot(momentum, tree_mul(inv_mass, momentum))

    def kinetic_grad(momentum):
        return tree_mul(inv_mass, momentum)

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)


def batched_diagonal_metric(inv_mass: Params) -> Metric:
    """Diagonal metric over chain-batched pytrees: every leaf (of positions,
    momenta, and ``inv_mass`` itself) carries a leading chain axis C, and
    kinetic_energy returns a per-chain (C,) vector.

    This is the metric for the chain-batched HMC kernel
    (inference.hmc.build_batched_kernel), where all chains advance inside ONE
    program so a batched multi-chain value_and_grad can
    serve them in a single dataset pass.
    """
    from .tree import tree_batched_dot

    sqrt_mass = jax.tree_util.tree_map(lambda im: 1.0 / jnp.sqrt(im), inv_mass)

    def sample_momentum(key, position):
        eps = tree_randn_like(key, position)
        return tree_mul(sqrt_mass, eps)

    def kinetic_energy(momentum):
        return 0.5 * tree_batched_dot(momentum, tree_mul(inv_mass, momentum))

    def kinetic_grad(momentum):
        return tree_mul(inv_mass, momentum)

    return Metric(sample_momentum, kinetic_energy, kinetic_grad)


def unit_metric(position_like: Params) -> Metric:
    """Identity mass matrix (the reference's only option)."""
    return diagonal_metric(tree_ones_like(position_like))


def dense_metric(mass_matrix: jnp.ndarray, position_like: Params) -> Metric:
    """Full (dense) mass matrix M over the raveled parameter vector.

    For targets whose curvature is known in closed form (e.g. a Gaussian with
    precision M) this gives exact whitening: e = M^{1/2} q has an isotropic
    posterior, so HMC/NUTS mix in O(1) trajectories regardless of M's
    condition number — the capability a diagonal metric cannot provide
    (cross-coordinate correlation).  Cost: one (D, D) eigendecomposition at
    build time, two (D, D) matvecs per whiten/unwhiten.  For the structured
    GLM case use ops/kron_metric.py instead (same math, Kronecker-factored,
    no dense D x D ever materialized).
    """
    import jax.flatten_util

    _, unravel = jax.flatten_util.ravel_pytree(position_like)
    s, U = jnp.linalg.eigh(mass_matrix)
    s = jnp.maximum(s, 1e-30)
    sqrt_s = jnp.sqrt(s)

    def _flat(tree):
        return jax.flatten_util.ravel_pytree(tree)[0]

    def sample_momentum(key, position):
        eps = jax.random.normal(key, sqrt_s.shape, sqrt_s.dtype)
        return unravel(U @ (sqrt_s * eps))

    def kinetic_energy(momentum):
        e = (U.T @ _flat(momentum)) / sqrt_s
        return 0.5 * jnp.sum(e * e)

    def kinetic_grad(momentum):
        return unravel(U @ ((U.T @ _flat(momentum)) / s))

    def sample_position(key, mean):
        eps = jax.random.normal(key, sqrt_s.shape, sqrt_s.dtype)
        return jax.tree_util.tree_map(
            lambda m, d: m + d, mean, unravel(U @ (eps / sqrt_s)))

    def whiten(dq):
        return unravel(sqrt_s * (U.T @ _flat(dq)))

    def unwhiten(e):
        return unravel(U @ (_flat(e) / sqrt_s))

    return Metric(sample_momentum, kinetic_energy, kinetic_grad,
                  sample_position, whiten, unwhiten)
