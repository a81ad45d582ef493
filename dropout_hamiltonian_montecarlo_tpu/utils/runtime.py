"""Process-wide JAX settings shared by every entry point (bench, CLI, tests,
scripts, chip_smoke.py).

Matmul precision: float32 matrix products run at full float32 accuracy.  The
Metropolis-Hastings accept compares log densities of size |log p| ~ 1e4-1e5
summed over 60k rows; an energy error near 1 nat swamps the accept ratio and
dual averaging then collapses the step size.  On the H100 "default" and
"high" both lower to TF32 GEMMs (about three decimal digits; ~1 nat of
energy error at MNIST width), so the program asks for "highest".
Lower-precision inner gradients are a tuning question for the sampler (ESS
per gradient evaluation), not a global default.
"""

from __future__ import annotations

import os

MATMUL_PRECISION = "highest"

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets no directory.  Otherwise the cache lives at ``<checkout>/.jax_cache``.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(CHECKOUT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return env_dir or jax.config.jax_compilation_cache_dir


def configure() -> str:
    """Compile cache plus the float32 matmul precision above; returns the
    cache directory.  Call before the first computation."""
    import jax

    jax.config.update("jax_default_matmul_precision", MATMUL_PRECISION)
    return enable_compile_cache()
