"""Dataset loaders for the benchmark workloads.

Parity targets (SURVEY.md §2, L4): the 2-D blobs problem of
benchmarks/1.-Simulated_data.ipynb, MNIST from HDF5 (mnist_train.h5 with
X_train/y_train keys, benchmarks/2.-MNIST.ipynb cell 2), and the PlantVillage
conv-feature classifier from the reference README (:14-23).  This box has zero
egress, so every loader falls back to a deterministic synthetic generator with
the same shapes/statistics when the data file is absent; pass an explicit path
to use real data.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def blobs(n: int = 1000, d: int = 2, sep: float = 3.0, seed: int = 0,
          test_fraction: float = 0.2):
    """Two separable Gaussian blobs (binary) — notebook 1's simulated data."""
    rng = np.random.RandomState(seed)
    n2 = n // 2
    X = np.concatenate([
        rng.randn(n2, d) - sep / 2.0,
        rng.randn(n - n2, d) + sep / 2.0,
    ]).astype(np.float32)
    y = np.concatenate([np.zeros(n2), np.ones(n - n2)]).astype(np.float32)
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    n_test = int(n * test_fraction)
    return (
        (jnp.asarray(X[n_test:]), jnp.asarray(y[n_test:])),
        (jnp.asarray(X[:n_test]), jnp.asarray(y[:n_test])),
    )


def synthetic_classification(n: int, d: int, k: int, seed: int = 0,
                             noise: float = 0.5):
    """Linearly separable-ish K-class data from a ground-truth softmax model."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32) / np.sqrt(d)
    logits = X @ W + noise * rng.randn(n, k).astype(np.float32)
    y = logits.argmax(-1).astype(np.int32)
    return jnp.asarray(X), jnp.asarray(y)


def _find_mnist_h5(path: Optional[str] = None) -> Optional[str]:
    """Resolve a real mnist_train.h5: explicit path, $DHMC_DATA_DIR, or the
    conventional ./data / repo-root locations (reference layout:
    benchmarks/2.-MNIST.ipynb cell 2 reads '../data/mnist_train.h5')."""
    if path is not None:
        return path if os.path.exists(path) else None
    candidates = []
    env = os.environ.get("DHMC_DATA_DIR")
    if env:
        candidates.append(os.path.join(env, "mnist_train.h5"))
    here = os.path.dirname(__file__)
    candidates += [
        os.path.join(os.getcwd(), "data", "mnist_train.h5"),
        os.path.join(here, "..", "..", "data", "mnist_train.h5"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def mnist_provenance(path: Optional[str] = None) -> str:
    """'hdf5:<path>' when a real MNIST file will be used, else
    'synthetic-mnist' — carried into bench/CLI JSON lines so synthetic-data
    numbers can never be misread as real-MNIST results."""
    resolved = _find_mnist_h5(path)
    return f"hdf5:{resolved}" if resolved else "synthetic-mnist"


def plantvillage_provenance(path: Optional[str] = None) -> str:
    if path is not None and os.path.exists(path):
        return f"hdf5:{path}"
    return "synthetic-plantvillage"


def mnist(path: Optional[str] = None, split: str = "train"):
    """MNIST in the reference's HDF5 layout (X_train/y_train, X_test/y_test).

    A real mnist_train.h5 is auto-discovered (see _find_mnist_h5) when
    ``path`` is None.  Without one: deterministic MNIST-shaped synthetic data
    (60000/10000 x 784, 10 classes, pixel statistics in [0,1]) so the
    benchmark pipeline runs in zero-egress environments with identical shapes
    and compute cost.
    """
    path = _find_mnist_h5(path)
    if path is not None and os.path.exists(path):
        import h5py

        with h5py.File(path, "r") as f:
            X = np.asarray(f[f"X_{split}"], np.float32)
            y = np.asarray(f[f"y_{split}"]).astype(np.int32)
        if X.max() > 1.5:
            # /256 (not /255): 8-bit pixels k/256 are EXACTLY
            # bf16-representable, so a bf16 copy of X carries no rounding
            # error
            X = X / 256.0
        if y.ndim == 2:  # one-hot stored
            y = y.argmax(-1).astype(np.int32)
        return jnp.asarray(X.reshape(X.shape[0], -1)), jnp.asarray(y)

    n = 60000 if split == "train" else 10000
    cache = os.path.join(os.path.dirname(__file__), "..", "..", ".data_cache")
    cache_file = os.path.join(cache, f"mnist_synth_v3_{split}.npz")
    if os.path.exists(cache_file):
        z = np.load(cache_file)
        return jnp.asarray(z["X"]), jnp.asarray(z["y"])
    rng = np.random.RandomState(0 if split == "train" else 1)
    # Class-conditional pixel means -> classification is learnable; pixel
    # scale matches MNIST ([0,1], sparse-ish).  Class overlap is calibrated so
    # a linear softmax tops out near real-MNIST accuracy (~0.92) instead of
    # separating perfectly: linearly separable data makes the softmax
    # posterior a prior-truncated ridge (zero Fisher at the MAP), which is
    # neither Gaussian-like nor representative of the real dataset.
    centers = rng.rand(10, 784).astype(np.float32) * 0.12
    y = rng.randint(0, 10, size=n).astype(np.int32)
    X = centers[y] + 0.3 * np.abs(rng.randn(n, 784).astype(np.float32))
    # 4% label noise: irreducible class confusion keeps MAP probabilities
    # away from 1 (positive Fisher information everywhere)
    flip = rng.rand(n) < 0.04
    y = np.where(flip, rng.randint(0, 10, size=n), y).astype(np.int32)
    X = np.clip(X, 0.0, 1.0)
    # quantize to the 8-bit grid k/256 — same precision as real MNIST pixels
    # and exactly bf16-representable (see the /256 note above)
    X = np.round(X * 256.0) / 256.0
    try:
        os.makedirs(cache, exist_ok=True)
        np.savez(cache_file, X=X, y=y)
    except OSError:
        pass
    return jnp.asarray(X), jnp.asarray(y)


def digits():
    """Real bundled image data (sklearn 8x8 digits, 1797 examples, 10-class)
    for tests that want non-synthetic pixels without network access."""
    from sklearn import datasets as skdatasets

    d = skdatasets.load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    return jnp.asarray(X), jnp.asarray(y)


def plantvillage_features(path: Optional[str] = None, n: int = 20000,
                          dim: int = 512, k: int = 38, seed: int = 2):
    """PlantVillage conv-feature classifier data (reference README:14-23
    points at precomputed conv features).  HDF5 layout: features/labels.
    Synthetic fallback: clustered conv-feature-like activations (ReLU-censored
    Gaussians around class centers), 38 classes like PlantVillage."""
    if path is not None and os.path.exists(path):
        import h5py

        with h5py.File(path, "r") as f:
            X = np.asarray(f["features"], np.float32)
            y = np.asarray(f["labels"]).astype(np.int32)
        return jnp.asarray(X), jnp.asarray(y)

    rng = np.random.RandomState(seed)
    centers = np.maximum(rng.randn(k, dim).astype(np.float32), 0.0)
    y = rng.randint(0, k, size=n).astype(np.int32)
    X = np.maximum(centers[y] + 0.5 * rng.randn(n, dim).astype(np.float32), 0.0)
    return jnp.asarray(X), jnp.asarray(y)


def train_test_split(X, y, test_fraction: float = 0.2, seed: int = 0):
    n = X.shape[0]
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_fraction)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return (X[train_idx], y[train_idx]), (X[test_idx], y[test_idx])
