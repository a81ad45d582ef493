"""The process-wide JAX settings helper (utils/runtime.py)."""

import os

import jax
import pytest

from dropout_hamiltonian_montecarlo_tpu.utils import runtime


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_env_set_leaves_directory_to_jax(config_updates,
                                                       monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates


def test_compile_cache_env_unset_uses_checkout(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    runtime.enable_compile_cache()
    expected = os.path.join(runtime.CHECKOUT, ".jax_cache")
    assert config_updates["jax_compilation_cache_dir"] == expected
    assert os.path.exists(os.path.join(runtime.CHECKOUT, "pyproject.toml"))


def test_configure_sets_float32_matmuls(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    runtime.configure()
    assert config_updates["jax_default_matmul_precision"] == "highest"
