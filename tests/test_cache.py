"""Persistent compile cache location (``utils.cache``)."""

import os

import jax
import pytest

from slam_eslam_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_names_the_directory(monkeypatch, tmp_path,
                                     restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_persistent_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
