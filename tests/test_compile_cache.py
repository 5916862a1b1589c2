"""The persistent compile cache helper (frave_tpu/compile_cache.py)."""

import os

import jax

from frave_tpu import compile_cache


def test_env_variable_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))

    def no_update(*args):
        raise AssertionError(f"jax.config.update{args} with the variable set")

    monkeypatch.setattr(jax.config, "update", no_update)
    assert compile_cache.enable_compile_cache() == str(tmp_path)


def test_fixed_directory_in_the_checkout_without_env(monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.enable_compile_cache() == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(repo, ".jax_cache")
