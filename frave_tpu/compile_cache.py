"""Persistent XLA compilation cache shared by every entry point.

A codec program compiles once per image shape, and the first compile of
a large shape takes long enough to dominate a short run. JAX keeps
compiled executables on disk when a cache directory is configured:

  * if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing else is set here;
  * otherwise the cache lives at a fixed ``.jax_cache/`` beside the
    package (the checkout root). A fixed path matters: the directory is
    part of the cache key, so a cache that moves never hits.

Call ``enable_compile_cache()`` before the first compile of the process.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
