"""Persistent XLA compilation cache placement for the entry-point scripts.

A cache hit needs the same directory every run (the path is part of the
cache key), so the default is a fixed directory inside the checkout, never
a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and nothing is
    changed here. Otherwise the cache goes to <repo>/.jax_cache and keeps
    every program: on the GPU most of these programs compile in under JAX's
    default 1 s caching threshold. Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR
