"""Where JAX keeps its persistent compilation cache.

A cold run compiles every train, eval and sweep program (the 3D backward
pass the longest), so every entry point calls :func:`enable_compile_cache`
before its first compile.  The directory must
stay put between runs for the cache to be hit again:
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads that
variable itself, and nothing is set here), else the fixed
``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent compilation cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
