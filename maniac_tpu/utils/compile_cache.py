"""Persistent XLA compilation cache for the program's entry points.

Compiling the block program at full size takes a large share of a short
run, and every process of a run compiles the same programs. JAX keys a
cache entry on, among others, the cache directory itself, so the
directory must not move between runs: it is `JAX_COMPILATION_CACHE_DIR`
when that is set (JAX reads it by itself, nothing is set in code), or a
directory configured in-process before the call, or else `.jax_cache` at
the root of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at a fixed directory.

    Returns the directory this call configured, or None when the cache
    location was already given (environment variable or in-process
    config) and was left alone."""
    import jax

    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir):
        return None
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
