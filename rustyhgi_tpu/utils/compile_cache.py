"""Persistent compilation cache location, shared by every entry point."""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

# <checkout>/.cache/jax: fixed, so a later process finds what an earlier
# one compiled (the path is part of the cache key).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
    "jax",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache goes to
    :data:`CHECKOUT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
