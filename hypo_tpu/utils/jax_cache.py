"""Where JAX keeps compiled programs between runs."""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  JAX reads JAX_COMPILATION_CACHE_DIR itself; where it is
    set, nothing else is set here.  Otherwise the cache is
    ``<checkout>/.jax_cache``: a fixed path, because the path is part of
    the cache's key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
