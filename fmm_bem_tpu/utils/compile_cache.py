"""The persistent XLA compilation cache of the entry-point scripts."""

from __future__ import annotations

import os

import jax

#: fixed in-checkout cache directory: the path is part of the cache key,
#: so it must not move between runs
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX untouched;
    otherwise the cache lives in ``<checkout>/.jax_cache``.  Call it
    from a script's entry point, not at import.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
