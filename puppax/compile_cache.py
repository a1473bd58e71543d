"""The persistent XLA compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads it
itself, and nothing here overrides it). Otherwise the cache is the fixed
directory ``.jax_cache/`` at the root of the checkout: a fixed path, so
that a later process finds what an earlier one compiled (the path is part
of the cache key).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the compilation cache lives in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
