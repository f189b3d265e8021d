"""Persistent XLA compile cache for the benchmark, smoke and experiment
entry points.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this module
changes nothing. Otherwise the cache is placed at ``<checkout>/.jax_cache``,
a fixed path (the path is part of the cache key), so a second run in the
same checkout reuses the first run's compilations.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE", "enable_compile_cache"]

#: ``<checkout>/.jax_cache`` — listed in ``.gitignore``.
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
