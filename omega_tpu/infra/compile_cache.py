"""Placement of JAX's persistent compilation cache.

When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to `.jax_cache/` at the root
of the checkout: a fixed path, because the directory is part of what a
later process must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
