"""Persistent XLA compilation cache location, shared by every entry point.

A compiled planner takes seconds to minutes to build on the GPU; the cache
lets a later process on the same machine skip that. Its path is part of the
cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    the path. If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it
    and nothing else is set; otherwise the cache lives in the fixed
    ``<checkout>/.jax_cache``. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
