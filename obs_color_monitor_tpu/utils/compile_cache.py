"""JAX's persistent compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache lives at ``<repo>/.jax_cache``:
a fixed path inside the checkout, because the path is part of each cache
entry's key and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the cache on; returns the directory in use."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
