"""Where JAX keeps its persistent compile cache.

A compiled program is cached on disk under a key that includes the cache's
path, so the directory has to be the same from one run to the next for a
run to find what an earlier one compiled.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads that variable itself and
    nothing is changed here.  Otherwise the cache goes to CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
