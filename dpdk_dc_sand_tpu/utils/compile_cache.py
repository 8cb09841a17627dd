"""JAX's persistent compilation cache, kept at one fixed place.

A compile of the flagship step takes tens of seconds; the cache lets later
processes on the same machine load it instead. The directory is part of
the cache key, so it must not move between runs: ``JAX_COMPILATION_CACHE_DIR``
when the environment sets it (JAX reads that variable itself), otherwise
``<repo>/.jax_cache``, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set.
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    Call before the first compile. With ``JAX_COMPILATION_CACHE_DIR`` set
    this sets nothing and returns that directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
