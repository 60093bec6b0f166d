"""Persistent XLA compilation cache, one place for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache goes to ``<repo>/.jax_cache``: a fixed path
inside the checkout (the path is part of the cache key, so it must not
move), listed in ``.gitignore``.
"""
from __future__ import annotations

import os
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compile cache at the repo-local directory
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one. Returns the
    directory set here, or None when the environment variable rules."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
