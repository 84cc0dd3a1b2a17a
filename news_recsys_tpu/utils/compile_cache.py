"""Persistent XLA compilation cache.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` before their first compile. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
changed here. Otherwise the cache goes to ``<checkout>/.jax_cache``: a fixed
path, because the directory is part of what a later process must find again.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set; returns the directory set
    here, or None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
