"""Persistent XLA compile cache placement, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so no
other path is set in code); otherwise the cache lives at a fixed path
inside the checkout, ``<repo>/.jax_cache/`` (listed in .gitignore). The
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
