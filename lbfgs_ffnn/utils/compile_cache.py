"""Persistent XLA compilation cache for the entry-point scripts.

A solve compiles one large XLA program per (problem, options) pair, and a
fresh process pays that compile again. JAX keeps compiled executables on
disk when it is given a cache directory. The directory is part of the
cache's key, so it must not move between runs: either the directory named
by ``JAX_COMPILATION_CACHE_DIR`` (which JAX reads by itself) or one fixed
directory inside the checkout, ``<repo>/.jax_cache`` (git-ignored).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the cache lives in: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else :data:`DEFAULT_DIR`."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses it and nothing
    is changed here. Otherwise the fixed in-checkout directory is set."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
