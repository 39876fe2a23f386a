"""Persistent XLA compilation cache.

One helper for every entry point that compiles at scale (``bench.py``,
``chip_smoke.py``): a later run with the same programs loads them from disk
instead of compiling again.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(default_dir: str) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``default_dir``, which must
    be a fixed path (the path is part of the cache key: a directory named
    after a PID, a time or a temporary name never hits).  Call before the
    first compilation.
    """
    env = os.environ.get(ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
