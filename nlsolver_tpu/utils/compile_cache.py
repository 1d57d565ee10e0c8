"""Placement of JAX's persistent compilation cache.

Every entry point (``bench.py``, ``chip_smoke.py``, the test suite, the
tools) calls :func:`enable_compile_cache` once, before its first compile.
When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
function leaves it alone.  Otherwise the cache goes to ``.jax_cache/`` at
the root of the checkout: a fixed path, so a second run finds what the
first one compiled (the path is part of the cache key).
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return the directory it uses."""
    path = os.environ.get(ENV_VAR) or CHECKOUT_CACHE
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every executable: the solvers' small programs compile in well
    # under JAX's default one-second threshold, but there are hundreds
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
