"""Persistent XLA compilation cache setup.

The reference-scale programs take tens of seconds or more to compile, so
compiled executables are kept across processes. :func:`enable_compile_cache`
puts the cache where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
otherwise at ``<checkout>/.jax_cache``: a fixed path, because the path is
part of the cache key. Call it after importing jax and before the first
jit execution; bench.py, app.py and chip_smoke.py do.
"""

from __future__ import annotations

import os


def enable_compile_cache(cache_dir: str | None = None) -> str:
    """Enable the persistent compilation cache (idempotent). Returns the
    cache directory used."""
    import jax

    if cache_dir is None:
        cache_dir = os.environ.get(
            "JAX_COMPILATION_CACHE_DIR",
            os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".jax_cache"),
        )
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
