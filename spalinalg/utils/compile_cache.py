"""Persistent XLA compilation cache for entry-point scripts.

Called by ``bench.py`` and ``chip_smoke.py`` before their first
compilation, never at library import: a library must not pick its
caller's cache. ``$JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise
the cache lives at the fixed ``<checkout>/.jax_cache`` (listed in
``.gitignore``). The path is part of what JAX keys a cache on, so it is
never built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory :func:`enable_compile_cache` uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
