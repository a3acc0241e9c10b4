"""Persistent XLA compilation cache helper.

Every entry point (tests, benchmarks, demos) opts into the on-disk
cache so repeat runs skip compilation.  ``JAX_COMPILATION_CACHE_DIR``,
when set, names the directory; otherwise the cache lives in
``.jax_cache`` at the root of the checkout.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir():
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE


def enable_persistent_cache():
    """Point JAX's persistent cache at ``cache_dir()`` and cache every
    compiled program, however small.  Returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
