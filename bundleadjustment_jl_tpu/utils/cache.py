"""Persistent XLA compilation cache for the entry points.

A Dubrovnik-356 solve compiles two large programs (init and run) per
storage precision; the persistent cache lets a later process on the same
machine load them instead of compiling again.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache, resolved from this file (utils/ -> package ->
# checkout), so the path does not depend on the working directory.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that variable
    itself and nothing is changed here; otherwise the cache goes to
    :data:`DEFAULT_DIR`. Either way every compiled program is cached,
    however small or quick to compile.
    """
    import jax
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
