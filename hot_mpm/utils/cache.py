"""Persistent XLA compilation cache setup.

The full implicit-MPM step is a large XLA program (nested Newton/CG
while-loops over scatter/gather/SVD subgraphs) whose first compilation
takes a long time. A persistent cache lets later processes reuse it.
Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache
there and this module sets no directory; otherwise the cache lives at
the fixed path <repo>/.jax_cache (a fixed path, since the path is part of
the cache key). Call once, early, before the first compilation.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
