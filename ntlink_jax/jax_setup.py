"""Process-wide JAX configuration for the engine.

Persistent compilation cache: the mapping/sketch kernels compile once per
(shape-bucket, params), and the cache on disk lets repeat runs skip XLA
compilation. The directory is `$JAX_COMPILATION_CACHE_DIR` when that is set
(JAX reads it itself, and nothing here overrides it), else `.jax_cache` at
the root of this checkout, a fixed path so that every run of the checkout
hits the same cache.
"""
from __future__ import annotations

import os

#: default cache directory: `<checkout>/.jax_cache` (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_configured = False


def configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
