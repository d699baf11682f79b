"""JAX's persistent compilation cache, set once by each entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it. Otherwise the cache goes to ``.jax_cache/`` at
the root of the checkout: a fixed path, so later runs of the same programs
find what earlier runs compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns that path."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
