"""Process-wide JAX settings shared by every entry point (the CLI,
bench.py, chip_smoke.py).

Compile cache: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets nothing. Otherwise the cache lives at a fixed
path inside the checkout, ``<checkout>/.jax_cache`` (listed in
.gitignore) — fixed, because the path is part of what makes a later run
find its entries.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory; returns
    that directory."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return jax.config.jax_compilation_cache_dir
