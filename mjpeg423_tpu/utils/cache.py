"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI and chip_smoke.py): if
JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing else is
set here; otherwise the cache lives at a fixed path inside the checkout,
<checkout>/.jax_cache (listed in .gitignore).  A fixed path matters because
the path is part of the cache key: a directory that moves never hits.
"""
from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
