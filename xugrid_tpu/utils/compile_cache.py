"""
Where the entry points keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives in ``<repo>/.jax_cache`` (listed in ``.gitignore``).  A fixed path
matters: the cache directory is part of what a later run looks up.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR``, else at ``REPO_CACHE_DIR``."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
