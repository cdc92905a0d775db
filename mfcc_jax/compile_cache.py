"""Persistent XLA compile cache at one fixed place.

A cold process compiles every jitted program again; the persistent cache
keeps the compiled executables on disk, keyed (among other things) by the
cache's own path -- so the path must not move between runs.

  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing else
    is configured here.
  * otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
