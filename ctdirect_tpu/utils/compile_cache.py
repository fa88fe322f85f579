"""Where entry-point scripts keep JAX's persistent compilation cache.

The library sets no cache when it is imported. Each script that drives a
solve (bench.py, chip_smoke.py, benchmarks/*) calls `enable_compile_cache()`
once, before its first compile:

- if `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
  else is set;
- otherwise the cache lives at one fixed path inside the checkout,
  `<checkout>/.jax_cache` (listed in .gitignore). A later run finds its
  entries only in the same directory, so the path never depends on a temp
  name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The cache directory an entry point uses: the env var, else the default."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    Returns the directory. With the env var set, JAX's config is left as it
    is (JAX picks the variable up itself)."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
