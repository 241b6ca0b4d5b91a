"""One place that chooses JAX's persistent compilation cache directory.

Every entry point (bench.py, benchmarks/run.py, chip_smoke.py, kytpu.cli,
the test suite and its worker processes) calls enable_compile_cache()
before its first compile. The cache lives where JAX_COMPILATION_CACHE_DIR
says when that variable is set, and otherwise in a fixed directory inside
the checkout (listed in .gitignore): the path is part of the cache key, so
a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR if set (and non-empty), else DEFAULT_DIR."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float | None = None) -> str:
    """Point JAX's persistent compilation cache at cache_dir() and return
    the directory. min_compile_secs lowers JAX's threshold for caching a
    program (its default is 1 s)."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_secs)
    return path
