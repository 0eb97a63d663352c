"""Where compiled XLA programs persist across processes.

One helper for every entry point that compiles for the accelerator (the
CLI, ``bench.py``, ``chip_smoke.py``).  When ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and nothing is set here.  Otherwise the cache
lives at a fixed ``<checkout>/.jax_cache`` (gitignored): the directory is
part of the cache key, so a path that moved between runs would never hit.
CPU runs (the test suite) keep JAX's default of no persistent cache.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory a run uses: the env var when set, else the
    fixed checkout path."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``.
    Returns the directory in use, or None on the CPU backend."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return compile_cache_dir()
