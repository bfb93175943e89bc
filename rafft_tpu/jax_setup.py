"""Process-wide JAX configuration: the persistent compilation cache.

The fold-step program takes minutes to compile per (N, K, M, ...)
configuration; the persistent cache lets later processes load it.
Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at one fixed path
inside the checkout (listed in .gitignore): the path is part of the
cache key, so it must not move between runs.  Imported for its side
effect by the JAX-facing modules.
"""

import os
from pathlib import Path

import jax

REPO_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir(environ=os.environ):
    """The directory this module sets, or None when the environment
    names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE


_dir = cache_dir()
if _dir is not None:
    try:
        _dir.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(_dir))
    except OSError:  # pragma: no cover - the cache is an optimisation only
        pass
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
