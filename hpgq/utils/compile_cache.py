"""Persistent XLA compilation cache, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside the
checkout, ``.bench/jax_cache`` (listed in ``.gitignore``): the directory is
part of what lets a later process find a compiled program again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bench", "jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on (a no-op where ``JAX_COMPILATION_CACHE_DIR``
    is set); returns the directory in use ("" when none can be made)."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
    except OSError:  # read-only checkout: run uncached rather than fail
        return ""
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # keep every program: on the GPU most of a command's programs compile
    # in under a second each, yet together they are most of a cold run
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR
