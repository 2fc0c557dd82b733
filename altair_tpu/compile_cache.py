"""Persistent XLA compilation cache location, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at a fixed path inside the
checkout (``<checkout>/.jax_cache``, listed in ``.gitignore``): the path is
part of what makes a later process find the entries again, so it is never
built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` (the directory above this package)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(here), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the variable's directory
    or the fixed in-checkout default; returns the directory in use."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
