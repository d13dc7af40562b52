"""JAX runtime configuration: the persistent compilation cache.

Repeat driver, benchmark and test runs skip the 20-120 s XLA compiles
(the reference's setup is milliseconds — radiation_interface.F90:37 —
so the compile cost must be paid once).  Where ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already uses that directory and this module sets no other;
otherwise the cache lives at a fixed ``<repo>/.jax_cache`` (the path is
part of the cache key, so it must not move between runs).

Matmul precision is not set here: every f32 contraction on the device
path names its own precision."""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The compilation cache directory in use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_persistent_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
