"""Persistent XLA compilation cache (SURVEY.md §5.1 tooling follow-up).

JAX ships a persistent on-disk compilation cache keyed on the HLO, the
compile options and the platform; enabling it turns repeat compilations of
unchanged programs into a disk read. Every entry point (bench.py, the CLI,
chip_smoke.py, experiments) calls `enable_persistent_compilation_cache`.

Where the cache lives:
  * `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself and this module
    sets no directory.
  * otherwise `<checkout>/.jax_cache` — a fixed path that does not depend
    on the working directory (the path is part of the cache key, so a
    directory that moves never hits).

Opt-out via LFBM5D_NO_COMPILE_CACHE=1 (e.g. to measure cold compiles).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_compilation_cache() -> str | None:
    """Enable JAX's on-disk compilation cache; returns the dir (None = off).

    Safe to call multiple times. If jax already has a cache dir configured
    (JAX_COMPILATION_CACHE_DIR or an earlier call), it is left alone.
    """
    if os.environ.get("LFBM5D_NO_COMPILE_CACHE") == "1":
        return None
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # Cache every program regardless of compile time / size: the pipeline
    # dispatches many small helper programs besides the big step programs.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return DEFAULT_DIR
