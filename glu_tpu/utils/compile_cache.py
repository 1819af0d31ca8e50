"""Persistent XLA compilation cache for the program that owns the runtime.

The library never calls this on import: like the reference, which does not
own a GL context, it does not own the JAX runtime. The entry points that do
(chip_smoke.py, bench.py) call `use_compile_cache` once at start-up.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache(default_dir) -> str:
    """Keep JAX's persistent compilation cache in $JAX_COMPILATION_CACHE_DIR
    when that is set (JAX reads the variable itself, so nothing is changed),
    else in `default_dir`. Pass a fixed path: a directory named after a pid,
    a time or a temporary name is a new, empty cache on every run. Returns
    the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = os.fspath(default_dir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
