"""Persistent XLA compilation cache for accelerator runs.

A full-width frame step takes tens of seconds to compile; the cache lets
a second process (the next ``cli`` run, ``bench.py``, ``chip_smoke.py``)
load it instead.  The directory is ``$JAX_COMPILATION_CACHE_DIR`` when
set — JAX reads that variable itself and no other directory is set in
code — and otherwise ``<checkout>/.jax_cache``.  The path is fixed (no
process id, no time): it is part of what makes a cache entry findable
again.  CPU-only runs (the tests, ``--platform cpu``) leave it off: their
programs are small and would only fill the checkout.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    """The cache directory this process uses (see module docstring)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent cache at ``compile_cache_dir()`` before the
    first compile; returns the directory, or None on a CPU-only run."""
    if ENV in os.environ:
        return os.environ[ENV]
    if jax.config.jax_platforms == "cpu":
        return None
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
