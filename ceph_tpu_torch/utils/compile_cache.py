"""The kernel build cache behind one env knob — the port's counterpart
of ``ceph_tpu/utils/compile_cache.py`` (the JAX persistent compilation
cache).

``CEPH_TPU_COMPILE_CACHE=<dir>`` (the ``compile_cache`` option of
utils/config.py, so ``global_config().set`` works too) moves the
directory ``ops/_build.py`` builds its kernel libraries into.  A library
is named by a hash of its source, the shared headers and the flags, so
a second process, or a second checkout of the same sources pointed at
the same directory, loads the library and runs no ``nvcc``.  Unset, the
libraries land in the package's own ``ops/build/`` (git-ignored).

Each library the build looks for counts once: found on disk,
``kernel_build_cache_hits``; built, ``kernel_build_cache_misses`` (the
reference's ``jax_persistent_cache_hits`` / ``_misses`` counters'
counterparts).  A warm replay is ``misses == 0 and hits > 0``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_KNOB = "CEPH_TPU_COMPILE_CACHE"
HITS = "kernel_build_cache_hits"
MISSES = "kernel_build_cache_misses"


def compile_cache_dir() -> Optional[str]:
    """The configured cache directory (option or env knob), or None."""
    from .config import global_config
    return global_config().get("compile_cache") or None


def note_lookup(hit: bool) -> None:
    """Count one library lookup of the build as a cache hit or miss."""
    from ..telemetry import metrics as tel
    tel.counter(HITS if hit else MISSES)


def cache_entries(cache_dir: Optional[str] = None) -> int:
    """Number of built kernel libraries on disk (``lib*.so``) in
    ``cache_dir`` (default: the configured one) — 0 when unconfigured
    or absent."""
    d = cache_dir or compile_cache_dir()
    if not d or not os.path.isdir(d):
        return 0
    d = Path(d)
    return sum(1 for f in d.iterdir()
               if f.name.startswith("lib") and f.name.endswith(".so"))


__all__ = ["ENV_KNOB", "HITS", "MISSES", "cache_entries",
           "compile_cache_dir", "note_lookup"]
