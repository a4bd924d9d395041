"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``lib<name>-<hash>.so`` in
the build directory, and loaded with ``ctypes``.  No PyTorch header is
included, so a build takes seconds rather than minutes.  The build
runs on first CUDA use (never at import), one ``nvcc`` per source, all
started together; the hash of the source, the shared headers
(``csrc/*.cuh``) and the flags names the library, so an edited source
or header is rebuilt and a built one is reused.  The build directory is
``build/`` beside this file (listed in ``.gitignore``), or the kernel
build cache ``CEPH_TPU_COMPILE_CACHE`` names (utils/compile_cache.py):
there a second process, or a second checkout of the same sources,
loads the libraries and runs no ``nvcc``.  Each library looked for
counts as a build-cache hit or miss.

A failed build raises :class:`KernelBuildError`; nothing falls back to
the torch tier.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

from ..telemetry import metrics as tel
from ..utils.compile_cache import compile_cache_dir, note_lookup
from ..utils.errors import KernelBuildError
from ..utils.locks import make_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_lock = make_lock("ops._build._lock")
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source printed (the ptxas register and
# spill report of -Xptxas -v)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def build_dir() -> Path:
    """Where libraries are built and looked for: the kernel build cache
    when one is configured, else BUILD_DIR."""
    d = compile_cache_dir()
    return Path(d) if d else BUILD_DIR


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that
    have no up-to-date library yet, in parallel; return name -> path."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
        missing = set(names) - {s.stem for s in srcs}
        if missing:
            raise KernelBuildError(f"no kernel source for {sorted(missing)}")
    bdir = build_dir()
    bdir.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = []
    for src in srcs:
        target = _target(src)
        out[src.stem] = target
        note_lookup(target.exists())
        if target.exists():
            continue
        # a temporary file of this call's own (two threads or processes
        # building one source never write into one file)
        fd, name = tempfile.mkstemp(dir=bdir, prefix=target.name + ".",
                                    suffix=".tmp")
        os.close(fd)
        tmp = Path(name)
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)   # atomic: concurrent builds race safely
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (a
    kernel setup in the metrics plane, ``telemetry.metrics``).  The
    build and the load run outside the lock, which guards only the
    table of loaded libraries: ``nvcc`` takes seconds, and a second
    thread racing the first builds into a temporary file of its own
    (the rename is atomic) and keeps whichever library was loaded
    first."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    with _lock:
        first = _libs.setdefault(name, lib)
    if first is lib:
        tel.note_kernel_setup()
    return first
