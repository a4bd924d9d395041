"""Build the native tree that reaches the card: the plugin registry, the
AVX2 ``rs`` plugin, the ``cuda`` bridge plugin and the tools.

``python -m ceph_tpu_torch.native.build`` compiles, with the host's
``c++`` (no cmake: the card's machine is promised a C++ compiler, since
``nvcc`` needs one, but not cmake or ninja), into ``build/`` beside this
file (listed in ``.gitignore``):

- ``libceph_tpu_ec.so`` from ``native/src/{interface,plugin,gf8}.cc``
  (``gf8.cc`` with ``-mavx2``, as ``native/CMakeLists.txt`` does);
- ``libec_rs.so``, the AVX2 Reed-Solomon plugin (``native/plugins/rs.cc``);
- ``libec_cuda.so``, the embedded-CPython bridge onto this package
  (``plugins/cuda.cc``): ``plugin=cuda`` for any consumer of the
  registry;
- ``ceph_erasure_code_benchmark`` and ``ceph_erasure_code`` from
  ``native/tools/``, and ``bridge_mt`` (``tools/bridge_mt.cc``).

Every file links with ``-Wl,-rpath,$ORIGIN``, so the tools find the
registry and the plugins beside them.  Python's include directory and
shared ``libpython`` come from ``sysconfig``; where no shared
``libpython`` exists the interpreter cannot be embedded, and the build
says so.  ``native/CMakeLists.txt`` and ``native/build/`` are neither read
nor written.

The build runs under a file lock (``build/.lock``: parallel test workers
share the directory) and only when the hash of the sources, the headers,
the flags and the interpreter differs from the last build's
(``build/.stamp``); each output is written to a temporary file first and
renamed into place, so a process that has one loaded keeps its copy.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Dict, List

from ..utils.errors import CephTpuError

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
NATIVE = ROOT / "native"
BUILD_DIR = HERE / "build"
CXX_FLAGS = ["-std=c++17", "-O3", "-Wall", "-Wextra", "-fPIC"]
RPATH = "-Wl,-rpath,$ORIGIN"

# (output, sources, extra flags, links the registry, embeds python)
LIBRARY = "libceph_tpu_ec.so"
TARGETS = (
    ("libec_rs.so", ["native/plugins/rs.cc"], ["-shared"], True, False),
    ("libec_cuda.so", ["ceph_tpu_torch/native/plugins/cuda.cc"],
     ["-shared"], True, True),
    ("ceph_erasure_code_benchmark",
     ["native/tools/ceph_erasure_code_benchmark.cc"], [], True, False),
    ("ceph_erasure_code", ["native/tools/ceph_erasure_code.cc"], [], True,
     False),
    ("bridge_mt", ["ceph_tpu_torch/native/tools/bridge_mt.cc"],
     ["-pthread"], True, True),
)
OUTPUTS = (LIBRARY,) + tuple(t[0] for t in TARGETS)


class NativeBuildError(CephTpuError, RuntimeError):
    """The native tree could not be built."""


def _cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise NativeBuildError("no C++ compiler (c++, g++ or clang++) on PATH")


def python_flags() -> tuple:
    """(compile flags, link flags) that embed this interpreter: its
    include directory and its shared ``libpython`` (in ``LIBDIR``,
    ``LIBPL`` or the multiarch directory under ``LIBDIR``)."""
    var = sysconfig.get_config_var
    name = f"python{var('VERSION')}{var('ABIFLAGS') or ''}"
    libdir = var("LIBDIR") or ""
    dirs = [d for d in (libdir, var("LIBPL"),
                        os.path.join(libdir, var("MULTIARCH") or ""))
            if d]
    found = [d for d in dirs if (Path(d) / f"lib{name}.so").exists()]
    if not found:
        raise NativeBuildError(
            f"{sys.executable} has no shared libpython (lib{name}.so in "
            f"none of {dirs}): the cuda bridge embeds the interpreter "
            f"and needs one")
    libs = (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    cflags = ["-I" + sysconfig.get_paths()["include"]]
    ldflags = ["-L" + found[0], "-l" + name, "-Wl,-rpath," + found[0],
               *dict.fromkeys(libs)]
    return cflags, ldflags


def _c_string(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _python_defines() -> List[str]:
    return ["-DCEPH_TPU_PYROOT_DEFAULT=" + _c_string(str(ROOT)),
            "-DCEPH_TPU_PYTHON_DEFAULT=" + _c_string(sys.executable)]


def _commands(build_dir: Path, out: Dict[str, Path]) -> tuple:
    """(the registry's commands, in order; every other target's command,
    each independent of the others) writing into ``out``'s paths."""
    cxx = _cxx()
    inc = ["-I" + str(NATIVE / "include")]
    gf8_o = out["gf8.o"]
    first = [
        [cxx, *CXX_FLAGS, *inc, "-mavx2", "-c", "-o", str(gf8_o),
         str(NATIVE / "src" / "gf8.cc")],
        [cxx, *CXX_FLAGS, *inc, "-shared", "-o", str(out[LIBRARY]),
         str(NATIVE / "src" / "interface.cc"),
         str(NATIVE / "src" / "plugin.cc"), str(gf8_o), RPATH, "-ldl"],
    ]
    py_c, py_l = python_flags()
    rest = []
    for name, srcs, extra, registry, embed in TARGETS:
        cmd = [cxx, *CXX_FLAGS, *inc, *extra]
        if embed:
            cmd += py_c + _python_defines()
        cmd += ["-o", str(out[name]), *(str(ROOT / s) for s in srcs)]
        if registry:
            cmd += ["-L" + str(build_dir), "-l:" + LIBRARY]
        cmd += [RPATH, "-ldl"]
        if embed:
            cmd += py_l
        rest.append(cmd)
    return first, rest


def source_hash() -> str:
    """Hash of every input of the build: sources, headers, flags, the
    interpreter and the checkout it is built for."""
    h = hashlib.sha256()
    files = sorted((NATIVE / "include").rglob("*.h")) + [
        NATIVE / "src" / n for n in ("interface.cc", "plugin.cc", "gf8.cc",
                                     "gf8.h")]
    files += [ROOT / s for t in TARGETS for s in t[1]]
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode())
        h.update(f.read_bytes())
    h.update(" ".join(CXX_FLAGS + _python_defines()).encode())
    h.update(" ".join(python_flags()[0] + python_flags()[1]).encode())
    return h.hexdigest()


def _run(cmd: List[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stdout}"
            f"{proc.stderr}")


def _run_all(cmds: List[List[str]]) -> None:
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{log}")
    if failed:
        raise NativeBuildError("native build failed:\n" + "\n".join(failed))


def build() -> Dict[str, Path]:
    """Build (if any input changed) and return {output name: path}."""
    build_dir = BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: build_dir / name for name in OUTPUTS}
    want = source_hash()
    stamp = build_dir / ".stamp"
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if stamp.exists() and stamp.read_text() == want \
                and all(p.exists() for p in paths.values()):
            return paths
        with tempfile.TemporaryDirectory(dir=build_dir,
                                         prefix=".tmp-") as tmp:
            staged = {name: Path(tmp) / name for name in OUTPUTS}
            staged["gf8.o"] = Path(tmp) / "gf8.o"
            first, rest = _commands(Path(tmp), staged)
            for cmd in first:
                _run(cmd)
            _run_all(rest)
            # the registry first: a tool renamed into place finds the
            # library it was linked against beside it
            for name in OUTPUTS:
                os.replace(staged[name], paths[name])
        stamp.write_text(want)
    return paths


def main() -> int:
    try:
        paths = build()
    except NativeBuildError as e:
        print(f"native build: {e}", file=sys.stderr)
        return 1
    for name, path in paths.items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
