"""Benchmark sweep — qa/workunits/erasure-code/bench.sh analog; a port
of ``ceph_tpu/bench/sweep.py``.

Runs the erasure-code benchmark across a grid of (plugin, technique,
k, m, workload) cells and prints one JSON line per cell (the reference
script collects the same sweep for its plot.js report).

  python -m ceph_tpu_torch.bench.sweep                 # default grid
  python -m ceph_tpu_torch.bench.sweep --loop 64 --size $((1<<20))
  python -m ceph_tpu_torch.bench.sweep --plugin jerasure --device cpu

Cells run on the card (``--device cuda``, the default) unless the caller
asks for the CPU (``--device cpu``) or the numpy region ops (``--device
host``).  Cells that a profile rejects (e.g. r6_op with m != 2) are
reported with "error" and skipped, like the reference script's soft
failures.  A failure of the device itself — no card, a kernel that does
not build or launch, a dispatch the supervisor gave up on, a CUDA error
— is never a soft failure: it propagates and the sweep exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..utils.errors import (DeviceDispatchError, KernelBuildError,
                            KernelLaunchError, NoDeviceError)
from .erasure_code_benchmark import ErasureCodeBench

# (plugin, profile-params) grid mirroring bench.sh's PLUGINS/TECHNIQUES
DEFAULT_GRID = [
    ("jerasure", {"technique": "reed_sol_van"}),
    ("jerasure", {"technique": "reed_sol_r6_op"}),
    ("jerasure", {"technique": "cauchy_good", "packetsize": "2048"}),
    ("jerasure", {"technique": "liberation", "packetsize": "2048"}),
    ("isa", {"technique": "reed_sol_van"}),
    ("isa", {"technique": "cauchy"}),
    ("shec", {"c": "2"}),
    ("clay", {}),
    ("lrc", {}),
]
DEFAULT_KM = [(4, 2), (8, 3), (8, 4)]

# failures of the device, never of a cell's profile
_DEVICE_ERRORS = tuple(c for c in (
    NoDeviceError, KernelBuildError, KernelLaunchError,
    DeviceDispatchError, torch.cuda.OutOfMemoryError,
    getattr(torch, "AcceleratorError", None)) if c is not None)


def _device_failure(e: BaseException) -> bool:
    """Whether ``e`` is the device's failure (propagate) rather than a
    profile's rejection (soft-fail the cell)."""
    return (isinstance(e, _DEVICE_ERRORS)
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def run_cell(plugin: str, params: dict, k: int, m: int, workload: str,
             a) -> dict:
    cell = {"plugin": plugin, "k": k, "m": m, "workload": workload,
            **params}
    try:
        return _run_cell_inner(cell, plugin, params, k, m, workload, a)
    except Exception as e:  # noqa: BLE001 - soft-fail a grid cell
        if _device_failure(e):
            raise
        cell["error"] = f"{type(e).__name__}: {e}"
        return cell


def _run_cell_inner(cell, plugin, params, k, m, workload, a) -> dict:
    argv = ["--plugin", plugin, "--workload", workload,
            "--size", str(a.size), "--iterations", str(a.iterations),
            "--batch", str(a.batch), "--device", a.device]
    if a.loop and a.device == "cuda":
        argv += ["--loop", str(a.loop)]
    if workload == "decode":
        argv += ["--erasures", str(min(m, a.erasures))]
    prof = dict(params)
    prof.update({"k": str(k), "m": str(m)})
    if plugin == "lrc":
        # lrc kml generation needs locality l with l | (k+m) and
        # ((k+m)/l) | m (ErasureCodeLrc::parse_kml constraints); some
        # (k,m) have no valid l — those cells soft-fail like bench.sh
        l = next((c for c in range(k + m - 1, 1, -1)
                  if (k + m) % c == 0 and m % ((k + m) // c) == 0),
                 None)
        if l is None:
            raise ValueError(f"no lrc locality l fits k={k} m={m}")
        prof["l"] = str(l)
    for key, val in prof.items():
        argv += ["--parameter", f"{key}={val}"]
    bench = ErasureCodeBench()
    bench.setup(argv)
    res = bench.run()
    cell.update(gbps=round(res["gbps"], 3),
                seconds=round(res["seconds"], 4),
                total_bytes=res["total_bytes"])
    return cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ec-sweep",
                                description=__doc__.split("\n")[0])
    p.add_argument("--plugin", action="append",
                   help="restrict to plugin (repeatable)")
    p.add_argument("--workload", action="append",
                   choices=["encode", "decode"],
                   help="restrict workloads (default: both)")
    p.add_argument("--size", type=int, default=1 << 18)
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--loop", type=int, default=0)
    p.add_argument("--erasures", type=int, default=1)
    p.add_argument("--device", choices=["host", "cuda", "cpu"],
                   default="cuda")
    p.add_argument("--km", action="append", metavar="K,M",
                   help="k,m pair (repeatable; default 4,2 8,3 8,4)")
    a = p.parse_args(argv)

    kms = [tuple(int(v) for v in s.split(",")) for s in a.km] \
        if a.km else DEFAULT_KM
    workloads = a.workload or ["encode", "decode"]
    known = {plugin for plugin, _ in DEFAULT_GRID}
    for name in a.plugin or []:
        if name not in known:
            p.error(f"unknown plugin {name!r}; grid has "
                    f"{', '.join(sorted(known))}")
    for plugin, params in DEFAULT_GRID:
        if a.plugin and plugin not in a.plugin:
            continue
        for k, m in kms:
            for workload in workloads:
                cell = run_cell(plugin, params, k, m, workload, a)
                print(json.dumps(cell), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
