"""One run of one cell: find the card, set up, measure, compare, print.

``run_cell`` does the work on any device and returns the run and its
result line; ``main`` is the command: it refuses to run without the
cards the cell asks for, and refuses to print a result if the process
has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import spec
from .trace import breakdown

# top-level module names that may not be loaded in a benchmark run
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names ``sys.modules`` holds, compared as
    whole names (``ceph_tpu_torch`` is not ``ceph_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, inject=None):
    """(Run, result line as a dict) of one run on ``device``."""
    run = spec.kind(cell.traffic).run(cell, seed, seconds, trace, device,
                                      t_start, inject)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                run, cell.here)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in run.checks),
            "attempted": run.requests, "failed": int(run.failed),
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = breakdown(run.trace)
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in run.checks}
    return run, line


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--inject", default=None,
                   help="plant a control or fault in the timed path "
                        "(yardstick/faults.py); for checking the "
                        "comparison only")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run, line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device, t_start, args.inject)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"requests {run.requests}, completed in the window "
          f"{run.completed_in_window()}, latency p99 "
          f"{np.percentile(run.latency_s(), 99) * 1e3:.6f} ms, answers "
          f"compared {run.sampled} in {run.check_s:.3f} s", file=sys.stderr)
    print("setup_s " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 run.setup_parts.items()), file=sys.stderr)
    if run.bound_s:
        print(f"least device time a request {run.bound_s * 1e3:.6f} ms "
              f"(by {run.bound_by})", file=sys.stderr)
    for c in run.checks:
        print(f"{c.name} {c.value} limit {c.limit}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


__all__ = ["FORBIDDEN", "forbidden_modules", "main", "parse", "run_cell"]
