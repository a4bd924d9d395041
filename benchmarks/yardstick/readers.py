"""What the metric readers share: which device ops are the program's GF
kernels, and the checks that a run is of the kind a metric reads."""

from __future__ import annotations

import re

# the port's GF kernels (ops/csrc/*.cu) are named gf_*, gf2_*, gf8_*
GF_KERNEL = re.compile(r"^(void\s+)?gf[0-9]*_")


def is_gf_kernel(name: str) -> bool:
    return bool(GF_KERNEL.match(name))


def ec(run, op: str) -> bool:
    """True for a run of EC requests of ``op`` ("encode" or "decode")."""
    return run.op == op and run.requests > 0


def traced(run) -> bool:
    return run.trace is not None and run.trace.busy_s > 0


__all__ = ["GF_KERNEL", "ec", "is_gf_kernel", "traced"]
