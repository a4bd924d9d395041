"""What one run leaves for the metric readers: the window on the host's
clock, each request's issue and completion, the host spans the loop
took, the program's counters, the cost of a request, and, in a traced
run, the device trace's summary."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Check:
    """One number compared beside its limit; the run is correct while
    every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Trace:
    """The device trace of the measured window."""
    window_s: float           # host seconds the trace spans
    busy_s: float             # union of device kernels, copies and sets
    op_s: dict                # device seconds by op name
    gaps_s: dict              # idle device seconds by the host's span

    def device_s(self, pred=lambda name: True) -> float:
        return sum(s for n, s in self.op_s.items() if pred(n))


@dataclass
class Run:
    op: str                   # "encode", "decode" or "remap"
    setup_s: float            # process start to the first timed request
    t0: float                 # the window on the host clock
    t1: float
    work: float               # data bytes (EC) or mappings (remap) each
    issued: np.ndarray        # host clock, per request
    done: np.ndarray          # when its completion was seen
    spans: dict = field(default_factory=dict)   # name -> [(start, end)]
    launches: int = 0         # program kernel launches over the window
    bound_s: Optional[float] = None   # least device seconds a request
    bound_by: str = ""
    trace: Optional[Trace] = None
    checks: list = field(default_factory=list)
    failed: int = 0
    sampled: int = 0          # answers compared
    memory_peak_bytes: int = 0
    check_s: float = 0.0      # seconds the comparison took
    setup_parts: dict = field(default_factory=dict)  # name -> seconds

    @property
    def requests(self) -> int:
        return len(self.issued)

    def completed_in_window(self) -> int:
        return int(np.count_nonzero(self.done <= self.t1))

    def rate(self) -> float:
        """Work of the requests completed inside the window over its
        seconds."""
        return self.completed_in_window() * self.work / (self.t1 - self.t0)

    def latency_s(self) -> np.ndarray:
        return self.done - self.issued

    def span_s(self, name: str) -> np.ndarray:
        return np.array([b - a for a, b in self.spans.get(name, ())])


__all__ = ["Check", "Run", "Trace"]
