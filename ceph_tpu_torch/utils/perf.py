"""Perf counters — src/common/perf_counters.{h,cc} role.

The same named-counter registry as ``ceph_tpu.utils.perf`` (u64
``inc``, time-average ``tinc``, gauges), and :func:`profile_trace`, a
``torch.profiler`` trace in place of the JAX profiler hook.
The codec mixins count host and device calls and bytes here
(``ec_host_calls``, ``ec_device_calls``, ...); ``dump()`` returns the
JSON-shaped dict the reference's ``perf dump`` emits.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from .locks import make_lock


class PerfCounters:
    """Named counters: u64 ``inc``, time-average ``tinc`` (count + sum
    seconds), gauges via ``set_gauge``.  One name, one kind: ``dump()``
    flattens all three stores into one namespace, so cross-kind reuse
    of a name raises."""

    def __init__(self, name: str = "ceph_tpu_torch") -> None:
        self.name = name
        self._lock = make_lock("utils.perf.PerfCounters._lock")
        self._u64: Dict[str, int] = {}
        self._time: Dict[str, list] = {}   # name -> [count, sum_seconds]
        self._gauge: Dict[str, float] = {}
        self._kind: Dict[str, str] = {}

    def _claim(self, counter: str, kind: str) -> None:
        owner = self._kind.setdefault(counter, kind)
        if owner != kind:
            raise ValueError(
                f"perf counter {counter!r} is a {owner}, not a {kind} "
                f"— the flat dump namespace would collide")

    def inc(self, counter: str, v: int = 1) -> None:
        with self._lock:
            self._claim(counter, "u64")
            self._u64[counter] = self._u64.get(counter, 0) + v

    def tinc(self, counter: str, seconds: float) -> None:
        with self._lock:
            self._claim(counter, "time")
            entry = self._time.setdefault(counter, [0, 0.0])
            entry[0] += 1
            entry[1] += seconds

    def set_gauge(self, counter: str, v: float) -> None:
        with self._lock:
            self._claim(counter, "gauge")
            self._gauge[counter] = v

    def get(self, counter: str) -> int:
        """Current value of a u64 counter (0 when never incremented)."""
        with self._lock:
            return self._u64.get(counter, 0)

    @contextlib.contextmanager
    def timed(self, counter: str):
        """Time a block (host clock) into a ``tinc`` pair."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.tinc(counter, time.perf_counter() - t0)

    def reset(self) -> None:
        with self._lock:
            self._u64.clear()
            self._time.clear()
            self._gauge.clear()
            self._kind.clear()

    def dump(self) -> dict:
        """`ceph daemon X perf dump` shape: {registry: {counter: value
        | {avgcount, sum}}}."""
        with self._lock:
            out: Dict[str, object] = dict(self._u64)
            for k, (n, s) in self._time.items():
                out[k] = {"avgcount": n, "sum": s}
            out.update(self._gauge)
            return {self.name: out}


_GLOBAL = PerfCounters()


def global_perf() -> PerfCounters:
    """The process-wide registry (the per-CephContext singleton role)."""
    return _GLOBAL


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """No-op when ``log_dir`` is falsy, else records a ``torch.profiler``
    trace of the block (host, and the card's kernels where there is a
    card) into ``log_dir/trace.json`` (Chrome trace format)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
