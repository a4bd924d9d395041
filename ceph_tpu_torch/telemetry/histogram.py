"""Log-bucketed latency histograms with exact quantile readout.

The HdrHistogram discipline (and the reference's
``PerfCounters::histogram`` / ``mon_command_latency`` axes): values are
bucketed on a log2 grid with ``SUB`` linear sub-buckets per octave, so
relative bucket resolution is 1/SUB (~1.6% at SUB=64) at every
magnitude — microsecond dispatch latencies and multi-second recovery
ops share one structure with bounded memory (a sparse dict of hit
buckets, not a dense array).

A copy of ``ceph_tpu/telemetry/histogram.py``.  Quantile semantics:

- ``quantile(p)`` returns the lower edge of the bucket containing rank
  ``min(n, max(1, ceil(p * n)))``, clamped into ``[min, max]`` of the
  exact observed extremes.  The clamp makes the degenerate cases
  exact: a single-sample histogram answers every quantile with the
  sample itself, and p=0/p=1 answer the true min/max.
- A value on a bucket's lower edge lands in THAT bucket (half-open
  ``[lower, upper)`` intervals), so boundary values round-trip
  exactly through ``quantile``.
- Empty histogram: every quantile is None.

Everything is host-side pure Python, so recording in the hot host
paths costs two dict operations.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

from ..utils.locks import make_lock

# linear sub-buckets per power-of-two octave: relative resolution 1/64
SUB = 64
# frexp exponent bias so indexes stay non-negative for every positive
# double (frexp exponents reach -1073 for subnormals)
_EXP_BIAS = 1100

# default exemplar capacity for NEW histograms: 0 = off.
# The tracing plane raises this while a collector is installed
# (telemetry/tracing.py::install), so SLO/latency histograms created
# during a traced run retain their top-quantile exemplars — p99+
# samples in SLO reports and flight-recorder dumps then link straight
# to their traces.
_default_exemplars = 0


def default_exemplars() -> int:
    return _default_exemplars


def set_default_exemplars(n: int) -> int:
    """Set the exemplar capacity new histograms are born with;
    returns the previous value.  Existing histograms are unaffected
    (capacity is fixed at construction — a dump's shape never changes
    under a live histogram)."""
    global _default_exemplars
    prev = _default_exemplars
    _default_exemplars = max(0, int(n))
    return prev


def bucket_index(value: float) -> int:
    """The bucket holding ``value`` (> 0); buckets are half-open
    ``[lower, upper)`` on the log2/SUB grid."""
    m, e = math.frexp(value)          # value = m * 2**e, m in [0.5, 1)
    sub = int((m - 0.5) * 2 * SUB)
    if sub >= SUB:                    # m == 1.0 - epsilon rounding guard
        sub = SUB - 1
    return (e + _EXP_BIAS) * SUB + sub


def bucket_lower(index: int) -> float:
    """The inclusive lower edge of bucket ``index``."""
    e = index // SUB - _EXP_BIAS
    sub = index % SUB
    return (0.5 + sub / (2 * SUB)) * 2.0 ** e


class LatencyHistogram:
    """Sparse log-bucketed histogram over non-negative floats
    (seconds by convention; the unit is the caller's contract)."""

    def __init__(self, exemplars: Optional[int] = None) -> None:
        self._lock = make_lock("telemetry.histogram.LatencyHistogram._lock")
        self._buckets: Dict[int, int] = {}
        self._zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # bounded top-quantile exemplars (value, insertion seq, id):
        # the largest `exemplar_capacity` recordings that carried an
        # exemplar id — deterministic (seq breaks value ties), so a
        # seeded run dumps byte-identical exemplar lists
        self.exemplar_capacity = (_default_exemplars
                                  if exemplars is None
                                  else max(0, int(exemplars)))
        self._exemplars: List[Tuple[float, int, str]] = []
        self._exemplar_seq = 0

    def record(self, value: float, exemplar: Optional[str] = None
               ) -> None:
        if value < 0:
            raise ValueError(f"latency {value} must be >= 0")
        with self._lock:
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            if value == 0.0:
                self._zeros += 1
            else:
                idx = bucket_index(value)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            if exemplar is not None and self.exemplar_capacity:
                self._exemplar_seq += 1
                self._note_exemplar(value, self._exemplar_seq,
                                    str(exemplar))

    def _note_exemplar(self, value: float, seq: int,
                       ident: str) -> None:
        """Keep the top-capacity exemplars by (value, seq) — the
        newest wins a value tie, so the retained set is a pure
        function of the recording order.  O(1) for the common case (a
        full set and a value below the weakest retained one), so a
        million-sample run pays nothing past warmup."""
        ex = self._exemplars
        if len(ex) >= self.exemplar_capacity and value < ex[-1][0]:
            return
        bisect.insort(ex, (value, seq, ident),
                      key=lambda e: (-e[0], -e[1]))
        del ex[self.exemplar_capacity:]

    def exemplars(self) -> List[dict]:
        """The retained top-quantile exemplars, largest first."""
        with self._lock:
            return [{"value": v, "trace_id": i}
                    for v, _s, i in self._exemplars]

    def quantile(self, p: float) -> Optional[float]:
        """See the module docstring for the exact semantics."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"quantile {p} must be in [0, 1]")
        with self._lock:
            if self.count == 0:
                return None
            rank = min(self.count, max(1, math.ceil(p * self.count)))
            if rank == self.count:
                # the top rank is the exact observed max, not its
                # bucket's lower edge (p=1.0 — and every p once n*p
                # rounds up to n — must answer the true max)
                return self.max
            cum = self._zeros
            if cum >= rank:
                return 0.0
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= rank:
                    lo = bucket_lower(idx)
                    return max(self.min, min(lo, self.max))
            return self.max  # unreachable unless counts drift

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50),
                "p99": self.quantile(0.99),
                "p999": self.quantile(0.999)}

    def to_dict(self) -> dict:
        """Deterministic JSON-ready dump (bucket keys sorted as
        strings of ints; byte-identical given identical recordings)."""
        with self._lock:
            buckets = {str(i): self._buckets[i]
                       for i in sorted(self._buckets)}
            if self._zeros:
                buckets = {"zero": self._zeros, **buckets}
            base = {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max}
            exemplars = [{"value": v, "trace_id": i}
                         for v, _s, i in self._exemplars]
        base.update(self.percentiles())
        base["buckets"] = buckets
        if exemplars:
            # only when captured: a capacity-0 (or exemplar-less)
            # histogram dumps without the key, so pinned fake-clock
            # dumps stay as they were
            base["exemplars"] = exemplars
        return base

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other``'s recordings into this histogram — exact, not
        approximate: both share the same log2/SUB grid, so bucket
        counts add and the min/max extremes combine losslessly (the
        serve SLA report's all-ops roll-up rides this)."""
        with other._lock:
            buckets = dict(other._buckets)
            zeros = other._zeros
            count, total = other.count, other.sum
            omin, omax = other.min, other.max
            oex = list(other._exemplars)
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._zeros += zeros
            self.count += count
            self.sum += total
            if omin is not None and (self.min is None or omin < self.min):
                self.min = omin
            if omax is not None and (self.max is None or omax > self.max):
                self.max = omax
            if oex:
                self.exemplar_capacity = max(self.exemplar_capacity,
                                             other.exemplar_capacity)
                for v, _s, i in oex:
                    self._exemplar_seq += 1
                    self._note_exemplar(v, self._exemplar_seq, i)

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._zeros = 0
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None
            self._exemplars.clear()
            self._exemplar_seq = 0


__all__ = ["SUB", "LatencyHistogram", "bucket_index", "bucket_lower",
           "default_exemplars", "set_default_exemplars"]
