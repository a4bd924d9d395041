"""Causal tracing plane — per-request trace propagation across the
serving seams.

A copy of ``ceph_tpu/telemetry/tracing.py`` without its selftest;
``telemetry/analyzer.py`` reads the dumps:

- A :class:`TraceContext` is minted at serve admission
  (serve/queue.py::AdmissionQueue.submit) and rides the request through
  the batcher's bucket assignment and fire decision, and the program
  the batch rode (codes/engine.py dispatch seams note it).
- Trace ids are **seeded, never wall-clock**: sha1 of
  ``(collector seed, kind, sequence)``.
- Timestamps are read from the collector's **injectable clock** and
  quantized to integer nanoseconds at record time.
- **Off by default.**  Tracing records nothing until a collector is
  installed (:func:`install`), either programmatically or via
  ``CEPH_TPU_TRACE=`` (empty/``0`` = off, ``1``/``on`` = sample
  everything, a float like ``0.01`` = that sampling rate) consulted by
  the serving event loop at run start.  Every hook site guards on
  :func:`enabled` — one module-global ``is None`` check.
- **Sampling-gated.**  Client traces are minted per request only when
  the deterministic per-request sampling draw (crc32 of
  ``seed:req_id``) passes; an unsampled request carries ``trace=None``
  and every downstream hook is a no-op.
"""

from __future__ import annotations

import hashlib
import os
import threading
import zlib
from typing import Dict, List, Optional

from .metrics import series_name
from ..utils.locks import make_lock

TRACE_SCHEMA_VERSION = 1

# the reference analyzer's segment taxonomy: its decompose sums these
# exactly (integer nanoseconds) to a trace's end-to-end latency
SEGMENTS = ("queue_wait", "batch_wait", "arbiter_hold",
            "retry_backoff", "device_dispatch", "demux")

# exemplar capacity installed on new LatencyHistograms while a
# collector is active (telemetry/histogram.py) — p99+ samples in SLO
# reports and flight-recorder dumps then carry their trace ids
EXEMPLAR_CAPACITY = 4

_SAMPLE_MOD = 1_000_000


def _ns(t: float) -> int:
    """Quantize a clock reading to integer nanoseconds — the unit all
    segment arithmetic happens in, so sums are exact."""
    return int(round(t * 1e9))


def trace_id_for(seed: int, kind: str, num: int) -> str:
    """The deterministic trace id: seeded, never wall-clock."""
    h = hashlib.sha1(f"{seed}:{kind}:{num}".encode()).hexdigest()
    return h[:16]


class TraceContext:
    """One request's (or background unit's) causal trace: an ordered
    list of timestamped events, each a seam crossing."""

    __slots__ = ("trace_id", "kind", "num", "op", "attrs", "events")

    def __init__(self, trace_id: str, kind: str, num: int, op: str,
                 attrs: Optional[Dict[str, object]] = None) -> None:
        self.trace_id = trace_id
        self.kind = kind                # "client" | "recovery"
        self.num = num                  # req_id / background sequence
        self.op = op
        self.attrs = dict(attrs or {})
        self.events: List[dict] = []

    def add(self, name: str, t: float, **attrs) -> None:
        """Record one seam crossing at clock time ``t`` (seconds on
        the collector's clock; stored as integer ns)."""
        ev = {"name": name, "t_ns": _ns(t)}
        if attrs:
            ev.update({k: attrs[k] for k in sorted(attrs)})
        self.events.append(ev)

    def event(self, name: str) -> Optional[dict]:
        for ev in self.events:
            if ev["name"] == name:
                return ev
        return None

    def to_dict(self) -> dict:
        out = {"trace_id": self.trace_id, "kind": self.kind,
               "num": self.num, "op": self.op,
               "events": list(self.events)}
        if self.attrs:
            out["attrs"] = {k: self.attrs[k]
                            for k in sorted(self.attrs)}
        return out


class TraceCollector:
    """The process trace sink: client traces, background charge
    intervals, QoS decisions, supervisor retry intervals and
    annotations — everything the critical-path analyzer
    (telemetry/analyzer.py) needs to attribute a tail sample.

    ``clock`` is injectable (FakeClock in tests/sim) — with a seeded
    scenario the whole export is byte-identical across runs.
    ``sample`` gates client-trace minting per request id
    (deterministic crc32 draw).  ``max_traces`` bounds memory: past
    the cap new traces are dropped and counted, never silently."""

    def __init__(self, clock=None, seed: int = 0, sample: float = 1.0,
                 max_traces: int = 4096) -> None:
        from ..utils.detcheck import default_clock
        from ..utils.retry import SystemClock

        self.clock = clock if clock is not None \
            else default_clock("telemetry.tracing.TraceCollector",
                               SystemClock)
        self.seed = int(seed)
        self.sample = float(sample)
        self.max_traces = int(max_traces)
        self._lock = make_lock("telemetry.tracing.TraceCollector._lock")
        self.traces: List[TraceContext] = []
        self.dropped = 0
        # per-tenant sampling overrides (multi-tenant weeks): tenant
        # name -> sample rate; tenants not listed use ``sample``.
        # ``dropped_by`` counts max_traces drops per tenant ("" = the
        # untenanted legacy streams) — the hard memory bound stays
        # one number (max_traces), the accounting says who paid it
        self.tenant_sample: Dict[str, float] = {}
        self.dropped_by: Dict[str, int] = {}
        self._aux_seq = 0
        # background charge intervals: work that aged waiting client
        # requests on the shared clock (the arbiter_hold numerator)
        self.background: List[dict] = []
        # mClock decisions with pressure/scale at decision time
        self.qos: List[dict] = []
        # supervisor retry backoff intervals (the retry_backoff carve)
        self.retries: List[dict] = []
        # point annotations (demotions, quarantines, re-promotions)
        self.annotations: List[dict] = []

    # -- minting ---------------------------------------------------------

    def set_tenant_sample(self, rates: Dict[str, float]) -> None:
        """Install per-tenant sampling rates (replaces the whole
        map; scenario/week.py sets it from the TenantSpec roster)."""
        with self._lock:
            self.tenant_sample = {str(k): float(v)
                                  for k, v in rates.items()}

    def sampled(self, num: int, tenant: Optional[str] = None) -> bool:
        rate = self.sample
        if tenant is not None:
            rate = self.tenant_sample.get(tenant, rate)
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        draw = zlib.crc32(f"{self.seed}:{num}".encode()) % _SAMPLE_MOD
        return draw < int(rate * _SAMPLE_MOD)

    def begin(self, kind: str, num: Optional[int] = None,
              op: str = "", **attrs) -> Optional[TraceContext]:
        """Mint one trace (no sampling — callers sample client
        requests via :func:`mint`).  Returns None past ``max_traces``
        (dropped, counted)."""
        with self._lock:
            if len(self.traces) >= self.max_traces:
                self.dropped += 1
                t = str(attrs.get("tenant", ""))
                self.dropped_by[t] = self.dropped_by.get(t, 0) + 1
                return None
            if num is None:
                num = self._aux_seq
                self._aux_seq += 1
            ctx = TraceContext(
                trace_id_for(self.seed, kind, num), kind, num, op,
                attrs)
            self.traces.append(ctx)
            return ctx

    # -- the non-request streams -----------------------------------------

    def add_background(self, cls: str, t0: float, t1: float,
                       **attrs) -> None:
        iv = {"cls": cls, "t0_ns": _ns(t0), "t1_ns": _ns(t1)}
        if attrs:
            iv.update({k: attrs[k] for k in sorted(attrs)})
        with self._lock:
            self.background.append(iv)

    def add_qos(self, cls: str, granted: bool, why: str, t: float,
                pressure: float, scale: float) -> None:
        with self._lock:
            self.qos.append({
                "cls": cls, "granted": granted, "why": why,
                "t_ns": _ns(t), "pressure": round(pressure, 6),
                "scale": round(scale, 6)})

    def add_retry(self, seam: str, t0: float, t1: float,
                  **attrs) -> None:
        iv = {"seam": seam, "t0_ns": _ns(t0), "t1_ns": _ns(t1)}
        if attrs:
            iv.update({k: attrs[k] for k in sorted(attrs)})
        with self._lock:
            self.retries.append(iv)

    def annotate(self, kind: str, t: float, **attrs) -> None:
        ev = {"kind": kind, "t_ns": _ns(t)}
        if attrs:
            ev.update({k: attrs[k] for k in sorted(attrs)})
        with self._lock:
            self.annotations.append(ev)

    # -- export ----------------------------------------------------------

    def to_dict(self) -> dict:
        """The schema_version'd trace dump."""
        with self._lock:
            return {
                "trace_schema_version": TRACE_SCHEMA_VERSION,
                "seed": self.seed,
                "sample": self.sample,
                "dropped": self.dropped,
                "traces": [t.to_dict() for t in self.traces],
                "background": list(self.background),
                "qos": list(self.qos),
                "retries": list(self.retries),
                "annotations": list(self.annotations),
            } | ({"tenant_sample": dict(sorted(
                self.tenant_sample.items())),
                "dropped_by": dict(sorted(self.dropped_by.items()))}
                if self.tenant_sample or self.dropped_by else {})

    def to_json(self, indent: Optional[int] = None) -> str:
        import json
        return json.dumps(self.to_dict(), sort_keys=True,
                          indent=indent,
                          separators=(",", ": ") if indent
                          else (",", ":"))

    def reset(self) -> None:
        with self._lock:
            self.traces.clear()
            self.background.clear()
            self.qos.clear()
            self.retries.clear()
            self.annotations.clear()
            self.dropped = 0
            self.dropped_by.clear()
            self._aux_seq = 0


# ----------------------------------------------------------------------
# the process collector (None = tracing off; EVERY hook site gates on
# this single check, so the disabled hot path is one load + compare)

_active: Optional[TraceCollector] = None
_lock = make_lock("telemetry.tracing._lock")
_tls = threading.local()


def enabled() -> bool:
    return _active is not None


def active() -> Optional[TraceCollector]:
    return _active


def install(collector: Optional[TraceCollector]
            ) -> Optional[TraceCollector]:
    """Install (or, with None, remove) the process trace collector;
    returns the previous one.  Installing also raises the default
    LatencyHistogram exemplar capacity so SLO/latency histograms
    created while tracing is live retain top-quantile exemplars
    carrying trace ids (telemetry/histogram.py)."""
    global _active
    from .histogram import set_default_exemplars
    with _lock:
        prev = _active
        _active = collector
        set_default_exemplars(EXEMPLAR_CAPACITY
                              if collector is not None else 0)
        return prev


def maybe_install_from_env(clock=None, seed: int = 0
                           ) -> Optional[TraceCollector]:
    """The ``CEPH_TPU_TRACE`` opt-in, consulted by the scenario
    event loops at run start: installs a collector when the env knob asks
    for one and none is active.  Returns the active collector (new or
    pre-existing) or None."""
    if _active is not None:
        return _active
    raw = os.environ.get("CEPH_TPU_TRACE", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return None
    if raw in ("1", "on", "true", "yes"):
        rate = 1.0
    else:
        try:
            rate = max(0.0, min(1.0, float(raw)))
        except ValueError:
            return None
    coll = TraceCollector(clock=clock, seed=seed, sample=rate)
    install(coll)
    return coll


# ----------------------------------------------------------------------
# hook-site helpers (all no-ops when no collector is installed)

def mint(req) -> None:
    """Mint a client trace at serve admission (the request's
    ``arrival`` stamp is the trace's first event, so the trace and the
    SLO ledger measure from the same instant)."""
    c = _active
    tenant = getattr(req, "tenant", "")
    if c is None or not c.sampled(req.req_id,
                                  tenant if tenant else None):
        return
    attrs = {"plugin": req.plugin, "stripe_size": req.stripe_size}
    if tenant:
        attrs["tenant"] = tenant
    ctx = c.begin("client", req.req_id, req.op, **attrs)
    if ctx is None:
        return
    ctx.add("admit", req.arrival,
            deadline_ns=_ns(req.deadline)
            if req.deadline is not None else None)
    req.trace = ctx


def note_program(name: str, labels: Dict[str, object]) -> None:
    """The engine dispatch seams' link: record the profiler program
    series the CURRENT dispatch rode (thread-local — the batcher picks
    it up right after ``_execute`` and attaches it to every request in
    the fired batch, joining traces to ``attribution_rows()``)."""
    if _active is None:
        return
    _tls.program = series_name(
        name, tuple(sorted((str(k), str(v))
                           for k, v in labels.items())))


def clear_program() -> None:
    _tls.program = None


def take_program() -> Optional[str]:
    prog = getattr(_tls, "program", None)
    _tls.program = None
    return prog


def note_retry(seam: str, t0: float, t1: float, **attrs) -> None:
    c = _active
    if c is not None:
        c.add_retry(seam, t0, t1, **attrs)


def annotate(kind: str, t: float, **attrs) -> None:
    c = _active
    if c is not None:
        c.annotate(kind, t, **attrs)


__all__ = ["EXEMPLAR_CAPACITY", "SEGMENTS", "TRACE_SCHEMA_VERSION",
           "TraceCollector", "TraceContext", "active", "annotate",
           "clear_program", "enabled", "install",
           "maybe_install_from_env", "mint", "note_program",
           "note_retry", "take_program", "trace_id_for"]
