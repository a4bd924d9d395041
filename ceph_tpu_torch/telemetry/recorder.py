"""Flight recorder — a bounded ring of recent observability state
that auto-dumps a deterministic post-mortem blob at failure choke
points; a copy of ``ceph_tpu/telemetry/recorder.py``.

Counters tell you *that* something went wrong; the flight recorder
tells you *what the process was doing right before*.  A bounded,
clock-injectable ring buffer collects recent structured events (every
``telemetry.metrics.event`` lands here too), compact summaries of
finished span roots (wire via :func:`install_flight_recorder`), and
explicit ``note()`` breadcrumbs from instrumented sites.  At a
trigger, :meth:`FlightRecorder.dump` freezes one post-mortem blob:
the ring, the last few span trees, a full metrics snapshot, and the
counter deltas since the previous dump.

Triggers (the failure choke points, each wired at its single source):

- ``unrecoverable``     — every :class:`~ceph_tpu_torch.utils.errors.
  UnrecoverableError` *construction* (the one choke point all raise
  sites share);
- ``crash_site``        — a chaos :class:`CrashPoint` firing an
  InjectedCrash at a named recovery crash site;
- ``recompile_budget``  — the PatternCache's armed recompile budget
  tripping (codes/engine.py);
- ``slo_burn``          — the serving deadline-miss burn-rate monitor
  (serve/sla.py) exceeding its error budget over a rolling window;
- ``backend_demoted`` / ``repromoted`` / ``output_corruption`` — the
  supervised dispatch plane (ops/supervisor.py): a live tier demotion
  (torch -> numpy, CPU tensors and host rows), the health probe's
  re-promotion, and self-verify catching a corrupted output;
- ``backend_lost``      — the fallback policy's log-once transition
  onto the numpy ground-truth tier (ops/fallback.py): in the port a
  live demotion's first step onto the floor, as a process without a
  card raises NoDeviceError; and the supervisor's persistent failure
  on the card, which it raises as DeviceDispatchError;
- ``device_quarantined`` / ``host_quarantined`` — the supervisor's
  reshrink of an active data plane (parallel/plane.py): a mesh member,
  or a whole host fault domain, evicted.

Dumps are **deterministic by construction**: entries carry a
monotonic ``seq`` and clock stamps from the injectable clock, the
metrics snapshot is the registry's sorted dump, and a FakeClock-fresh
seeded scenario produces a byte-identical blob across reruns, and the
same blob as the reference's on the same scenario
(tests/test_torch_recorder.py).  The last ``max_dumps`` blobs are kept in memory;
``CEPH_TPU_FLIGHT_DIR=<dir>`` additionally writes each blob to a JSON
file for post-mortem collection.

Host-side only: nothing here touches a device.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.detcheck import default_clock
from ..utils.log import dout
from ..utils.locks import make_lock

FLIGHT_SCHEMA_VERSION = 1
MAX_ENTRIES = 256
MAX_DUMPS = 4
MAX_DUMP_SPANS = 8

TRIGGERS = ("unrecoverable", "crash_site", "recompile_budget",
            "slo_burn", "backend_lost", "manual",
            # supervised dispatch plane (ops/supervisor.py): live
            # tier demotion, mesh-member quarantine, health-probe
            # re-promotion, and self-verify catching a corrupted
            # output buffer
            "backend_demoted", "device_quarantined", "repromoted",
            "output_corruption")


class _SystemClock:
    def monotonic(self) -> float:
        return time.monotonic()


class FlightRecorder:
    """Bounded ring of recent observability entries + post-mortem
    dumps at failure triggers."""

    def __init__(self, clock=None, max_entries: int = MAX_ENTRIES,
                 max_dumps: int = MAX_DUMPS) -> None:
        self.clock = clock if clock is not None \
            else default_clock("telemetry.recorder.FlightRecorder",
                               _SystemClock)
        self._lock = make_lock("telemetry.recorder.FlightRecorder._lock")
        self._entries: "deque[dict]" = deque(maxlen=max_entries)
        self._seq = 0
        self.dropped = 0
        self.dumps: "deque[dict]" = deque(maxlen=max_dumps)
        self.dump_count = 0
        self._last_counters: Dict[str, float] = {}

    # -- the ring --------------------------------------------------------

    def note(self, kind: str, **fields) -> None:
        """Append one breadcrumb to the ring (bounded: overflow drops
        the oldest and counts ``dropped``)."""
        with self._lock:
            self._seq += 1
            if len(self._entries) == self._entries.maxlen:
                self.dropped += 1
            self._entries.append(
                {"seq": self._seq,
                 "t": round(self.clock.monotonic(), 9),
                 "kind": kind,
                 **{k: fields[k] for k in sorted(fields)}})

    def note_span(self, span) -> None:
        """Compact summary of a finished root span (the SpanTracer
        ``on_root`` hook installed by install_flight_recorder)."""
        self.note("span", name=span.name,
                  duration=span.duration,
                  children=len(span.children))

    # -- the post-mortem blob --------------------------------------------

    @staticmethod
    def _numeric_series(mdump: dict) -> Dict[str, float]:
        flat: Dict[str, float] = {}
        for reg, body in mdump.items():
            if not isinstance(body, dict):
                continue
            for key, v in body.items():
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    flat[f"{reg}.{key}"] = v
        return flat

    def dump(self, trigger: str, reason: str = "",
             registry=None, tracer=None,
             max_spans: int = MAX_DUMP_SPANS, **fields) -> dict:
        """Freeze one post-mortem blob.  Never raises (a failed dump
        must not mask the failure that triggered it)."""
        from . import metrics as tel
        from .spans import global_tracer
        if registry is None:
            registry = tel.global_metrics()
        if tracer is None:
            tracer = global_tracer()
        try:
            mdump = registry.dump()
        except Exception:  # noqa: BLE001 — best-effort post-mortem
            mdump = {}
        try:
            spans = tracer.to_dict()
            spans["spans"] = spans["spans"][-max_spans:]
        except Exception:  # noqa: BLE001
            spans = {"spans": [], "dropped": 0}
        flat = self._numeric_series(mdump)
        with self._lock:
            delta = {k: round(v - self._last_counters.get(k, 0.0), 9)
                     for k, v in sorted(flat.items())
                     if v != self._last_counters.get(k, 0.0)}
            self._last_counters = flat
            self.dump_count += 1
            blob = {
                "flight_schema_version": FLIGHT_SCHEMA_VERSION,
                "dump": self.dump_count,
                "trigger": trigger,
                "reason": reason,
                "time": round(self.clock.monotonic(), 9),
                "context": {k: fields[k] for k in sorted(fields)},
                "entries": list(self._entries),
                "entries_dropped": self.dropped,
                "spans": spans,
                "metrics": mdump,
                "metrics_delta": delta,
            }
            self.dumps.append(blob)
        tel.counter("flight_recorder_dumps", trigger=trigger)
        # level 5: failure paths construct these in tight fuzz loops —
        # the dump itself is the record, the log line is opt-in
        # (CEPH_TPU_DEBUG=telemetry=5)
        dout("telemetry", 5,
             f"flight recorder dump #{blob['dump']}: trigger={trigger} "
             f"reason={reason[:120]}")
        sink = os.environ.get("CEPH_TPU_FLIGHT_DIR", "").strip()
        if sink:
            try:
                path = os.path.join(
                    sink, f"flight_{trigger}_{blob['dump']:04d}.json")
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(blob, f, sort_keys=True, indent=1)
                    f.write("\n")
            except OSError:
                pass  # the in-memory blob is the record
        return blob

    def last_dump(self) -> Optional[dict]:
        with self._lock:
            return self.dumps[-1] if self.dumps else None

    def to_dict(self) -> dict:
        """The perf-dump ``flight_recorder`` section."""
        with self._lock:
            return {"entries": list(self._entries),
                    "entries_dropped": self.dropped,
                    "dump_count": self.dump_count,
                    "dumps": list(self.dumps)}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seq = 0
            self.dropped = 0
            self.dumps.clear()
            self.dump_count = 0
            self._last_counters = {}


_global: Optional[FlightRecorder] = None
_global_lock = make_lock("telemetry.recorder._global_lock")


def global_flight_recorder() -> FlightRecorder:
    global _global
    with _global_lock:
        if _global is None:
            _global = FlightRecorder()
        return _global


def set_global_flight_recorder(recorder: Optional[FlightRecorder]
                               ) -> Optional[FlightRecorder]:
    """Swap the process recorder (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = recorder
        return prev


def install_flight_recorder(recorder: Optional[FlightRecorder] = None,
                            tracer=None) -> FlightRecorder:
    """Wire span-root summaries into the recorder's ring: sets the
    tracer's ``on_root`` hook (global tracer by default).  Returns the
    recorder in use."""
    from .spans import global_tracer
    rec = recorder if recorder is not None else global_flight_recorder()
    tr = tracer if tracer is not None else global_tracer()
    tr.on_root = rec.note_span
    return rec


# -- module-level conveniences (what the trigger sites call) ------------

def note(kind: str, **fields) -> None:
    from . import metrics as tel
    if tel.enabled():
        global_flight_recorder().note(kind, **fields)


def trip(trigger: str, reason: str = "", **fields) -> Optional[dict]:
    """Record a trigger breadcrumb AND freeze a post-mortem dump on
    the process recorder.  No-op (returns None) when telemetry is
    disabled.  Never raises."""
    from . import metrics as tel
    if not tel.enabled():
        return None
    try:
        rec = global_flight_recorder()
        rec.note(trigger, **fields)
        return rec.dump(trigger, reason, **fields)
    except Exception:  # noqa: BLE001 — a failed post-mortem must not
        # mask (or worsen) the failure that triggered it
        return None


def record_unrecoverable(exc) -> Optional[dict]:
    """The UnrecoverableError construction hook (utils/errors.py):
    every raise site shares this one choke point."""
    return trip("unrecoverable", str(exc),
                shards=[int(s) for s in getattr(exc, "shards", ())],
                extents=[[int(o), int(n)] for o, n in
                         getattr(exc, "extents", ())])


# ----------------------------------------------------------------------
# the host-tier audit workload

def flight_recorder_selftest() -> dict:
    """The ``telemetry.flight_recorder`` host-tier audit entry: ring
    bounding, span wiring, trigger dump and schema validation on
    isolated instances with the program profiler's tick clock — no
    device touched."""
    from .metrics import MetricsRegistry
    from .profiler import _Tick
    from .schema import validate_flight_dump
    from .spans import SpanTracer

    clock = _Tick()
    rec = FlightRecorder(clock=clock, max_entries=8, max_dumps=2)
    reg = MetricsRegistry(clock=clock)
    tracer = SpanTracer(clock=clock)
    install_flight_recorder(rec, tracer)
    with tracer.span("repair", objects=1):
        reg.counter("selftest_ops", 3)
    if not [e for e in rec.to_dict()["entries"]
            if e["kind"] == "span" and e["name"] == "repair"]:
        raise AssertionError("span root never reached the ring")
    for i in range(12):
        rec.note("tick", i=i)
    if len(rec.to_dict()["entries"]) != 8 or rec.dropped != 5:
        raise AssertionError(
            f"ring bound broken: {len(rec.to_dict()['entries'])} "
            f"entries, {rec.dropped} dropped")
    blob = rec.dump("manual", "selftest", registry=reg, tracer=tracer,
                    site="selftest")
    errors = validate_flight_dump(blob)
    if errors:
        raise AssertionError(f"flight dump invalid: {errors}")
    if blob["metrics_delta"].get(f"{reg.name}.selftest_ops") != 3:
        raise AssertionError("metrics_delta lost the counter delta")
    reg.counter("selftest_ops", 2)
    blob2 = rec.dump("manual", "again", registry=reg, tracer=tracer)
    if blob2["metrics_delta"].get(f"{reg.name}.selftest_ops") != 2:
        raise AssertionError("second dump delta must be incremental")
    if json.dumps(blob, sort_keys=True) != json.dumps(
            rec.to_dict()["dumps"][0], sort_keys=True):
        raise AssertionError("stored dump diverged from returned blob")
    return blob2


__all__ = ["FLIGHT_SCHEMA_VERSION", "FlightRecorder", "MAX_DUMPS",
           "MAX_ENTRIES", "TRIGGERS", "flight_recorder_selftest",
           "global_flight_recorder", "install_flight_recorder",
           "note", "record_unrecoverable", "set_global_flight_recorder",
           "trip"]
