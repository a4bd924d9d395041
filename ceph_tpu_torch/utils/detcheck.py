"""Determinism tripwire — the runtime half of the ``det`` analysis
tier (docs/LINT.md "Tier 5: runtime divergence witness").

A copy of ``ceph_tpu/utils/detcheck.py``.  Every default wall-clock
fallback in the package is created through :func:`default_clock` with
its *declared seam id* — the dotted name of its creation site, as in
the reference (whose static tier cross-checks the ids; the port's
comes with the tooling slice).  By default the factory result is
returned untouched: zero wrapper overhead, nothing recorded, the <=3%
telemetry overhead gate (tools/perf_dump.py --check-overhead) never
sees this module.

Under ``CEPH_TPU_DETCHECK=1`` the seam instead returns a
:class:`_TripwireClock` feeding the process-global
:class:`DetMonitor`: while an *injected-clock window* is open (a
scenario running on a FakeClock/EventClock marks it via
:func:`injected_clock`), any consultation of a default wall-clock
seam is a **trip** — counted per seam, breadcrumbed into the flight
recorder, and exported in the schema-versioned
:func:`detcheck_report`.  A trip means some component fell back to
real time inside a run that claims to be fully clock-injected — the
exact leak that turns a byte-identity gate flaky with no pointer to
the culprit.

The gate is creation-time, like utils/locks.py: flipping the env var
mid-process does not re-instrument existing seams.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional

DETCHECK_ENV = "CEPH_TPU_DETCHECK"
DETCHECK_SCHEMA_VERSION = 1

# keep the trip-event list bounded: counts stay exact, event detail is
# a ring of the most recent trips (a leaking seam trips per request)
MAX_TRIP_EVENTS = 256


def detcheck_enabled() -> bool:
    return os.environ.get(DETCHECK_ENV) == "1"


class DetMonitor:
    """Process-global recorder for wall-clock trips.

    All mutation happens under ``_mu`` (a plain, *unchecked* lock: the
    monitor must not observe itself); the recursion guard lives in a
    ``threading.local`` so a trip breadcrumbed into a flight recorder
    whose own clock is a tripwire cannot re-enter.
    """

    def __init__(self) -> None:
        # monitor-internal; never a make_lock product
        self._mu = threading.Lock()  # tpu-lint: disable=conc-registry-gap -- monitor bookkeeping lock: instrumenting it would recurse
        self._tls = threading.local()
        self._injected_depth = 0
        self._injected_label: Optional[str] = None
        self._trips: Dict[str, int] = {}
        self._events: List[Dict[str, object]] = []

    # -- injected-clock window -----------------------------------------

    def enter_injected(self, label: str) -> None:
        with self._mu:
            self._injected_depth += 1
            if self._injected_label is None:
                self._injected_label = label

    def exit_injected(self) -> None:
        with self._mu:
            self._injected_depth = max(0, self._injected_depth - 1)
            if self._injected_depth == 0:
                self._injected_label = None

    def injected_active(self) -> bool:
        return self._injected_depth > 0

    # -- trips ---------------------------------------------------------

    def record_trip(self, seam: str, op: str) -> None:
        if getattr(self._tls, "in_trip", False):
            return  # breadcrumbing a trip must not trip again
        self._tls.in_trip = True
        try:
            with self._mu:
                self._trips[seam] = self._trips.get(seam, 0) + 1
                label = self._injected_label
                if len(self._events) < MAX_TRIP_EVENTS:
                    self._events.append(
                        {"seam": seam, "op": op, "window": label,
                         "thread": threading.current_thread().name})
            try:
                # lazy + forgiving: telemetry imports this module
                from ..telemetry.recorder import global_flight_recorder
                global_flight_recorder().note(
                    "detcheck_trip", seam=seam, op=op)
            except Exception:
                pass
        finally:
            self._tls.in_trip = False

    # -- export --------------------------------------------------------

    def report(self) -> Dict[str, object]:
        with self._mu:
            return {
                "detcheck_schema_version": DETCHECK_SCHEMA_VERSION,
                "enabled": detcheck_enabled(),
                "injected_active": self._injected_depth > 0,
                "trips": dict(sorted(self._trips.items())),
                "total_trips": sum(self._trips.values()),
                "trip_events": [dict(e) for e in self._events],
            }

    def reset(self) -> None:
        with self._mu:
            self._trips.clear()
            self._events.clear()


class _TripwireClock:
    """Wraps a real clock created at a registered default-clock seam;
    consultations while an injected-clock window is open are trips."""

    __slots__ = ("_seam", "_inner", "_mon")

    def __init__(self, seam: str, inner, monitor: "DetMonitor") -> None:
        self._seam = seam
        self._inner = inner
        self._mon = monitor

    def _witness(self, op: str) -> None:
        if self._mon.injected_active():
            self._mon.record_trip(self._seam, op)

    def monotonic(self) -> float:
        self._witness("monotonic")
        return self._inner.monotonic()

    def sleep(self, seconds: float) -> None:
        self._witness("sleep")
        self._inner.sleep(seconds)

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<_TripwireClock {self._seam!r} on {self._inner!r}>"


_monitor_global: Optional[DetMonitor] = None
_monitor_global_lock = threading.Lock()  # tpu-lint: disable=conc-registry-gap -- guards monitor construction: instrumenting it would recurse


def global_monitor() -> DetMonitor:
    global _monitor_global
    with _monitor_global_lock:
        if _monitor_global is None:
            _monitor_global = DetMonitor()
        return _monitor_global


def reset_monitor() -> DetMonitor:
    """Install a fresh global monitor (tests); returns it."""
    global _monitor_global
    with _monitor_global_lock:
        _monitor_global = DetMonitor()
        return _monitor_global


def default_clock(seam: str, factory: Callable[[], object]):
    """The registered default wall-clock fallback.

    ``seam`` is the dotted id of the creation site.  Disabled (the default): returns ``factory()``
    untouched.  Under ``CEPH_TPU_DETCHECK=1``: returns a tripwire
    wrapper that witnesses every consultation made while an
    injected-clock window is open.
    """
    inner = factory()
    if not detcheck_enabled():
        return inner
    return _TripwireClock(seam, inner, global_monitor())


@contextlib.contextmanager
def injected_clock(label: str = "scenario") -> Iterator[None]:
    """Mark a window in which an injected (Fake/Event) clock drives
    the run, so any default wall-clock consultation is a trip.  Cheap
    no-op when the gate is off."""
    if not detcheck_enabled():
        yield
        return
    mon = global_monitor()
    mon.enter_injected(label)
    try:
        yield
    finally:
        mon.exit_injected()


def detcheck_report() -> Dict[str, object]:
    """The schema-versioned runtime report (empty-but-valid when the
    gate is off and nothing was ever recorded)."""
    return global_monitor().report()


def validate_detcheck_report(doc: Dict[str, object]) -> None:
    """Raise ValueError unless ``doc`` is a valid detcheck report."""
    if not isinstance(doc, dict):
        raise ValueError("detcheck report: not a mapping")
    ver = doc.get("detcheck_schema_version")
    if ver != DETCHECK_SCHEMA_VERSION:
        raise ValueError(
            f"detcheck report: schema version {ver!r} != "
            f"{DETCHECK_SCHEMA_VERSION}")
    for key, typ in (("enabled", bool), ("injected_active", bool),
                     ("trips", dict), ("total_trips", int),
                     ("trip_events", list)):
        if not isinstance(doc.get(key), typ):
            raise ValueError(f"detcheck report: bad/missing {key!r}")
    for seam, n in doc["trips"].items():  # type: ignore[union-attr]
        if not isinstance(seam, str) or not isinstance(n, int) or n < 0:
            raise ValueError(f"detcheck report: bad trip entry {seam!r}")
    for e in doc["trip_events"]:  # type: ignore[union-attr]
        if not isinstance(e, dict) or "seam" not in e or "op" not in e:
            raise ValueError(f"detcheck report: bad trip event {e!r}")
