"""The unified metrics plane: labeled counters, gauges, histograms
and structured events in one registry.

A copy of ``ceph_tpu/telemetry/metrics.py`` with two changes.  The
reference's ``install_compile_monitor`` folds jax backend-compile
events into ``jax_backend_compiles``; the port has no jax, and its
counterpart of a compile is the setup a kernel needs on first use: a
kernel library built and loaded (``ops/_build.py``) or kernel data
uploaded to the card (the row lists and instruction buffers
``ops/gf_kernels.py`` caches per matrix and device).  Both count under
``KERNEL_SETUPS``, always (no monitor to install), and
``run_serving_scenario`` reports the count after warmup as
``stream_compiles``.

- **labels** — series identity is (name, sorted label items);
- **kind safety** — a name belongs to exactly one kind (counter |
  gauge | histogram); reusing it as another kind raises;
- **two exports** — ``dump()`` (the `perf dump` JSON shape) and
  ``to_prometheus()`` (Prometheus text exposition);
- **injectable clock** — ``timed()``/``record_dispatch`` read the
  registry clock, so FakeClock tests pin exact latencies.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, Optional, Tuple

from .histogram import LatencyHistogram
from ..utils.detcheck import default_clock
from ..utils.locks import make_lock

LabelKey = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelKey]

MAX_EVENTS = 256


class _SystemClock:
    def monotonic(self) -> float:
        return time.monotonic()


def _labels_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def series_name(name: str, labels: LabelKey) -> str:
    """The dump key: ``name{k=v,...}`` (labels sorted), bare name
    when unlabeled."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Process metrics registry (the admin-socket `perf dump` role,
    labels included)."""

    def __init__(self, name: str = "ceph_tpu_telemetry",
                 clock=None) -> None:
        self.name = name
        self.clock = clock if clock is not None \
            else default_clock("telemetry.metrics.MetricsRegistry",
                               _SystemClock)
        self._lock = make_lock("telemetry.metrics.MetricsRegistry._lock")
        self._counters: Dict[SeriesKey, int] = {}
        self._gauges: Dict[SeriesKey, float] = {}
        self._hists: Dict[SeriesKey, LatencyHistogram] = {}
        self._kinds: Dict[str, str] = {}
        self._events: "deque[dict]" = deque(maxlen=MAX_EVENTS)
        self._event_seq = 0

    # -- kind discipline -------------------------------------------------

    def _claim(self, name: str, kind: str) -> None:
        owner = self._kinds.setdefault(name, kind)
        if owner != kind:
            raise ValueError(
                f"metric {name!r} is a {owner}, not a {kind} — one "
                f"name, one kind (the dump key would collide)")

    # -- recording -------------------------------------------------------

    def counter(self, name: str, value: int = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r} increment {value} < 0")
        key = (name, _labels_key(labels))
        with self._lock:
            self._claim(name, "counter")
            self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            self._claim(name, "gauge")
            self._gauges[key] = value

    def histogram(self, name: str, **labels) -> LatencyHistogram:
        """Get-or-create the labeled histogram series."""
        key = (name, _labels_key(labels))
        with self._lock:
            self._claim(name, "histogram")
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = LatencyHistogram()
            return hist

    def observe(self, name: str, value: float,
                exemplar: Optional[str] = None, **labels) -> None:
        """``exemplar``: an optional trace id retained by
        the series' bounded top-quantile exemplar set when the
        histogram was created with exemplar capacity (the tracing
        plane raises the default while a collector is installed) —
        p99+ samples in dumps then link straight to their traces."""
        self.histogram(name, **labels).record(value, exemplar=exemplar)

    def event(self, kind: str, **fields) -> None:
        """Structured event stream (bounded; the log-once paths emit
        here so the transition itself is inspectable, not just its
        count)."""
        with self._lock:
            self._event_seq += 1
            self._events.append(
                {"seq": self._event_seq, "event": kind,
                 **{k: fields[k] for k in sorted(fields)}})

    @contextlib.contextmanager
    def timed(self, name: str, **labels):
        """Time a block into ``observe(name, elapsed, **labels)``."""
        t0 = self.clock.monotonic()
        try:
            yield
        finally:
            self.observe(name, self.clock.monotonic() - t0, **labels)

    # -- readout ---------------------------------------------------------

    def counter_value(self, name: str, **labels) -> int:
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0)

    def dump(self) -> dict:
        """The `perf dump` JSON shape: ``{registry: {series: value}}``
        (histograms dump their full bucket/quantile dict, events ride
        under ``__events__``)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            events = list(self._events)
        out: Dict[str, object] = {}
        for (name, labels), v in sorted(counters.items()):
            out[series_name(name, labels)] = v
        for (name, labels), v in sorted(gauges.items()):
            out[series_name(name, labels)] = v
        for (name, labels), h in sorted(hists.items()):
            out[series_name(name, labels)] = h.to_dict()
        if events:
            out["__events__"] = events
        return {self.name: out}

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters as ``*_total``,
        gauges bare, histograms as quantile summaries with
        ``_sum``/``_count``.  Names are sanitized (`.` → `_`) and
        prefixed with the registry name.

        Exposition-format hardening: every metric
        family leads with ``# HELP`` + ``# TYPE`` lines, and label
        VALUES escape backslash, double-quote and newline per the
        text-format spec — a plugin profile or error string carried as
        a label can no longer corrupt the scrape."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        lines = []

        def _san(name: str) -> str:
            return (self.name + "_" + name).replace(".", "_").replace(
                "-", "_")

        def _esc(value: str) -> str:
            # escaping order matters: backslash first, or the escapes
            # themselves get re-escaped
            return (value.replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def _lbl(labels: LabelKey, extra: str = "") -> str:
            inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels)
            if extra:
                inner = f"{inner},{extra}" if inner else extra
            return f"{{{inner}}}" if inner else ""

        def _head(seen: set, n: str, kind: str, src: str) -> None:
            if n not in seen:
                seen.add(n)
                lines.append(f"# HELP {n} ceph_tpu telemetry "
                             f"{kind} {_esc(src)}")
                lines.append(f"# TYPE {n} {kind}")

        seen_c = set()
        for (name, labels), v in sorted(counters.items()):
            n = _san(name) + "_total"
            _head(seen_c, n, "counter", name)
            lines.append(f"{n}{_lbl(labels)} {v}")
        seen_g = set()
        for (name, labels), v in sorted(gauges.items()):
            n = _san(name)
            _head(seen_g, n, "gauge", name)
            lines.append(f"{n}{_lbl(labels)} {v}")
        seen_h = set()
        for (name, labels), h in sorted(hists.items()):
            n = _san(name)
            _head(seen_h, n, "summary", name)
            pcts = h.percentiles()
            for q, p in (("0.5", "p50"), ("0.99", "p99"),
                         ("0.999", "p999")):
                val = pcts[p]
                if val is not None:
                    extra = 'quantile="%s"' % q
                    lines.append(f"{n}{_lbl(labels, extra)} {val}")
            lines.append(f"{n}_sum{_lbl(labels)} {h.sum}")
            lines.append(f"{n}_count{_lbl(labels)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._kinds.clear()
            self._events.clear()
            self._event_seq = 0


_global: Optional[MetricsRegistry] = None
_global_lock = make_lock("telemetry.metrics._global_lock")
_enabled = True


def global_metrics() -> MetricsRegistry:
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
        return _global


def set_global_metrics(registry: Optional[MetricsRegistry]
                       ) -> Optional[MetricsRegistry]:
    """Swap the process registry (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = registry
        return prev


def set_enabled(on: bool) -> bool:
    """Master recording switch (the perf_dump --check-overhead gate
    measures enabled-vs-disabled on an identical workload).  Disabled
    means every module-level convenience below is a cheap no-op; code
    holding a registry object directly is unaffected."""
    global _enabled
    prev = _enabled
    _enabled = on
    return prev


def enabled() -> bool:
    return _enabled


# -- module-level conveniences (what the instrumented call sites use) ----

def counter(name: str, value: int = 1, **labels) -> None:
    if _enabled:
        global_metrics().counter(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    if _enabled:
        global_metrics().gauge(name, value, **labels)


def observe(name: str, value: float, exemplar: Optional[str] = None,
            **labels) -> None:
    if _enabled:
        global_metrics().observe(name, value, exemplar=exemplar,
                                 **labels)


def event(kind: str, **fields) -> None:
    if _enabled:
        global_metrics().event(kind, **fields)
        # every structured event is also a flight-recorder breadcrumb
        # (the recorder's ring is the "what happened right before"
        # record a post-mortem dump freezes)
        from .recorder import global_flight_recorder
        global_flight_recorder().note(kind, **fields)


@contextlib.contextmanager
def record_dispatch(name: str, eager: bool = True, **labels):
    """Time one device/host dispatch into ``<name>_seconds{labels}``
    and count it in ``<name>_calls{labels}``.

    ``eager=False`` records nothing (the reference passes it when its
    call site is being traced by jax; the port runs eagerly).
    """
    if not (eager and _enabled):
        yield
        return
    reg = global_metrics()
    t0 = reg.clock.monotonic()
    try:
        yield
    finally:
        reg.observe(name + "_seconds",
                    reg.clock.monotonic() - t0, **labels)
        reg.counter(name + "_calls", **labels)


# -- kernel setups (the port's counterpart of backend compiles) ---------

KERNEL_SETUPS = "kernel_setups"


def note_kernel_setup() -> None:
    """Count one kernel setup: a kernel library built or loaded on first
    use, or kernel data uploaded to a card.  A warm serving stream makes
    none."""
    counter(KERNEL_SETUPS)


def kernel_setups() -> int:
    """Kernel setups counted so far in this process."""
    return global_metrics().counter_value(KERNEL_SETUPS)


__all__ = ["KERNEL_SETUPS", "MAX_EVENTS", "MetricsRegistry", "counter",
           "enabled", "event", "gauge", "global_metrics", "kernel_setups",
           "note_kernel_setup", "observe", "record_dispatch",
           "series_name", "set_enabled", "set_global_metrics"]
