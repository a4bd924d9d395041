"""Deterministic span tracing for the host-side pipeline phases.

A copy of ``ceph_tpu/telemetry/spans.py`` without its jax hook (the
reference mirrors each span into ``jax.profiler.TraceAnnotation`` when
jax is loaded; the port's device time comes from ``torch.profiler``
traces, which need no host annotation).

A span is one timed phase (``serve.batch`` → ``serve.dispatch``, …);
nesting follows the call stack via a thread-local.

- **Clock-injectable**: the tracer takes any object with
  ``monotonic()`` — tests pass ``utils.retry.FakeClock`` and get
  byte-identical ``to_json()`` output across runs.  The system clock
  reads ``time.perf_counter()``: on Linux ``CLOCK_MONOTONIC``, the
  clock ``time.monotonic()`` reads and the one on which a
  ``torch.profiler`` device trace is placed by timing a marker kernel
  (``benchmarks/yardstick/trace.py``), so span stamps and the device's
  events share one timeline.
- **Bounded**: finished root trees are kept in a deque of
  ``max_roots``; overflow drops the oldest and counts ``dropped``.
- **Observable live**: enter/exit of :meth:`SpanTracer.span` emit
  through utils.log at debug level 20 under the ``telemetry`` subsystem
  — ``CEPH_TPU_DEBUG=telemetry=20`` streams the trace as it happens
  (the armed hot-path spans below do not: their trees and totals are
  the record).
- **Armed hot-path sites**: :func:`root`, :func:`child` and
  :func:`note` sit inside the codec, engine, OSDMap and bulk CRUSH
  paths.  They record only while the tracer is *armed*: inside a
  ``torch.profiler`` session (checked once per root) or an
  :func:`armed` context.  Unarmed, a site costs one module-global check
  and builds no Span.  An armed span also adds to its name's totals
  (:meth:`SpanTracer.totals`): ``count``, ``seconds``,
  ``self_seconds`` (its duration less what its children cover) and the
  ``counts`` noted under it, which roll up into every enclosing armed
  span.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.detcheck import default_clock
from ..utils.log import dout, get_level
from ..utils.locks import make_lock

SPAN_DEBUG_LEVEL = 20   # dout level for span enter/exit events

# once-per-process marker for the root-eviction event: the FIRST
# eviction from the bounded root deque emits a structured event (and
# every eviction counts `telemetry_spans_dropped`), so a truncated span
# dump is visible in the dump that truncated it
_drop_event_sent = False

# open armed() contexts (every thread; written under _global_lock), and
# armed root spans open (every thread; written under the tracer's lock):
# the hot-path sites' checks
_armed_depth = 0
_live = 0


class _SystemClock:
    def monotonic(self) -> float:
        return time.perf_counter()


class Span:
    """One timed phase.  ``attrs`` are JSON-scalar annotations
    (pattern keys, object counts, engine tiers)."""

    __slots__ = ("name", "start", "end", "attrs", "children", "counts",
                 "covered")

    def __init__(self, name: str, start: float,
                 attrs: Optional[Dict[str, object]] = None) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs = dict(attrs or {})
        self.children: List["Span"] = []
        # the counts noted under an armed span (None: not armed), and
        # the seconds its finished children cover
        self.counts: Optional[Dict[str, int]] = None
        self.covered = 0.0

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict:
        out: dict = {"name": self.name, "start": self.start,
                     "end": self.end, "duration": self.duration}
        if self.attrs:
            out["attrs"] = {k: self.attrs[k] for k in sorted(self.attrs)}
        if self.counts:
            out["counts"] = {k: self.counts[k] for k in sorted(self.counts)}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class _Total:
    __slots__ = ("count", "seconds", "self_seconds", "counts")

    def __init__(self) -> None:
        self.count = 0
        self.seconds = 0.0
        self.self_seconds = 0.0
        self.counts: Dict[str, int] = {}


# the context of a site that does not record
_OFF = contextlib.nullcontext()


class _Hot:
    """The context of an armed site."""

    __slots__ = ("tracer", "name", "attrs", "span")

    def __init__(self, tracer: "SpanTracer", name: str, attrs) -> None:
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> Span:
        self.span = self.tracer._open_hot(self.name, self.attrs)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.tracer._close_hot(self.span)
        return False


class SpanTracer:
    """Thread-aware span tree collector."""

    def __init__(self, clock=None, max_roots: int = 256) -> None:
        self.clock = clock if clock is not None \
            else default_clock("telemetry.spans.SpanTracer",
                               _SystemClock)
        self._lock = make_lock("telemetry.spans.SpanTracer._lock")
        self._tls = threading.local()
        self.finished: "deque[Span]" = deque(maxlen=max_roots)
        self.dropped = 0
        self._totals: Dict[str, _Total] = {}
        # called with each finished ROOT span (outside the lock);
        # telemetry.recorder.install_flight_recorder wires this to the
        # flight recorder's ring.  Exceptions are swallowed — a broken
        # observer must never fail the traced pipeline.
        self.on_root = None

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Open a child span of the current thread's innermost open
        span (a root when none is open).  Yields the Span so callers
        can attach late attrs (e.g. the engine tier chosen inside).

        Honors the master recording switch (metrics.set_enabled): when
        telemetry is off, yields a throwaway span and records nothing
        — the perf_dump --check-overhead gate measures exactly this
        on/off delta."""
        from .metrics import enabled
        if not enabled():
            yield Span(name, 0.0, attrs)
            return
        stack = self._stack()
        sp = Span(name, self.clock.monotonic(), attrs)
        verbose = get_level("telemetry") >= SPAN_DEBUG_LEVEL
        if verbose:
            path = "/".join([s.name for s in stack] + [name])
            dout("telemetry", SPAN_DEBUG_LEVEL, f"span+ {path}")
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.end = self.clock.monotonic()
            stack.pop()
            if stack:
                stack[-1].children.append(sp)
                stack[-1].covered += sp.end - sp.start
            else:
                evicted = False
                with self._lock:
                    if len(self.finished) == self.finished.maxlen:
                        self.dropped += 1
                        evicted = True
                    self.finished.append(sp)
                if evicted:
                    self._note_dropped()
                if self.on_root is not None:
                    try:
                        self.on_root(sp)
                    except Exception:  # noqa: BLE001 - observer only
                        pass
            if verbose:
                dout("telemetry", SPAN_DEBUG_LEVEL,
                     f"span- {path} dur={sp.duration:.6f}s")

    # -- armed hot-path spans (root / child / note below) ---------------

    def _hot_child(self, name: str, attrs) -> object:
        """An armed child site: records when this thread has an armed
        span open."""
        if not getattr(self._tls, "hot", 0):
            return _OFF
        return _Hot(self, name, attrs)

    def _open_hot(self, name: str, attrs) -> Span:
        global _live
        tls = self._tls
        hot = getattr(tls, "hot", 0)
        if not hot:
            with self._lock:
                _live += 1
        tls.hot = hot + 1
        sp = Span(name, self.clock.monotonic(), attrs)
        sp.counts = {}
        self._stack().append(sp)
        return sp

    def _close_hot(self, sp: Span) -> None:
        global _live
        sp.end = end = self.clock.monotonic()
        tls = self._tls
        stack = self._stack()
        stack.pop()
        tls.hot -= 1
        dur = end - sp.start
        evicted = False
        with self._lock:
            t = self._totals.get(sp.name)
            if t is None:
                t = self._totals[sp.name] = _Total()
            t.count += 1
            t.seconds += dur
            t.self_seconds += dur - sp.covered
            for k, n in sp.counts.items():
                t.counts[k] = t.counts.get(k, 0) + n
            if not tls.hot:
                _live -= 1
            if not stack:
                if len(self.finished) == self.finished.maxlen:
                    self.dropped += 1
                    evicted = True
                self.finished.append(sp)
        if stack:
            parent = stack[-1]
            parent.children.append(sp)
            parent.covered += dur
            if sp.counts:
                # counts roll up into the nearest enclosing armed span
                for up in reversed(stack):
                    if up.counts is not None:
                        for k, n in sp.counts.items():
                            up.counts[k] = up.counts.get(k, 0) + n
                        break
            return
        if evicted and not _drop_event_sent:
            self._note_dropped()
        if self.on_root is not None:
            try:
                self.on_root(sp)
            except Exception:  # noqa: BLE001 - observer only
                pass

    def _note(self, name: str, n: int) -> None:
        if not getattr(self._tls, "hot", 0):
            return
        for sp in reversed(self._stack()):
            if sp.counts is not None:
                sp.counts[name] = sp.counts.get(name, 0) + n
                return

    def totals(self) -> Dict[str, dict]:
        """{span name: {"count", "seconds", "self_seconds", "counts"}}
        of every armed span finished since the last reset."""
        with self._lock:
            return {name: {"count": t.count, "seconds": t.seconds,
                           "self_seconds": t.self_seconds,
                           "counts": dict(t.counts)}
                    for name, t in self._totals.items()}

    def _note_dropped(self) -> None:
        """Count every evicted root in the unified metrics plane and
        emit the truncation event once per process — a span dump that
        lost its oldest trees must say so."""
        global _drop_event_sent
        from . import metrics as tel
        tel.counter("telemetry_spans_dropped")
        if not _drop_event_sent:
            _drop_event_sent = True
            tel.event("telemetry_spans_dropped",
                      max_roots=self.finished.maxlen,
                      detail="bounded root deque evicted its oldest "
                             "span tree; older roots are missing "
                             "from to_dict() dumps")

    def to_dict(self) -> dict:
        with self._lock:
            roots = [s.to_dict() for s in self.finished]
            return {"spans": roots, "dropped": self.dropped}

    def to_json(self, indent: Optional[int] = None) -> str:
        """Deterministic export: sorted keys, fixed separators — two
        runs with the same FakeClock schedule are byte-identical."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent,
                          separators=(",", ": ") if indent else (",", ":"))

    def reset(self) -> None:
        with self._lock:
            self.finished.clear()
            self.dropped = 0
            self._totals.clear()


_global: Optional[SpanTracer] = None
_global_lock = make_lock("telemetry.spans._global_lock")


def global_tracer() -> SpanTracer:
    global _global
    with _global_lock:
        if _global is None:
            _global = SpanTracer()
        return _global


def set_global_tracer(tracer: Optional[SpanTracer]
                      ) -> Optional[SpanTracer]:
    """Swap the process tracer (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = tracer
        return prev


def span(name: str, **attrs):
    """Convenience: a span on the process-global tracer."""
    return global_tracer().span(name, **attrs)


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def armed():
    """Arm the hot-path sites (every thread) for the block, as a
    ``torch.profiler`` session does."""
    global _armed_depth
    with _global_lock:
        _armed_depth += 1
    try:
        yield
    finally:
        with _global_lock:
            _armed_depth -= 1


def root(name: str, **attrs):
    """A hot-path root site on the process-global tracer: an armed span
    while the tracer is armed (a child where this thread already has
    one open), a no-op context otherwise."""
    if not (_armed_depth or _profiling()):
        return _OFF
    return _Hot(_global or global_tracer(), name, attrs)


def child(name: str, **attrs):
    """A hot-path child site: an armed span under this thread's open
    armed span, a no-op context where there is none."""
    if not _live:
        return _OFF
    return (_global or global_tracer())._hot_child(name, attrs)


def note(name: str, n: int = 1) -> None:
    """Add ``n`` to count ``name`` of this thread's innermost open armed
    span (nothing where there is none)."""
    if _live:
        (_global or global_tracer())._note(name, n)


__all__ = ["SPAN_DEBUG_LEVEL", "Span", "SpanTracer", "armed", "child",
           "global_tracer", "note", "root", "set_global_tracer", "span"]
