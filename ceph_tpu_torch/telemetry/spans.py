"""Deterministic span tracing for the host-side pipeline phases.

A copy of ``ceph_tpu/telemetry/spans.py`` without its jax hook (the
reference mirrors each span into ``jax.profiler.TraceAnnotation`` when
jax is loaded; the port's device time comes from ``torch.profiler``
traces, which need no host annotation).

A span is one timed phase (``serve.batch`` → ``serve.dispatch``, …);
nesting follows the call stack via a thread-local.

- **Clock-injectable**: the tracer takes any object with
  ``monotonic()`` — tests pass ``utils.retry.FakeClock`` and get
  byte-identical ``to_json()`` output across runs.
- **Bounded**: finished root trees are kept in a deque of
  ``max_roots``; overflow drops the oldest and counts ``dropped``.
- **Observable live**: enter/exit emit through utils.log at debug
  level 20 under the ``telemetry`` subsystem —
  ``CEPH_TPU_DEBUG=telemetry=20`` streams the trace as it happens.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.detcheck import default_clock
from ..utils.log import dout
from ..utils.locks import make_lock

SPAN_DEBUG_LEVEL = 20   # dout level for span enter/exit events

# once-per-process marker for the root-eviction event: the FIRST
# eviction from the bounded root deque emits a structured event (and
# every eviction counts `telemetry_spans_dropped`), so a truncated span
# dump is visible in the dump that truncated it
_drop_event_sent = False


class _SystemClock:
    def monotonic(self) -> float:
        return time.monotonic()


class Span:
    """One timed phase.  ``attrs`` are JSON-scalar annotations
    (pattern keys, object counts, engine tiers)."""

    __slots__ = ("name", "start", "end", "attrs", "children")

    def __init__(self, name: str, start: float,
                 attrs: Optional[Dict[str, object]] = None) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs = dict(attrs or {})
        self.children: List["Span"] = []

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict:
        out: dict = {"name": self.name, "start": self.start,
                     "end": self.end, "duration": self.duration}
        if self.attrs:
            out["attrs"] = {k: self.attrs[k] for k in sorted(self.attrs)}
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


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
            dout("telemetry", SPAN_DEBUG_LEVEL,
                 f"span- {path} dur={sp.duration:.6f}s")

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


__all__ = ["SPAN_DEBUG_LEVEL", "Span", "SpanTracer", "global_tracer",
           "set_global_tracer", "span"]
