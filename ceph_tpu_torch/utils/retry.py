"""Injectable clocks — the part of ``ceph_tpu/utils/retry.py`` the port
needs: ``SystemClock`` (real time), ``FakeClock`` (deterministic tests
and simulations: ``sleep`` advances ``now``) and ``EventClock`` (a
FakeClock an event loop can fast-forward to its next registered
event).
The retry policy itself (``RetryPolicy``, ``retry_call``) comes with
the supervision slice.
"""

from __future__ import annotations

import heapq
import time
from typing import List, Optional


class SystemClock:
    """Real time: the production clock."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock:
    """Deterministic test clock: sleep() just advances ``now`` and
    records the request, so retry schedules are asserted exactly and
    instantly."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = start
        self.sleeps: List[float] = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.now += seconds


class EventClock(FakeClock):
    """Discrete-event FakeClock: consumers register future event
    times (arrivals, deadlines, chaos epochs, …) with ``schedule``,
    and a runner in fast-forward mode jumps ``now`` straight to
    ``next_event()`` instead of ticking through the idle gap.

    It is still a FakeClock — ``sleep`` advances ``now`` by exactly
    the requested amount and records it — so any component holding
    this clock behaves byte-identically whether the loop ticks or
    jumps; only the *loop's* choice of sleep lengths changes, and
    the week runner pins that those choices don't change results
    (tests/test_tenant_week.py's clock-mode equivalence).
    """

    def __init__(self, start: float = 0.0) -> None:
        super().__init__(start)
        self._events: List[float] = []
        self.jumps = 0

    def schedule(self, t: float) -> None:
        """Register an absolute event time (past times are fine —
        they surface immediately)."""
        heapq.heappush(self._events, float(t))

    def next_event(self) -> Optional[float]:
        """Earliest scheduled time still in the future (stale entries
        at or before ``now`` are discarded), or None when the heap is
        drained."""
        while self._events and self._events[0] <= self.now:
            heapq.heappop(self._events)
        return self._events[0] if self._events else None

    def advance_to(self, t: float) -> float:
        """Fast-forward: one sleep() straight to absolute time ``t``
        (no-op if ``t`` is not in the future). Returns ``now``."""
        if t > self.now:
            self.jumps += 1
            self.sleep(t - self.now)
            # land EXACTLY on t: accumulated float error must not
            # make a jumped clock disagree with a stepped one at the
            # last ulp (the clock-mode byte-equivalence contract)
            self.now = float(t)
        return self.now


__all__ = ["EventClock", "FakeClock", "SystemClock"]
