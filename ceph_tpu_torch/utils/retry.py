"""Bounded retry with exponential backoff — the transient-error shield;
a copy of ``ceph_tpu/utils/retry.py``.

The reference retries flaky backend ops at several layers (ObjectStore
EIO retry policy, messenger reconnect backoff in msg/async, the osd's
`osd_op_queue` requeue on EAGAIN).  Here one primitive covers the
framework's needs: ``retry_call`` runs a callable, retries only the
exception types the policy names (default: TransientBackendError),
sleeps an exponentially growing, capped delay between attempts, and
raises RetryExhausted — with the last error chained — when the budget
is spent.  Two budgets exist: ``attempts`` (tries) and ``deadline``
(overall elapsed seconds; the recovery orchestrator's
deadline-carrying retries ride this — an op must never keep retrying
past the time its recovery reservation is worth).

Backoff can carry decorrelated jitter (``jitter="decorrelated"``, the
AWS-architecture-blog schedule: delay ~ U(base, prev*3) capped at
max_delay) so a fleet of throttled recovery ops retrying the same
flaky OSD doesn't thundering-herd on synchronized exponential steps.
The jitter rng is injectable just like the clock, so tests assert
exact schedules.

The clock is injectable: tests pass ``FakeClock`` and assert the exact
backoff schedule with ZERO real sleeping (the no-real-sleeps rule for
the chaos/scrub suites); production uses the module default
``SystemClock``.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Type

from .errors import ProbeTimeout, RetryExhausted, TransientBackendError


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


@dataclass(frozen=True)
class RetryPolicy:
    """attempts total tries; delay(i) = min(base * multiplier^i, max)
    after failed attempt i (no delay after the final failure).

    ``deadline``: overall elapsed budget in seconds — the schedule
    stops (RetryExhausted, deadline_expired=True) once the deadline
    passes or the next backoff sleep would overrun it, regardless of
    attempts remaining.  ``jitter="decorrelated"`` replaces the pure
    exponential with delay ~ U(base_delay, prev_delay * 3) capped at
    max_delay (rng injectable through retry_call)."""

    attempts: int = 3
    base_delay: float = 0.01
    multiplier: float = 2.0
    max_delay: float = 1.0
    deadline: Optional[float] = None
    jitter: str = "none"            # "none" | "decorrelated"
    retry_on: Tuple[Type[BaseException], ...] = (TransientBackendError,)

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError(f"attempts={self.attempts} must be >= 1")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline={self.deadline} must be > 0")
        if self.jitter not in ("none", "decorrelated"):
            raise ValueError(f"jitter={self.jitter!r} must be 'none' or "
                             f"'decorrelated'")

    def delay(self, failed_attempt: int,
              prev_delay: Optional[float] = None,
              rng: Optional[random.Random] = None) -> float:
        base = min(self.base_delay * self.multiplier ** failed_attempt,
                   self.max_delay)
        if self.jitter == "none":
            return base
        # decorrelated jitter: sleep ~ U(base_delay, prev * 3), capped.
        # The first backoff seeds the walk with the plain base delay.
        prev = base if prev_delay is None else prev_delay
        # deterministic fallback: an unseeded Random here would
        # make a replayed backoff walk diverge run-to-run; jitter
        # needs decorrelation, not entropy
        rng = rng if rng is not None \
            else random.Random(0x9E3779B1 ^ failed_attempt)
        hi = max(self.base_delay, prev * 3.0)
        return min(self.max_delay,
                   rng.uniform(min(self.base_delay, hi), hi))


@dataclass
class RetryStats:
    """Mutable per-call record (handed to on_retry and kept by
    callers that want the schedule for reports)."""

    attempts: int = 0
    delays: List[float] = field(default_factory=list)


def retry_call(fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               clock=None,
               on_retry: Optional[Callable] = None,
               stats: Optional[RetryStats] = None,
               rng: Optional[random.Random] = None,
               **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy``.

    Retries only ``policy.retry_on`` exceptions; anything else
    propagates on the first raise (a corrupt shard is not a flaky
    read).  ``on_retry(attempt_index, delay, error)`` fires before
    each backoff sleep.  Raises RetryExhausted(attempts, last,
    elapsed) when every attempt failed or when ``policy.deadline``
    elapsed seconds have been spent (deadline_expired=True) — a
    deadline stop never sleeps first, so the caller gets the time
    back.  ``rng`` seeds the decorrelated-jitter draw when the policy
    asks for it.
    """
    from ..telemetry import metrics as tel
    from .detcheck import default_clock
    policy = policy or RetryPolicy()
    clock = clock if clock is not None \
        else default_clock("utils.retry.retry_call", SystemClock)
    start = clock.monotonic()
    last: Optional[BaseException] = None
    prev_delay: Optional[float] = None
    attempts_made = 0
    deadline_expired = False
    for attempt in range(policy.attempts):
        attempts_made = attempt + 1
        if stats is not None:
            stats.attempts = attempts_made
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last = e
            # only failures touch the telemetry plane: the clean
            # first-try path (every shard read in a healthy scrub)
            # records nothing, keeping the overhead gate honest
            tel.counter("retry_attempts",
                        error=type(e).__name__)
            if attempt + 1 >= policy.attempts:
                break
            d = policy.delay(attempt, prev_delay=prev_delay, rng=rng)
            prev_delay = d
            if policy.deadline is not None:
                elapsed = clock.monotonic() - start
                if elapsed + d > policy.deadline:
                    # the next sleep would overrun the deadline: stop
                    # NOW rather than sleeping into certain failure
                    deadline_expired = True
                    break
            if stats is not None:
                stats.delays.append(d)
            if on_retry is not None:
                on_retry(attempt, d, e)
            tel.observe("retry_backoff_seconds", d)
            clock.sleep(d)
    elapsed = clock.monotonic() - start
    tel.counter("retry_exhausted")
    if deadline_expired:
        tel.counter("retry_deadline_expired")
    raise RetryExhausted(attempts_made, last, elapsed=elapsed,
                         deadline_expired=deadline_expired) from last


def probe_call(fn: Callable, *args,
               target: str = "backend",
               deadline: float = 1.0,
               policy: Optional[RetryPolicy] = None,
               clock=None,
               **kwargs):
    """Run a health/host probe under a HARD time budget.

    Same retry semantics as :func:`retry_call`, but the terminal error
    is :class:`ProbeTimeout`, never RetryExhausted — the supervisor
    classifies ProbeTimeout as the hang class (``backend_loss``), so a
    wedged endpoint escalates the ladder instead of transient-looping.
    Two ways to time out:

    - the retry schedule exhausts (attempts or deadline) — the
      RetryExhausted is swallowed and re-raised as ProbeTimeout with
      its ``.elapsed``/``.deadline_expired``/``.last`` carried over;
    - the probe *answers*, but only after ``deadline`` elapsed — a
      probe that slow IS a wedged endpoint (there is no way to
      interrupt a stuck call, so the overrun is detected post-hoc,
      exactly like the supervisor's slow-dispatch detection).
    """
    from ..telemetry import metrics as tel
    from .detcheck import default_clock
    clock = clock if clock is not None \
        else default_clock("utils.retry.probe_call", SystemClock)
    if policy is None:
        policy = RetryPolicy(attempts=2, deadline=deadline)
    elif policy.deadline is None:
        policy = dataclasses.replace(policy, deadline=deadline)
    start = clock.monotonic()
    try:
        out = retry_call(fn, *args, policy=policy, clock=clock,
                         **kwargs)
    except RetryExhausted as e:
        tel.counter("probe_timeouts", target=target)
        raise ProbeTimeout(target, deadline, elapsed=e.elapsed,
                           deadline_expired=e.deadline_expired,
                           last=e.last) from e.last
    elapsed = clock.monotonic() - start
    if elapsed > deadline:
        tel.counter("probe_timeouts", target=target)
        raise ProbeTimeout(target, deadline, elapsed=elapsed,
                           deadline_expired=True)
    return out
