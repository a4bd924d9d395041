"""Host-level fault adversaries — the fault plane above chaos/dispatch.py;
a copy of ``ceph_tpu/chaos/hosts.py``.  The plans are host state
machines; the supervisor (ops/supervisor.py) polls them at every
dispatch seam, and their host-granular answer is the host-aware data
plane (parallel/plane.py): on a multi-host plane a host fault is
classified ``host_loss`` and the supervisor halves the hosts; with no
plane it demotes the tier, or raises DeviceDispatchError on the card.

``DispatchFault`` kills *calls*; a ``HostFault`` kills a *fault
domain*: every device one host contributes to the data plane goes away
at once.  The supervised dispatch plane (ops/supervisor.py) classifies
the injected errors as ``host_loss`` and answers with a host-granular
reshrink (hosts 4→2→1, then the existing per-device ladder inside the
survivor), journal-backed re-dispatch of the in-flight batch, and
health-probe re-promotion once the plan clears — see the reference's
docs/ROBUSTNESS.md "Host fault domains".

Three adversaries, all seeded and deterministic:

- ``HostLoss``     — the host drops at the Nth poll and stays down
                     (``calls=None``) or comes back after a window;
- ``HostFlap``     — down/up cycling: ``calls`` polls down,
                     ``up_calls`` polls up, for ``cycles`` cycles;
- ``HostPartition``— the host is *reachable but fenced*: its writes
                     must be discarded (epoch-fenced) rather than
                     merged, so the injected error carries a distinct
                     type the journal re-dispatch path can assert on.

A ``HostFaultPlan`` is armed process-globally (``arm_host_plan`` /
``host_faults``) and polled by the supervisor at every dispatch seam
with the plane's *current* host count: a fault only fires while its
host index is still part of the plane (``fault.host < hosts``), so
after the reshrink evicts the dead host the plan goes quiet and the
redispatched batch completes — exactly the semantics of a real lost
host that the survivors stop routing to.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.locks import make_lock

HOST_FAULT_KINDS = ("host_loss", "host_flap", "host_partition")

# seam wildcard: the fault fires at whatever supervised seam polls next
ANY_SEAM = "*"


class InjectedHostLoss(RuntimeError):
    """A dispatch landed on a host the adversary has taken down."""


class InjectedHostPartition(RuntimeError):
    """A dispatch landed on a host fenced off by a network partition —
    the host is alive and may still emit stale writes, so recovery must
    epoch-fence its output, not merge it."""


@dataclass
class HostFault:
    """One armed host fault: ``host`` goes down at the ``at``-th poll
    of a matching seam (1-based), for ``calls`` polls (None =
    persistent).  ``up_calls``/``cycles`` turn the window into a flap:
    ``calls`` down, ``up_calls`` up, repeated ``cycles`` times
    (0 = forever)."""

    kind: str
    host: int = 1
    seam: str = ANY_SEAM
    at: int = 1
    calls: Optional[int] = None
    up_calls: int = 0
    cycles: int = 0

    def __post_init__(self) -> None:
        if self.kind not in HOST_FAULT_KINDS:
            raise ValueError(f"unknown host fault kind: {self.kind!r}")
        if self.host < 0:
            raise ValueError("host index must be >= 0")
        if self.at < 1:
            raise ValueError("at is 1-based: must be >= 1")
        if self.calls is not None and self.calls < 1:
            raise ValueError("calls must be >= 1 (or None = persistent)")
        if self.up_calls < 0 or self.cycles < 0:
            raise ValueError("up_calls/cycles must be >= 0")
        if self.up_calls and self.calls is None:
            raise ValueError("a flap window needs finite calls")

    def matches(self, seam: str) -> bool:
        return self.seam == ANY_SEAM or self.seam == seam

    def active_at(self, idx: int) -> bool:
        """Is the host down at the idx-th matching poll (1-based)?"""
        if idx < self.at:
            return False
        if self.calls is None:
            return True  # persistent loss/partition
        if not self.up_calls:
            return idx < self.at + self.calls
        period = self.calls + self.up_calls
        off = idx - self.at
        if self.cycles and off >= period * self.cycles:
            return False
        return off % period < self.calls

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "host": self.host, "seam": self.seam,
            "at": self.at, "calls": self.calls,
            "up_calls": self.up_calls, "cycles": self.cycles,
        }


def HostLoss(host: int = 1, *, seam: str = ANY_SEAM, at: int = 1,
             calls: Optional[int] = None) -> HostFault:
    """Host ``host`` drops at the ``at``-th poll; ``calls=None`` keeps
    it down until the plan is cleared (the acceptance adversary)."""
    return HostFault("host_loss", host=host, seam=seam, at=at, calls=calls)


def HostFlap(host: int = 1, *, seam: str = ANY_SEAM, at: int = 1,
             calls: int = 2, up_calls: int = 2,
             cycles: int = 0) -> HostFault:
    """Host ``host`` cycles down/up: ``calls`` polls down, ``up_calls``
    up, for ``cycles`` cycles (0 = until cleared)."""
    return HostFault("host_flap", host=host, seam=seam, at=at,
                     calls=calls, up_calls=up_calls, cycles=cycles)


def HostPartition(host: int = 1, *, seam: str = ANY_SEAM, at: int = 1,
                  calls: Optional[int] = None) -> HostFault:
    """Host ``host`` is fenced (reachable, but its writes are stale)."""
    return HostFault("host_partition", host=host, seam=seam, at=at,
                     calls=calls)


@dataclass(frozen=True)
class FiredHostFault:
    kind: str
    host: int
    seam: str
    call: int
    detail: str = ""


class HostFaultPlan:
    """A seeded, seam-indexed host fault schedule (the host-domain twin
    of chaos.dispatch.DispatchFaultPlan).  ``poll(seam, hosts)`` is the
    supervisor's per-dispatch question: *with the plane currently
    spanning ``hosts`` hosts, does this dispatch land on a dead one?*"""

    def __init__(self, faults: Sequence[HostFault], seed: int = 0):
        self.faults: Tuple[HostFault, ...] = tuple(faults)
        self.seed = int(seed)
        self._lock = make_lock("chaos.hosts.HostFaultPlan._lock")
        self._calls: Dict[str, int] = {}
        self.fired: List[FiredHostFault] = []
        self._cleared = False

    # -- polling ------------------------------------------------------

    def poll(self, seam: str, hosts: int) -> Optional[HostFault]:
        """Advance the per-seam call counter; return the fault whose
        host this dispatch lands on, or None.  A fault only fires while
        its host is still part of the plane (``host < hosts``) — after
        the reshrink evicts it, the plan goes quiet.  ``hosts <= 0``
        (the numpy floor: no plane at all) still advances the window so
        flap timelines stay aligned, but nothing fires."""
        fault = None
        call = 0
        with self._lock:
            if not self._cleared:
                call = self._calls.get(seam, 0) + 1
                self._calls[seam] = call
                for f in self.faults:
                    if (f.matches(seam) and f.active_at(call)
                            and 0 <= f.host < hosts):
                        fault = f
                        self.fired.append(FiredHostFault(
                            f.kind, f.host, seam, call,
                            detail=f"hosts={hosts}"))
                        break
        if fault is not None:
            # emitted outside the lock: telemetry takes its own locks
            from ..telemetry import metrics as tel

            tel.counter("chaos_injections", kind=fault.kind)
        return fault

    def active(self, seam: str, hosts: int) -> Optional[HostFault]:
        """Non-consuming peek: the fault the NEXT poll would fire."""
        with self._lock:
            if self._cleared:
                return None
            call = self._calls.get(seam, 0) + 1
            for f in self.faults:
                if (f.matches(seam) and f.active_at(call)
                        and 0 <= f.host < hosts):
                    return f
        return None

    def down_hosts(self, hosts: int) -> Tuple[int, ...]:
        """Host indices currently down at any seam's next poll —
        plane-membership filtered like poll()."""
        down = set()
        with self._lock:
            if self._cleared:
                return ()
            for f in self.faults:
                call = self._calls.get(f.seam, 0) + 1
                if f.active_at(call) and 0 <= f.host < hosts:
                    down.add(f.host)
        return tuple(sorted(down))

    def pending_persistent(self) -> bool:
        """Is a persistent (``calls=None``) loss/partition still armed?
        Plane-independent on purpose: the health probe must keep
        failing while the adversary holds the host down, even though
        the shrunken plane no longer routes to it."""
        with self._lock:
            if self._cleared:
                return False
            return any(f.calls is None for f in self.faults)

    def clear(self) -> None:
        """The adversary releases the host (recovery): polls stop
        firing and pending_persistent() goes False, so the health
        probe chain can re-promote."""
        with self._lock:
            self._cleared = True

    def summary(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "cleared": self._cleared,
                "calls": dict(self._calls),
                "fired": len(self.fired),
                "fired_kinds": sorted({f.kind for f in self.fired}),
                "faults": [f.to_dict() for f in self.faults],
            }


# ----------------------------------------------------------------------
# the process-global armed plan (mirrors chaos.dispatch)

_active: Optional[HostFaultPlan] = None

_lock = make_lock("chaos.hosts._lock")


def active_host_plan() -> Optional[HostFaultPlan]:
    with _lock:
        return _active


def arm_host_plan(plan: Optional[HostFaultPlan]) -> Optional[HostFaultPlan]:
    """Install (or clear, with None) the global plan; returns the
    previous one so callers can restore it."""
    global _active
    with _lock:
        prev = _active
        _active = plan
    return prev


@contextmanager
def host_faults(plan: HostFaultPlan):
    """Scope a plan: armed on entry, previous plan restored on exit."""
    prev = arm_host_plan(plan)
    try:
        yield plan
    finally:
        arm_host_plan(prev)


def host_chaos_selftest() -> dict:
    """The host fault-domain arc (the reference's ``chaos.host_plane``
    audit entry): on an isolated supervisor (own FakeClock and
    FallbackPolicy, no pattern cache), a seeded HostLoss fires
    mid-stream and the full survival arc must run; the dispatched
    callables are numpy, the plane (over the CPU's members, the kind of
    a host row) is bookkeeping.

    When two or more fault domains can form over the visible members
    the host-granular arc runs: loss → reshrink (hosts halve, the
    survivor keeps its members) → journal reclaim hook → quiet plan →
    health-probe re-promotion restoring the original topology.  With a
    single member the planeless arc runs instead: the process is its
    one fault domain, so losing host 0 demotes straight to the
    ground-truth twin and heals by re-promotion."""
    import numpy as np

    from ..ops.fallback import FallbackPolicy
    from ..ops.supervisor import DispatchSupervisor
    from ..parallel import plane as planemod
    from ..utils.retry import FakeClock

    pol = FallbackPolicy(force="torch")
    sup = DispatchSupervisor(
        clock=FakeClock(), policy=pol, cache_clear=lambda: None,
        promote_after=2, probe_every=1)
    data = np.arange(64, dtype=np.uint8).reshape(4, 16)

    def body(x):
        return x ^ np.uint8(0x5A)

    want = body(data)
    reclaimed: List[str] = []
    sup.set_inflight_reclaim(lambda seam: reclaimed.append(seam) or 2)

    prev_plane = planemod.set_data_plane(None)
    # the dispatches are host rows: only a plane of the host's kind
    # narrows for them
    plane0 = planemod.activate(None, hosts=2, kind="cpu")
    multi = plane0 is not None and plane0.hosts >= 2
    plan = HostFaultPlan(
        [HostLoss(1 if multi else 0, seam="selftest.host", at=2,
                  calls=2)], seed=11)
    prev = arm_host_plan(plan)
    try:
        for _ in range(4):
            got = sup.dispatch("selftest.host", body, (data,),
                               host_fn=body, rebuild=lambda: body)
            if not np.array_equal(np.asarray(got), want):
                raise AssertionError("host-chaos output diverged")
        st = sup.stats()
        if multi:
            # the reshrink itself (2xN -> 1xN) is transient state: a
            # finite-window fault heals as soon as the probes run
            # clean, so the counters are the durable evidence
            if st["host_quarantines"] < 1:
                raise AssertionError(f"no host quarantine: {st}")
            if st["journal_redispatches"] != 2 or not reclaimed:
                raise AssertionError(f"in-flight reclaim skipped: {st}")
        elif st["demotions"] < 1 or st["host_completions"] < 1:
            raise AssertionError(f"planeless loss not demoted: {st}")
        plan.clear()
        for _ in range(sup.promote_after + 2):
            sup.tick()
        st = sup.stats()
        if multi:
            if st["host_repromotions"] < 1:
                raise AssertionError(f"host width not restored: {st}")
            p = planemod.data_plane()
            if p is None or p.hosts != plane0.hosts:
                raise AssertionError("plane topology not restored")
        elif st["demoted"]:
            raise AssertionError(f"planeless loss never healed: {st}")
    finally:
        arm_host_plan(prev)
        planemod.set_data_plane(prev_plane)
    out = dict(sup.stats())
    out["plan"] = plan.summary()
    out["multi_host"] = multi
    return out


__all__ = [
    "ANY_SEAM",
    "HOST_FAULT_KINDS",
    "FiredHostFault",
    "HostFault",
    "HostFaultPlan",
    "HostFlap",
    "HostLoss",
    "HostPartition",
    "InjectedHostLoss",
    "InjectedHostPartition",
    "active_host_plan",
    "arm_host_plan",
    "host_chaos_selftest",
    "host_faults",
]
