"""Device-plane dispatch faults — the chaos family for the supervised
dispatch plane; a copy of ``ceph_tpu/chaos/dispatch.py``.

These are host state machines, consumed by the supervised dispatch
plane (ops/supervisor.py): every supervised seam polls the armed plan
once per dispatch attempt.  tests/test_torch_chaos.py holds their
firing tables to the reference's, and tests/test_torch_supervisor.py
the supervisor's responses.

The injectors in chaos/injectors.py damage *stored bytes*; the
adversaries in chaos/adversaries.py attack the *orchestration* (crash
sites, map churn).  This module attacks the third surface: the device
dispatch itself — the seam where a host call hands a batch to the device and
a tunnel drop, an HBM OOM, a hang or a corrupted DMA turns a healthy
program into a mid-run outage.  Fault kinds (the classification the
supervisor must recover):

- ``transient``     — the dispatch raises TransientBackendError for
                      the armed call window (flaky tunnel; bounded
                      utils/retry backoff must absorb it),
- ``oom``           — the dispatch raises a RESOURCE_EXHAUSTED-shaped
                      error (HBM OOM; the supervisor splits the batch
                      rung and redispatches the halves),
- ``backend_loss``  — the dispatch raises a backend-unavailable error
                      for every call in the window (the tunnel died;
                      live FallbackPolicy demotion down the tiers off
                      the card, DeviceDispatchError on it),
- ``hang``          — the dispatch consumes more than the supervisor's
                      deadline on the injectable clock and then fails
                      (a wedged device call; classified like loss),
- ``corrupt``       — the dispatch *succeeds* but one output byte is
                      bit-flipped (corrupted DMA/HBM; only the
                      supervisor's self-verify CRC can catch it).

Faults are armed per ``(seam, Nth call)``: a fault is ACTIVE for seam
call indices ``at <= idx < at + calls`` (1-based per-seam counters;
``calls=None`` = active until :meth:`DispatchFaultPlan.clear`).  All
randomness (the corrupt fault's victim byte/bit) derives from
``(seed, seam, call idx)``, so a (seed, faults) pair replays
byte-identically — the same contract every chaos artifact carries.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import TransientBackendError
from ..utils.locks import make_lock

DISPATCH_FAULT_KINDS = ("transient", "oom", "backend_loss", "hang",
                        "corrupt")

# seam may be an exact supervised-seam name or "*" (any seam)
ANY_SEAM = "*"


class InjectedBackendLoss(RuntimeError):
    """The injected 'backend died' dispatch error — the supervisor
    classifies it (and real backend-unavailable errors) as a
    persistent backend loss."""


class InjectedOom(RuntimeError):
    """The injected HBM-OOM dispatch error; the message carries the
    reference's RESOURCE_EXHAUSTED marker, so one classifier reads both
    packages' injected OOMs alike."""

    def __init__(self, seam: str) -> None:
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected HBM OOM at dispatch seam "
            f"{seam!r}")


class DispatchHang(RuntimeError):
    """Raised after an injected hang burned the supervisor's dispatch
    deadline on the injectable clock."""


@dataclass
class DispatchFault:
    """One armed device-plane fault.

    ``seam``: exact supervised seam name, or ``"*"`` for any seam.
    ``at``: the 1-based per-seam call index the fault first fires on.
    ``calls``: how many consecutive seam calls stay faulted (``None``
    = persistent until the plan is cleared/healed).
    """

    kind: str
    seam: str = ANY_SEAM
    at: int = 1
    calls: Optional[int] = 1

    def __post_init__(self) -> None:
        if self.kind not in DISPATCH_FAULT_KINDS:
            raise ValueError(f"dispatch fault kind {self.kind!r} must "
                             f"be one of {DISPATCH_FAULT_KINDS}")
        if self.at < 1:
            raise ValueError(f"at={self.at} must be >= 1 (1-based)")
        if self.calls is not None and self.calls < 1:
            raise ValueError(f"calls={self.calls} must be >= 1 or None")

    def matches(self, seam: str) -> bool:
        return self.seam in (ANY_SEAM, seam)

    def active_at(self, idx: int) -> bool:
        if idx < self.at:
            return False
        return self.calls is None or idx < self.at + self.calls

    def to_dict(self) -> dict:
        return {"kind": self.kind, "seam": self.seam, "at": self.at,
                "calls": self.calls}


@dataclass
class FiredFault:
    """One injection record — precise enough to replay the run."""

    kind: str
    seam: str
    call: int
    detail: str = ""


class DispatchFaultPlan:
    """A seeded set of armed dispatch faults + per-seam call counters.

    The supervisor polls the plan once per dispatch attempt; the plan
    answers with the active fault (consuming one call index for the
    seam) or None.  Byte-identically replayable from
    ``(seed, faults)`` — counters are deterministic because the
    supervised call order is."""

    def __init__(self, faults: Sequence[DispatchFault] = (),
                 seed: int = 0) -> None:
        self.faults: List[DispatchFault] = list(faults)
        self.seed = int(seed)
        self.calls: Dict[str, int] = {}
        self.fired: List[FiredFault] = []
        self.cleared = False
        self._lock = make_lock("chaos.dispatch.DispatchFaultPlan._lock")

    def arm(self, fault: DispatchFault) -> DispatchFault:
        with self._lock:
            self.faults.append(fault)
        return fault

    def poll(self, seam: str) -> Optional[DispatchFault]:
        """Consume one call index for ``seam``; return the active
        fault, recorded and counted, or None."""
        with self._lock:
            idx = self.calls.get(seam, 0) + 1
            self.calls[seam] = idx
            if self.cleared:
                return None
            for f in self.faults:
                if f.matches(seam) and f.active_at(idx):
                    self.fired.append(FiredFault(f.kind, seam, idx))
                    break
            else:
                return None
        from ..telemetry import metrics as tel
        tel.counter("chaos_injections", kind=f"dispatch_{f.kind}")
        return f

    def active(self, seam: str) -> Optional[DispatchFault]:
        """Non-consuming peek: would the NEXT poll of ``seam`` fault?
        (The supervisor's health probe asks this — a still-armed
        persistent fault means the backend is still down.)"""
        with self._lock:
            if self.cleared:
                return None
            idx = self.calls.get(seam, 0) + 1
            for f in self.faults:
                if f.matches(seam) and f.active_at(idx):
                    return f
        return None

    def pending_persistent(self) -> bool:
        """Any backend_loss/hang fault still (or yet to become)
        active on any seam — the 'fault has not cleared' signal the
        re-promotion probe must respect."""
        with self._lock:
            if self.cleared:
                return False
            for f in self.faults:
                if f.kind not in ("backend_loss", "hang"):
                    continue
                idx = self.calls.get(
                    f.seam if f.seam != ANY_SEAM else "", 0)
                if f.calls is None:
                    return True
                if f.seam == ANY_SEAM:
                    # conservative: any seam could still hit the window
                    if any(c < f.at + f.calls - 1
                           for c in self.calls.values()) \
                            or not self.calls:
                        return True
                elif idx < f.at + f.calls - 1:
                    return True
        return False

    def clear(self) -> None:
        """Heal: every armed fault stops firing (the 'tunnel came
        back' event the re-promotion probe then observes)."""
        with self._lock:
            self.cleared = True

    def corrupt_output(self, fault: DispatchFault, seam: str,
                       out):
        """Flip one seeded bit in the (first) output buffer —
        deterministic in (seed, seam, call idx).  Returns host numpy
        arrays mirroring the output structure (a tensor, on any device,
        is copied to the host first); the flipped position is recorded
        on the fired-fault entry."""
        with self._lock:
            idx = self.calls.get(seam, 0)
        rng = np.random.default_rng(
            [self.seed & 0x7FFFFFFF, _seam_token(seam), idx])
        parts = list(out) if isinstance(out, (tuple, list)) else [out]
        host = [np.array(p.detach().cpu().numpy() if hasattr(p, "detach")
                         else np.asarray(p), copy=True) for p in parts]
        flat = host[0].reshape(-1).view(np.uint8)
        pos = int(rng.integers(0, flat.size))
        bit = int(rng.integers(0, 8))
        flat[pos] ^= np.uint8(1 << bit)
        with self._lock:
            for rec in reversed(self.fired):
                if rec.seam == seam and rec.kind == "corrupt":
                    rec.detail = f"byte {pos} bit {bit}"
                    break
        if isinstance(out, tuple):
            return tuple(host)
        if isinstance(out, list):
            return host
        return host[0]

    def summary(self) -> dict:
        with self._lock:
            kinds: Dict[str, int] = {}
            for rec in self.fired:
                kinds[rec.kind] = kinds.get(rec.kind, 0) + 1
            return {"seed": self.seed, "cleared": self.cleared,
                    "calls": dict(sorted(self.calls.items())),
                    "fired": len(self.fired),
                    "fired_kinds": dict(sorted(kinds.items()))}


def _seam_token(seam: str) -> int:
    """A stable small integer for the rng seed sequence (hash() is
    per-process salted, so it would break cross-run replay)."""
    tok = 0
    for ch in seam:
        tok = (tok * 131 + ord(ch)) & 0x7FFFFFFF
    return tok


# ----------------------------------------------------------------------
# the process-wide armed plan (what the supervisor consults)

_active: Optional[DispatchFaultPlan] = None
_lock = make_lock("chaos.dispatch._lock")


def active_plan() -> Optional[DispatchFaultPlan]:
    with _lock:
        return _active


def arm_plan(plan: Optional[DispatchFaultPlan]
             ) -> Optional[DispatchFaultPlan]:
    """Install ``plan`` as the process dispatch-fault plan; returns
    the previous one (None disarms)."""
    global _active
    with _lock:
        prev = _active
        _active = plan
        return prev


@contextmanager
def dispatch_faults(faults: Sequence[DispatchFault], seed: int = 0):
    """Arm a seeded plan for the duration of a block (tests, demos,
    the scenario runner); restores whatever was armed before and
    yields the plan for assertions."""
    plan = DispatchFaultPlan(faults, seed=seed)
    prev = arm_plan(plan)
    try:
        yield plan
    finally:
        arm_plan(prev)


__all__ = [
    "ANY_SEAM", "DISPATCH_FAULT_KINDS", "DispatchFault",
    "DispatchFaultPlan", "DispatchHang", "FiredFault",
    "InjectedBackendLoss", "InjectedOom", "active_plan", "arm_plan",
    "dispatch_faults",
]
