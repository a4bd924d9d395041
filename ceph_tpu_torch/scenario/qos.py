"""mClock-style QoS arbitration between client SLOs and background work;
a copy of ``ceph_tpu/scenario/qos.py``.

Reference: the mClock scheduler Ceph's osd_op_queue adopted
(src/osd/scheduler/mClockScheduler.cc, after Gulati et al., OSDI'10):
every op class carries three tags —

- **reservation** (ops/s): the guaranteed floor.  A class with unmet
  reservation is served no matter what else is happening; this is why
  recovery can be throttled but never starved.
- **weight**: the proportional share of whatever capacity remains
  after reservations; granted here at ``weight_rate`` ops/s per
  weight unit.
- **limit** (ops/s): the hard ceiling a class may never exceed even
  on an idle system.

Tags advance on the *injectable clock* (max(tag, now) + 1/rate on
every grant — the standard mClock recurrence), so a FakeClock
scenario arbitrates byte-identically from its seed.

The SLO feedback loop (the piece plain mClock lacks): every served
client request lands in :meth:`MClockArbiter.record_client` (the
scenario runner feeds it from the same stream the
:class:`~ceph_tpu_torch.serve.sla.BurnRateMonitor` watches).  The rolling
deadline-miss rate over ``window`` requests becomes ``pressure`` —
0.0 at/below the miss budget, 1.0 at ``burn`` x budget (the burn-rate
trip point) — and ``background_scale`` ramps from 1.0 down to
``floor`` as pressure rises.  Scale multiplies background classes'
weight-phase rate and limit (never their reservation): SLO burning ⇒
background yields; SLO healthy ⇒ recovery opens back up.  The same
scale feeds :meth:`~ceph_tpu_torch.recovery.throttle.OsdRecoveryThrottle.
set_scale`, so per-OSD write admissions re-clamp live too.

Host bookkeeping only — no device, no kernel setups, pinned by the
``scenario.qos`` host-tier audit entry (analysis/entrypoints.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..telemetry import metrics as tel
from ..telemetry import tracing

CLIENT = "client"
BACKGROUND = ("recovery", "scrub", "rebalance")
CLASSES = (CLIENT,) + BACKGROUND


@dataclass
class _ClassState:
    """One class's mClock tag triple (absolute clock times)."""

    r_tag: Optional[float] = None
    p_tag: Optional[float] = None
    l_tag: Optional[float] = None
    grants: int = 0
    reservation_grants: int = 0
    denials: Dict[str, int] = field(default_factory=dict)


class MClockArbiter:
    """Reservation/weight/limit admission for background op classes,
    scaled live by the client deadline-miss burn rate.

    ``admit(cls)`` answers "may one op of this class run now?": client
    ops always pass (they are what the SLO protects — the arbiter
    bends the background around them, not the reverse); a background
    op passes via its reservation tag, else via its weight tag at the
    scaled proportional rate, and never past its scaled limit tag.
    ``hold_for(cls)`` is the deterministic back-off: seconds until the
    earliest tag that could grant — the drain loop sleeps exactly that
    on the injectable clock instead of spinning.
    """

    def __init__(self, spec=None, clock=None, enabled: Optional[bool]
                 = None) -> None:
        from ..utils.detcheck import default_clock
        from ..utils.retry import SystemClock
        from .spec import QosSpec

        self.spec = spec if spec is not None else QosSpec()
        self.clock = clock if clock is not None \
            else default_clock("scenario.qos.MClockArbiter",
                               SystemClock)
        self.enabled = (self.spec.enabled if enabled is None
                        else enabled)
        self._state: Dict[str, _ClassState] = {
            c: _ClassState() for c in CLASSES}
        # per-(tenant, client) foreground tags: each
        # registered tenant carries its own reservation/weight/limit
        # triple over the standard mClock recurrence.  Foreground tags
        # are NEVER multiplied by the background scale — a tenant is
        # capped by its own limit, not throttled by cluster pressure —
        # and the reservation phase always grants, so a tenant's
        # guaranteed floor cannot be starved by any neighbor.
        self._tenants: Dict[str, dict] = {}
        self._window: List[int] = []
        self._misses = 0
        self.scale_min = 1.0
        self.burn_trips = 0
        self._burning = False

    # -- SLO feedback ----------------------------------------------------

    def record_client(self, deadline_met: bool) -> None:
        """Fold one served client request into the rolling miss
        window (the runner calls this for every EcResult)."""
        miss = 0 if deadline_met else 1
        self._window.append(miss)
        self._misses += miss
        if len(self._window) > self.spec.window:
            self._misses -= self._window.pop(0)
        if self.pressure() >= 1.0:
            if not self._burning:
                self._burning = True
                self.burn_trips += 1
                tel.counter("qos_burn_trips")
                tel.event("qos_burn", miss_rate=self.miss_rate(),
                          budget=self.spec.miss_budget)
        else:
            self._burning = False

    def miss_rate(self) -> float:
        if not self._window:
            return 0.0
        return self._misses / len(self._window)

    def pressure(self) -> float:
        """0.0 at/below the miss budget, 1.0 at burn x budget,
        linear between — half-warm windows count (a cliff must bite
        before the window fills)."""
        budget = self.spec.miss_budget
        trip = budget * self.spec.burn
        rate = self.miss_rate()
        if rate <= budget:
            return 0.0
        return min(1.0, (rate - budget) / max(trip - budget, 1e-9))

    def background_scale(self) -> float:
        """The live multiplier on background weight-rate and limit:
        1.0 when the SLO is healthy, down to ``floor`` at full burn.
        Reservations are never scaled."""
        if not self.enabled:
            return 1.0
        s = 1.0 - (1.0 - self.spec.floor) * self.pressure()
        self.scale_min = min(self.scale_min, s)
        return s

    # -- admission -------------------------------------------------------

    def admit(self, cls: str, now: Optional[float] = None) -> bool:
        if cls not in CLASSES:
            raise ValueError(f"qos class {cls!r} not in {CLASSES}")
        st = self._state[cls]
        if cls == CLIENT or not self.enabled:
            st.grants += 1
            return True
        if now is None:
            now = self.clock.monotonic()
        scale = self.background_scale()
        res = self.spec.reservation.get(cls, 0.0)
        limit = self.spec.limit.get(cls, 0.0) * scale
        rate = (self.spec.weight.get(cls, 0.0)
                * self.spec.weight_rate * scale)
        if st.r_tag is None:
            st.r_tag = st.p_tag = st.l_tag = now
        if limit > 0 and st.l_tag > now:
            return self._deny(cls, st, "limit", now, scale)
        if res > 0 and st.r_tag <= now:
            st.r_tag = max(st.r_tag, now) + 1.0 / res
            st.reservation_grants += 1
            return self._grant(cls, st, now, rate, limit,
                               phase="reservation", scale=scale)
        if rate > 0 and st.p_tag <= now:
            return self._grant(cls, st, now, rate, limit,
                               phase="weight", scale=scale)
        return self._deny(cls, st, "weight", now, scale)

    def _grant(self, cls: str, st: _ClassState, now: float,
               rate: float, limit: float, phase: str,
               scale: float = 1.0) -> bool:
        if rate > 0:
            st.p_tag = max(st.p_tag, now) + 1.0 / rate
        if limit > 0:
            st.l_tag = max(st.l_tag, now) + 1.0 / limit
        st.grants += 1
        tel.counter("qos_grants", cls=cls, phase=phase)
        if tracing.enabled():
            # causal trace: every background decision with
            # the arbiter's pressure + background scale AT decision
            # time — a tail sample's arbiter_hold names its cause
            c = tracing.active()
            c.add_qos(cls, True, phase, now,
                      pressure=self.pressure(), scale=scale)
        return True

    def _deny(self, cls: str, st: _ClassState, reason: str,
              now: Optional[float] = None,
              scale: float = 1.0) -> bool:
        st.denials[reason] = st.denials.get(reason, 0) + 1
        tel.counter("qos_denials", cls=cls, reason=reason)
        if tracing.enabled():
            c = tracing.active()
            c.add_qos(cls, False, reason,
                      now if now is not None
                      else self.clock.monotonic(),
                      pressure=self.pressure(), scale=scale)
        return False

    # -- per-tenant foreground admission ---------------------------------

    def register_tenant(self, name: str, reservation: float = 0.0,
                        weight: float = 1.0,
                        limit: float = 0.0) -> None:
        """Register one tenant's (reservation, weight, limit) client
        tags.  ``limit`` ops/s is the hard ceiling — the noisy-
        neighbor clamp; 0 = uncapped.  ``reservation`` ops/s is the
        guaranteed floor (accounting: those grants are reservation-
        phase, never deniable); ``weight`` paces the proportional
        share at ``weight_rate`` ops/s per unit."""
        self._tenants[str(name)] = {
            "reservation": float(reservation),
            "weight": float(weight), "limit": float(limit),
            "st": _ClassState()}

    def admit_tenant(self, name: str,
                     now: Optional[float] = None) -> bool:
        """Front-door admission for one tenant client request.  The
        ONLY denial is the tenant's own limit tag (mClock's hard
        ceiling): a request inside the limit is granted — via the
        reservation phase while the reservation tag is due, else the
        weight phase — because a foreground request past its weight
        pacing still deserves service on an idle system; the limit is
        what isolates neighbors.  Disabled arbiter (the control) and
        unregistered tenants always pass."""
        ts = self._tenants.get(name)
        if ts is None or not self.enabled:
            self._state[CLIENT].grants += 1
            return True
        if now is None:
            now = self.clock.monotonic()
        st = ts["st"]
        if st.r_tag is None:
            st.r_tag = st.p_tag = st.l_tag = now
        limit = ts["limit"]
        if limit > 0 and st.l_tag > now:
            st.denials["limit"] = st.denials.get("limit", 0) + 1
            tel.counter("qos_denials", cls=CLIENT, tenant=name,
                        reason="limit")
            if tracing.enabled():
                tracing.active().add_qos(
                    f"client:{name}", False, "limit", now,
                    pressure=self.pressure(), scale=1.0)
            return False
        res = ts["reservation"]
        if res > 0 and st.r_tag <= now:
            st.r_tag = max(st.r_tag, now) + 1.0 / res
            st.reservation_grants += 1
            phase = "reservation"
        else:
            phase = "weight"
        rate = ts["weight"] * self.spec.weight_rate
        if rate > 0:
            st.p_tag = max(st.p_tag, now) + 1.0 / rate
        if limit > 0:
            st.l_tag = max(st.l_tag, now) + 1.0 / limit
        st.grants += 1
        tel.counter("qos_grants", cls=CLIENT, tenant=name,
                    phase=phase)
        return True

    def tenant_hold(self, name: str,
                    now: Optional[float] = None) -> float:
        """Seconds until ``name``'s limit tag would next admit (0 =
        admissible now) — the deterministic shed-retry horizon."""
        ts = self._tenants.get(name)
        if ts is None or not self.enabled:
            return 0.0
        st = ts["st"]
        if st.l_tag is None or ts["limit"] <= 0:
            return 0.0
        if now is None:
            now = self.clock.monotonic()
        return max(0.0, st.l_tag - now)

    def hold_for(self, cls: str, now: Optional[float] = None) -> float:
        """Seconds until ``cls`` could next be granted (0 when it
        would pass right now) — the deterministic drain back-off."""
        if cls == CLIENT or not self.enabled:
            return 0.0
        st = self._state[cls]
        if now is None:
            now = self.clock.monotonic()
        if st.r_tag is None:
            return 0.0
        res = self.spec.reservation.get(cls, 0.0)
        # the earliest of the reservation / weight tags, pushed past
        # the limit tag (the limit gates both phases)
        nxt = min(st.r_tag if res > 0 else float("inf"), st.p_tag)
        nxt = max(nxt, st.l_tag)
        return max(0.0, nxt - now)

    # -- readout ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic per-class accounting for the ScenarioReport
        (local state only — never the process-global telemetry)."""
        out = {"enabled": self.enabled,
               "scale_min": round(self.scale_min, 6),
               "burn_trips": self.burn_trips,
               "miss_rate": round(self.miss_rate(), 6),
               "classes": {}}
        for cls in CLASSES:
            st = self._state[cls]
            out["classes"][cls] = {
                "grants": st.grants,
                "reservation_grants": st.reservation_grants,
                "denials": dict(sorted(st.denials.items())),
            }
        if self._tenants:
            # per-tenant accounting only when tenants are registered —
            # single-tenant snapshots stay byte-identical
            out["tenants"] = {}
            for name in sorted(self._tenants):
                ts = self._tenants[name]
                st = ts["st"]
                out["tenants"][name] = {
                    "reservation": ts["reservation"],
                    "weight": ts["weight"], "limit": ts["limit"],
                    "grants": st.grants,
                    "reservation_grants": st.reservation_grants,
                    "denials": dict(sorted(st.denials.items())),
                }
        return out


def qos_selftest() -> dict:
    """The arbiter as a host-tier audit workload: reservation floor,
    weight-phase pacing, limit ceiling and burn-rate scaling exercised
    on a FakeClock — no kernel setups, no device tensors
    (analysis/entrypoints.py ``scenario.qos``)."""
    from ..utils.retry import FakeClock
    from .spec import QosSpec

    clock = FakeClock()
    spec = QosSpec(reservation={"recovery": 2.0},
                   weight={"recovery": 4.0}, limit={"recovery": 40.0},
                   weight_rate=10.0, miss_budget=0.02, window=16)
    arb = MClockArbiter(spec, clock=clock)
    granted = 0
    for _ in range(200):
        if arb.admit("recovery"):
            granted += 1
        clock.sleep(0.005)
    healthy = granted
    for _ in range(16):             # a miss cliff: full burn
        arb.record_client(False)
    burn_scale = arb.background_scale()
    granted_burn = 0
    for _ in range(200):
        if arb.admit("recovery"):
            granted_burn += 1
        clock.sleep(0.005)
    for _ in range(64):             # recovery: window refills clean
        arb.record_client(True)
    assert healthy > granted_burn > 0, (healthy, granted_burn)
    assert burn_scale < 1.0
    assert arb.background_scale() == 1.0
    assert arb.hold_for("recovery") >= 0.0
    return arb.snapshot()


__all__ = ["BACKGROUND", "CLASSES", "CLIENT", "MClockArbiter",
           "qos_selftest"]
