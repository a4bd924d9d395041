"""Rateless straggler-tolerant recovery — over-plan, take first-k; a
copy of ``ceph_tpu/cluster/rateless.py`` whose dispatch is the port's
fused repair.

The load-balancing result of arXiv 1804.10331 (PAPERS.md): when decode
work is over-planned with redundancy factor ``r`` — every unit
dispatched to r distinct shards — and the FIRST completion per unit
wins (the rest cancelled or skipped), aggregate completion time
concentrates near the fast shards' rate even when a shard is an
order of magnitude slow.  That is exactly the recovery shape a
10k-OSD cluster under a churn storm needs: ``recover_to_completion``
must never stall on the slowest device.

Composition with the real stack, deterministic end to end:

- **units** are damaged objects (a deep-scrub classification pass),
  with work proportional to the bytes their erased shards must
  rebuild;
- **shards** are the data-plane's members (parallel/plane.py::
  shard_count — 8 when no plane is active) and their speed is the
  seeded :class:`~ceph_tpu_torch.chaos.adversaries.Straggler` adversary
  (the canonical torture: one shard 10× slower);
- the **schedule** is a discrete-event simulation over the
  adversary's service times — no wall clock, no threads, replayable
  from (seed, scenario) like every chaos artifact.  A copy reaching
  the head of a shard's queue after its unit already completed is
  SKIPPED (the cancel); a unit whose winning copy was not its primary
  assignment counts as a ``straggler_reassignment``;
- the **bytes** are healed ONCE per unit through the real recovery
  orchestrator (journal, epoch fence, throttle) — the decode→
  re-encode program is the engine's fused repair call
  (``rateless_dispatch_call``), identical on every shard, so which
  copy wins can never change a byte: first-k is byte-identical to
  all-k by construction, and the zero-data-loss/heal gates are the
  orchestrator's own;
- the measured per-shard **completion skew** becomes a per-OSD weight
  vector fed into :class:`~ceph_tpu_torch.recovery.throttle.
  OsdRecoveryThrottle` (``set_osd_weights``), closing the loop: the
  next round's admissions bend away from the devices that proved
  slow.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chaos.adversaries import Straggler
from ..telemetry import metrics as tel
from ..telemetry.spans import global_tracer


def rateless_dispatch_call(ec, available, erased, mesh=None):
    """The device program ONE over-planned copy dispatches — exactly
    the engine's fused decode→re-encode repair program (codes/
    engine.py), cached in the same PatternCache keyspace.  Copies are
    the same program on different shards and first-k selection is
    host scheduling, so byte identity across winners holds by
    construction.  Registered as the ``cluster.rateless_dispatch``
    audit entry (analysis/entrypoints.py)."""
    from ..codes.engine import fused_repair_call
    return fused_repair_call(ec, tuple(available), tuple(erased),
                             mesh=mesh)


def plan_assignments(n_units: int, n_shards: int, redundancy: int,
                     seed: int = 0) -> List[Tuple[int, ...]]:
    """unit -> r distinct shards: primary round-robin (load-balanced
    by construction), secondaries drawn seeded without replacement —
    deterministic per (n_units, n_shards, redundancy, seed)."""
    r = max(1, min(redundancy, n_shards))
    rng = np.random.default_rng((seed, n_units, n_shards, r))
    plan: List[Tuple[int, ...]] = []
    for u in range(n_units):
        primary = u % n_shards
        others = [s for s in range(n_shards) if s != primary]
        extra = (rng.choice(len(others), size=r - 1, replace=False)
                 if r > 1 else [])
        plan.append((primary,
                     *(others[int(i)] for i in sorted(extra))))
    return plan


@dataclass
class Schedule:
    """The simulated first-k schedule over one assignment plan."""

    completion_s: List[float] = field(default_factory=list)  # per unit
    winner: List[Tuple[int, int]] = field(default_factory=list)
    wins_by_shard: Dict[int, int] = field(default_factory=dict)
    busy_by_shard: Dict[int, float] = field(default_factory=dict)
    work_by_shard: Dict[int, float] = field(default_factory=dict)
    executed_copies: int = 0
    cancelled_copies: int = 0
    straggler_reassignments: int = 0
    makespan_s: float = 0.0

    _winning_busy: float = 0.0

    @property
    def wasted_fraction(self) -> float:
        """Losing-copy busy time / total busy time — the price of
        over-planning (bounded by (r-1)/r, far under it in practice
        because completed units cancel queued copies)."""
        total = sum(self.busy_by_shard.values())
        if not total:
            return 0.0
        return max(0.0, (total - self._winning_busy) / total)


def simulate_first_k(plan: Sequence[Tuple[int, ...]],
                     model: Straggler,
                     work: Sequence[float]) -> Schedule:
    """Discrete-event first-k schedule: each shard serves its copy
    queue in plan order; a copy whose unit is already complete when
    the shard frees up is skipped (cancelled), otherwise it runs to
    completion and the unit's finish time is the min over its copies.
    Pure function of (plan, model, work)."""
    n_shards = 1 + max((s for copies in plan for s in copies),
                       default=0)
    queues: List[List[Tuple[int, int]]] = [[] for _ in range(n_shards)]
    for u, copies in enumerate(plan):
        for j, s in enumerate(copies):
            queues[s].append((u, j))
    heads = [0] * n_shards
    done: Dict[int, float] = {}
    winner: Dict[int, Tuple[int, int]] = {}
    sched = Schedule()
    # (free_time, shard) min-heap; ties broken by shard id for
    # determinism
    heap = [(0.0, s) for s in range(n_shards) if queues[s]]
    heapq.heapify(heap)
    while heap:
        t, s = heapq.heappop(heap)
        if heads[s] >= len(queues[s]):
            continue
        u, j = queues[s][heads[s]]
        heads[s] += 1
        if u in done and done[u] <= t:
            # first-k already satisfied before this copy started: skip
            sched.cancelled_copies += 1
            if heads[s] < len(queues[s]):
                heapq.heappush(heap, (t, s))
            continue
        dt = model.service_time(s, u, work[u])
        t_end = t + dt
        sched.executed_copies += 1
        sched.busy_by_shard[s] = sched.busy_by_shard.get(s, 0.0) + dt
        sched.work_by_shard[s] = sched.work_by_shard.get(s, 0.0) \
            + float(work[u])
        if u not in done or t_end < done[u]:
            done[u] = t_end
            winner[u] = (s, j)
        sched.makespan_s = max(sched.makespan_s, t_end)
        if heads[s] < len(queues[s]):
            heapq.heappush(heap, (t_end, s))
    for u in range(len(plan)):
        sched.completion_s.append(done[u])
        s, j = winner[u]
        sched.winner.append((s, j))
        sched.wins_by_shard[s] = sched.wins_by_shard.get(s, 0) + 1
        if j != 0:
            sched.straggler_reassignments += 1
        sched._winning_busy += model.service_time(s, u, work[u])
    return sched


# skew below this is service-time jitter, not a slow device — snapped
# to 1.0 so the throttle only bends away from REAL stragglers
WEIGHT_NOISE_FLOOR = 0.8


def shard_weights(sched: Schedule) -> Dict[int, float]:
    """Per-shard relative speed in (0, 1] from the measured completion
    skew: a shard's effective seconds-per-work, normalized so the
    fastest observed shard weighs 1.0.  Skew within the noise floor
    snaps to 1.0 (jitter is not a straggler); shards that executed
    nothing stay unweighted."""
    rates: Dict[int, float] = {}
    for s, busy in sched.busy_by_shard.items():
        w = sched.work_by_shard.get(s, 0.0)
        if w > 0:
            rates[s] = busy / w          # seconds per unit of work
    if not rates:
        return {}
    fastest = min(rates.values())
    out: Dict[int, float] = {}
    for s, t in rates.items():
        w = max(min(fastest / t, 1.0), 1e-3)
        out[s] = 1.0 if w >= WEIGHT_NOISE_FLOOR else w
    return out


@dataclass
class RatelessReport:
    """One rateless recovery run's accounting."""

    n_units: int = 0
    n_shards: int = 0
    redundancy: int = 0
    schedule: Optional[Schedule] = None
    p50_s: float = 0.0
    p99_s: float = 0.0
    max_s: float = 0.0
    throttle_weights: Dict[int, float] = field(default_factory=dict)
    recovery: Optional[dict] = None

    def to_dict(self) -> dict:
        s = self.schedule
        return {
            "n_units": self.n_units,
            "n_shards": self.n_shards,
            "redundancy": self.redundancy,
            "p50_s": round(self.p50_s, 6),
            "p99_s": round(self.p99_s, 6),
            "max_s": round(self.max_s, 6),
            "makespan_s": round(s.makespan_s, 6) if s else None,
            "straggler_reassignments":
                s.straggler_reassignments if s else 0,
            "cancelled_copies": s.cancelled_copies if s else 0,
            "executed_copies": s.executed_copies if s else 0,
            "wasted_fraction":
                round(s.wasted_fraction, 4) if s else 0.0,
            "wins_by_shard": dict(s.wins_by_shard) if s else {},
            "throttle_weights": {k: round(v, 4) for k, v in
                                 sorted(self.throttle_weights.items())},
            "recovery": self.recovery,
        }


def rateless_recover(sinfo, ec, osdmap, pool_id: int, ps: int,
                     stores, hinfos, *,
                     redundancy: int = 2,
                     straggler: Optional[Straggler] = None,
                     n_shards: Optional[int] = None,
                     throttle=None,
                     osd_shard: Optional[Callable[[int], int]] = None,
                     seed: int = 0,
                     device: Optional[bool] = None,
                     **recover_kw):
    """Straggler-tolerant recovery of one pg's damaged objects:
    classify → over-plan (redundancy r across the mesh shards) →
    first-k schedule under the Straggler adversary → feed completion
    skew into the throttle → heal for real through
    ``recover_to_completion``.  Returns (RecoveryReport,
    RatelessReport); per-unit completion times land in the
    ``cluster_recovery_op_seconds`` histogram.

    ``osd_shard``: osd -> shard mapping for the weight feedback
    (default ``osd % n_shards`` — the stripe-round-robin the mesh
    plane implies)."""
    from ..parallel.plane import shard_count
    from ..recovery.orchestrator import recover_to_completion
    from ..recovery.throttle import OsdRecoveryThrottle
    from ..scrub.deep_scrub import deep_scrub

    if n_shards is None:
        n_shards = shard_count(default=8)
    if straggler is None:
        straggler = Straggler(seed=seed)
    if throttle is None:
        throttle = OsdRecoveryThrottle()
    tracer = global_tracer()
    rep = RatelessReport(n_shards=n_shards,
                         redundancy=max(1, min(redundancy, n_shards)))

    with tracer.span("cluster.rateless", shards=n_shards,
                     redundancy=redundancy):
        # classify: damaged objects become the over-planned work units
        units: List[int] = []
        work: List[float] = []
        with tracer.span("classify", objects=len(stores)):
            for i, (store, hinfo) in enumerate(zip(stores, hinfos)):
                sr = deep_scrub(sinfo, ec, store, hinfo)
                if not sr.is_clean:
                    units.append(i)
                    # work ~ bytes the erased shards must rebuild
                    work.append(max(len(sr.bad), 1)
                                * sr.shard_length / float(1 << 16))
        rep.n_units = len(units)
        if units:
            plan = plan_assignments(len(units), n_shards,
                                    rep.redundancy, seed=seed)
            sched = simulate_first_k(plan, straggler, work)
            rep.schedule = sched
            comp = np.asarray(sched.completion_s)
            rep.p50_s = float(np.percentile(comp, 50))
            rep.p99_s = float(np.percentile(comp, 99))
            rep.max_s = float(comp.max())
            for t in sched.completion_s:
                tel.observe("cluster_recovery_op_seconds", float(t))
            tel.counter("cluster_straggler_reassignments",
                        sched.straggler_reassignments)
            # completion skew -> per-OSD throttle weights
            sw = shard_weights(sched)
            shard_of = osd_shard or (lambda o: o % n_shards)
            rep.throttle_weights = {
                o: sw[shard_of(o)] for o in range(osdmap.max_osd)
                if shard_of(o) in sw and sw[shard_of(o)] < 1.0}
            throttle.set_osd_weights(rep.throttle_weights)
        # the real heal: journal + epoch fence + (now weighted)
        # throttle; decode math identical no matter which copy won
        with tracer.span("heal", units=rep.n_units):
            rec = recover_to_completion(
                sinfo, ec, osdmap, pool_id, ps, stores, hinfos,
                throttle=throttle, device=device, **recover_kw)
        rep.recovery = rec.to_dict()
    return rec, rep


__all__ = ["RatelessReport", "Schedule", "Straggler",
           "plan_assignments", "rateless_dispatch_call",
           "rateless_recover", "shard_weights", "simulate_first_k"]
