"""Orchestrator-level adversaries: crashes and OSDMap churn.

A copy of ``ceph_tpu/chaos/adversaries.py``.

The shard-byte injectors (chaos/injectors.py) damage what is STORED;
these damage the recovery PROCESS itself — the two failure classes the
reference survives through its PG log / recovery-reservation machinery
and the mon's epoch-ordered map publication:

- ``CrashPoint``   — raise InjectedCrash deterministically at a named
  pipeline crash site (the recovery orchestrator visits every site by
  name; tools/recovery_demo.py --list-sites prints the catalogue).
  The "process died here" model: the exception unwinds the
  orchestrator, and only what the intent journal + stores carry
  survives into the resumed instance.
- ``MapChurn``     — a seeded sequence of mark_down/out, revive and
  reweight events applied as proper epoch-ordered Incrementals
  (crush/incremental.py) between pipeline stages, so every repair the
  orchestrator planned against epoch e can find the map at e+n by the
  time it dispatches or writes back.  ``max_down`` bounds concurrent
  churn-downed OSDs (the thrasher's "never exceed the failure budget"
  discipline); everything replays from (seed, params).

Both are plain state machines over injected randomness — no wall
clock, no threads — so any (seed, scenario) pair replays
byte-identically from the tests, the torture suite, the bench's
recovery-churn row, or tools/recovery_demo.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import InjectedCrash

# The crash-site catalogue (the reference's docs/ROBUSTNESS.md): every named point the
# recovery orchestrator visits, in pipeline order.  A CrashPoint can
# target any of them; the torture suite sweeps them all.
CRASH_SITES: Tuple[str, ...] = (
    "plan.after_scrub",          # ops planned, nothing dispatched
    "dispatch.before_decode",    # a pattern batch about to dispatch
    "writeback.after_intent",    # intent journaled, zero bytes written
    "writeback.after_write",     # >=1 shard written, op not committed
    "writeback.before_commit",   # all shards written, commit not logged
    "writeback.after_commit",    # committed, intent not yet cleared
)


@dataclass
class CrashPoint:
    """Deterministic named-site crash: raises InjectedCrash the
    ``at_hit``-th time ``visit(site)`` reaches ``site``, then disarms
    (so the resumed orchestrator runs the same code path to
    completion).  ``site=None`` never fires (the null adversary)."""

    site: Optional[str] = None
    at_hit: int = 1
    fired: bool = False
    hits: Dict[str, int] = field(default_factory=dict)

    def visit(self, site: str) -> None:
        self.hits[site] = self.hits.get(site, 0) + 1
        if self.fired or self.site is None or site != self.site:
            return
        if self.hits[site] >= self.at_hit:
            self.fired = True
            from ..telemetry import metrics as tel
            tel.counter("chaos_injections", kind="crash")
            tel.event("injected_crash", site=site, hit=self.hits[site])
            # a recovery crash site is a flight-recorder trigger: the
            # post-mortem blob freezes the span tree / counters the
            # "process" died with, before journal replay wipes the
            # evidence
            from ..telemetry import recorder
            recorder.trip("crash_site",
                          f"injected crash at {site}",
                          site=site, hit=self.hits[site])
            raise InjectedCrash(site, self.hits[site])


@dataclass
class MapChurn:
    """Seeded OSDMap churn driven through epoch-ordered incrementals.

    ``step(osdmap, stage)`` is the interleave point: the orchestrator
    (and repair_batched's on_batch hook) calls it between pipeline
    stages; the churn decides — deterministically from its seed —
    whether to fire an event there, builds an Incremental at epoch+1,
    applies it, and records what it did.

    Event kinds: ``down`` (mark an up+in OSD down AND out — the
    scrub-feedback shape that remaps CRUSH), ``revive`` (bring a
    churn-downed OSD back up+in), ``reweight`` (nudge a live OSD's
    weight within [IN/2, IN] — remaps without capacity loss).
    ``max_down`` bounds concurrent churn-downs; ``fire_every`` makes
    the cadence deterministic (every Nth step) instead of
    probabilistic ``p_fire``; ``stages`` restricts firing to named
    stages; ``avoid_osds`` protects OSDs from being downed (tests pin
    the victim set elsewhere)."""

    seed: int = 0
    max_down: int = 1
    p_fire: float = 0.5
    fire_every: Optional[int] = None
    max_events: Optional[int] = None
    stages: Optional[Sequence[str]] = None
    avoid_osds: Sequence[int] = ()
    # maps at or below this width use the legacy full live-set scan
    # (exact RNG schedule preserved for every existing seed); wider
    # maps pick victims by bounded seeded probes instead — a 100k-OSD
    # map must not pay an O(max_osd) scan per churn event
    scan_limit: int = 32768
    # runtime state (all derived deterministically from the seed)
    steps: int = 0
    events: List[dict] = field(default_factory=list)
    incrementals: List[object] = field(default_factory=list)
    downed: List[int] = field(default_factory=list)
    scan_fallbacks: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    @property
    def epochs_advanced(self) -> int:
        return len(self.events)

    def step(self, osdmap, stage: str = "") -> Optional[object]:
        """Maybe fire ONE churn event against ``osdmap``; returns the
        applied Incremental (also appended to ``self.incrementals``)
        or None."""
        from ..crush.incremental import Incremental, apply_incremental, \
            get_epoch
        self.steps += 1
        if self.stages is not None and stage not in self.stages:
            return None
        if self.max_events is not None and \
                len(self.events) >= self.max_events:
            return None
        if self.fire_every is not None:
            if self.steps % self.fire_every != 0:
                return None
        elif float(self._rng.random()) >= self.p_fire:
            return None
        ev = self._draw_event(osdmap)
        if ev is None:
            return None
        kind, payload = ev
        inc = Incremental(epoch=get_epoch(osdmap) + 1, **payload)
        apply_incremental(osdmap, inc)
        self.events.append({"kind": kind, "stage": stage,
                            "epoch": inc.epoch,
                            "detail": self._detail(kind, payload)})
        self.incrementals.append(inc)
        from ..telemetry import metrics as tel
        tel.counter("chaos_injections", kind=f"churn_{kind}")
        return inc

    @staticmethod
    def _detail(kind: str, payload: dict) -> str:
        if kind == "reweight":
            (osd, w), = payload["new_weight"].items()
            return f"osd.{osd} weight={w:#x}"
        osd = next(iter(payload["new_state"]))
        return f"osd.{osd}"

    # probe budget above scan_limit: on a map where even 1% of OSDs
    # are live, 64 uniform draws miss them all with p < 1e-28 — the
    # counted full-scan fallback is for pathological maps only
    _PROBE_TRIES = 64

    def _pick_live_probe(self, osdmap, avoid) -> Optional[int]:
        for _ in range(self._PROBE_TRIES):
            o = int(self._rng.integers(0, osdmap.max_osd))
            if osdmap.is_up(o) and not osdmap.is_out(o) \
                    and o not in avoid:
                return o
        self.scan_fallbacks += 1
        live = [o for o in range(osdmap.max_osd)
                if osdmap.is_up(o) and not osdmap.is_out(o)
                and o not in avoid]
        if not live:
            return None
        return int(live[int(self._rng.integers(0, len(live)))])

    def _draw_event_probe(self, osdmap):
        """Wide-map event draw: same event kinds, victim picked by
        seeded probes instead of materializing the live set."""
        from ..crush.incremental import CEPH_OSD_UP
        from ..crush.osdmap import IN_WEIGHT
        avoid = set(int(o) for o in self.avoid_osds)
        kinds = []
        if self.downed:
            kinds.append("revive")
        if len(self.downed) < self.max_down:
            kinds.append("down")
        kinds.append("reweight")
        kind = kinds[int(self._rng.integers(0, len(kinds)))]
        if kind == "revive":
            osd = self.downed.pop(
                int(self._rng.integers(0, len(self.downed))))
            return "revive", {"new_state": {osd: CEPH_OSD_UP},
                              "new_weight": {osd: IN_WEIGHT}}
        osd = self._pick_live_probe(osdmap, avoid)
        if osd is None:
            return None
        if kind == "down":
            self.downed.append(osd)
            return "down", {"new_state": {osd: CEPH_OSD_UP},
                            "new_weight": {osd: 0}}
        w = int(self._rng.integers(IN_WEIGHT // 2, IN_WEIGHT + 1))
        return "reweight", {"new_weight": {osd: w}}

    def _draw_event(self, osdmap):
        from ..crush.incremental import CEPH_OSD_UP
        from ..crush.osdmap import IN_WEIGHT
        if osdmap.max_osd > self.scan_limit:
            return self._draw_event_probe(osdmap)
        avoid = set(int(o) for o in self.avoid_osds)
        live = [o for o in range(osdmap.max_osd)
                if osdmap.is_up(o) and not osdmap.is_out(o)
                and o not in avoid]
        kinds = []
        if self.downed:
            kinds.append("revive")
        if len(self.downed) < self.max_down and live:
            kinds.append("down")
        if live:
            kinds.append("reweight")
        if not kinds:
            return None
        kind = kinds[int(self._rng.integers(0, len(kinds)))]
        if kind == "down":
            osd = int(live[int(self._rng.integers(0, len(live)))])
            self.downed.append(osd)
            # xor UP marks the (up) osd down; weight 0 marks it out
            return "down", {"new_state": {osd: CEPH_OSD_UP},
                            "new_weight": {osd: 0}}
        if kind == "revive":
            osd = self.downed.pop(
                int(self._rng.integers(0, len(self.downed))))
            return "revive", {"new_state": {osd: CEPH_OSD_UP},
                              "new_weight": {osd: IN_WEIGHT}}
        osd = int(live[int(self._rng.integers(0, len(live)))])
        w = int(self._rng.integers(IN_WEIGHT // 2, IN_WEIGHT + 1))
        return "reweight", {"new_weight": {osd: w}}


@dataclass
class Straggler:
    """Seeded per-shard service-rate adversary (the
    rateless-recovery torture axis): shard ``s`` completes one unit of
    decode work of size ``work`` in ``base * work * factor(s) *
    (1 + jitter)`` seconds, where ``factor`` is 1.0 except for the
    shards named in ``slow`` (the canonical scenario: one shard 10×
    slower, ``slow={0: 10.0}``) and the jitter draw is a pure function
    of (seed, shard, unit) — so any (seed, scenario) pair replays the
    whole completion schedule byte-identically, like every other
    adversary in this module.  No wall clock, no threads: the rateless
    planner (cluster/rateless.py) consumes these times in a
    deterministic discrete-event schedule."""

    seed: int = 0
    slow: Dict[int, float] = field(default_factory=dict)
    jitter: float = 0.05
    base: float = 1.0      # seconds per unit of work at factor 1.0

    def factor(self, shard: int) -> float:
        return float(self.slow.get(int(shard), 1.0))

    def service_time(self, shard: int, unit: int,
                     work: float = 1.0) -> float:
        rng = np.random.default_rng((self.seed, int(shard), int(unit)))
        j = 1.0 + self.jitter * float(rng.random())
        return self.base * float(work) * self.factor(shard) * j


__all__ = ["CRASH_SITES", "CrashPoint", "InjectedCrash", "MapChurn",
           "Straggler"]
