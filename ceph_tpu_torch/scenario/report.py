"""ScenarioReport — one deterministic JSON artifact per scenario run; a
copy of ``ceph_tpu/scenario/report.py``, whose JSON it equals.

Joins every plane's accounting for one composed run: the serving SLO
scorecard (serve/sla.py report), the recovery orchestrator's full
counter set (replans/fences/journal — the correctness ledger), the
rateless straggler schedule (p99 vs the no-straggler baseline — the
arXiv 1804.10331 claim), the churn summary, the QoS arbiter snapshot
(grants/denials/scale — the contention ledger), and optionally the
device-plane profiler's attribution rows.

``to_json()`` is the replay witness: sorted keys, every derived float
rounded at the source, no wall-clock or process-global state — two
FakeClock runs of one seed serialize byte-identically.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ScenarioReport:
    """The whole production day, one JSON-stable value."""

    name: str = "scenario"
    seed: int = 0
    executor: str = "host"
    arbiter_enabled: bool = True
    elapsed_s: float = 0.0
    turns: int = 0
    recovery_rounds: int = 0
    scrub_ticks: int = 0
    slo: dict = field(default_factory=dict)
    recovery: dict = field(default_factory=dict)
    rateless: dict = field(default_factory=dict)
    churn: dict = field(default_factory=dict)
    qos: dict = field(default_factory=dict)
    slo_burn_trips: int = 0
    gates: dict = field(default_factory=dict)
    profile: Optional[List[dict]] = None
    # supervised dispatch plane (ops/supervisor.py): the run's
    # supervisor-counter delta (retries/demotions/quarantines/
    # re-promotions) + the chaos plan summary when the ScenarioSpec
    # armed device-plane faults; None when the spec armed none
    supervisor: Optional[dict] = None
    # host fault domains (chaos/hosts.py + the host-aware
    # plane): the armed host-fault plan summary, the host-granular
    # supervisor counter delta (host_quarantines/host_repromotions/
    # journal_redispatches) and the plane topology before/after; None
    # when the spec armed no host-plane chaos
    host_plane: Optional[dict] = None
    # multi-tenant week (scenario/week.py): per-tenant SLO
    # scorecards keyed by tenant name, and the staged-disaster
    # timeline (one entry per DisasterStage with arm/fire/heal times
    # + per-stage gates); None outside week runs so every pre-week
    # report JSON stays byte-identical
    tenants: Optional[dict] = None
    disasters: Optional[List[dict]] = None

    # -- convenience accessors (the contention axes) ---------------------

    @property
    def p99_ms(self) -> Optional[float]:
        return self.slo.get("p99_ms")

    @property
    def deadline_miss_rate(self) -> Optional[float]:
        return self.slo.get("deadline_miss_rate")

    @property
    def gbps_under_slo(self) -> Optional[float]:
        return self.slo.get("gbps_under_slo")

    def ok(self) -> bool:
        """Every correctness gate held (the SLO axes are measurements,
        not gates — a missed deadline is a result, lost data is not)."""
        g = self.gates
        return bool(g.get("converged") and g.get("healed")
                    and g.get("verified_requests"))

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "seed": self.seed,
            "executor": self.executor,
            "arbiter_enabled": self.arbiter_enabled,
            "elapsed_s": self.elapsed_s,
            "turns": self.turns,
            "recovery_rounds": self.recovery_rounds,
            "scrub_ticks": self.scrub_ticks,
            "slo": self.slo,
            "recovery": self.recovery,
            "rateless": self.rateless,
            "churn": self.churn,
            "qos": self.qos,
            "slo_burn_trips": self.slo_burn_trips,
            "gates": self.gates,
        }
        if self.profile is not None:
            out["profile"] = self.profile
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor
        if self.host_plane is not None:
            out["host_plane"] = self.host_plane
        if self.tenants is not None:
            out["tenants"] = self.tenants
        if self.disasters is not None:
            out["disasters"] = self.disasters
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


__all__ = ["ScenarioReport"]
