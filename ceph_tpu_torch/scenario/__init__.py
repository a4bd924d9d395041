"""ceph_tpu_torch.scenario — the "production day" composition layer; a
port of ``ceph_tpu/scenario/``.

The planes below this package each have their own loop; this
package runs them *against each other* the way production would —
client traffic at SLO while a churn storm forces remaps and rateless
recovery heals stragglers:

- ``spec``   — :class:`ScenarioSpec`: ClusterSpec + TrafficSpec + a
               timed chaos schedule + QoS tags, JSON round-trippable
               (with the reference's JSON too), seeded so a FakeClock
               run replays byte-identically.
- ``qos``    — :class:`MClockArbiter`: mClock-style
               reservation/weight/limit arbitration between the
               client class and recovery/scrub/rebalance, scaled
               live by the client deadline-miss burn rate (the loop
               from serve/sla.py's monitor to recovery/throttle.py's
               per-OSD weighted limits).
- ``runner`` — the single event loop: the serving loop, the storm
               loop, shared store staging, and :func:`run_scenario`
               composing all of it on one injectable clock.
- ``week``   — :func:`run_tenant_week`: the multi-tenant compressed
               week, a discrete-event run with per-tenant mClock at the
               door and staged disasters.
- ``report`` — :class:`ScenarioReport`: one deterministic JSON
               artifact joining the SLO scorecard, recovery/churn
               counters, the rateless schedule, and the QoS ledger.

``run_scenario`` and ``run_tenant_week`` run on the card unless the
caller asks for the CPU (``device="cpu"``) or the host tier
(``executor="host"``).  The bench CLI's ``--workload scenario`` and
``--workload tenant-week`` drive them.
"""

from .qos import MClockArbiter, qos_selftest  # noqa: F401
from .report import ScenarioReport  # noqa: F401
from .runner import (  # noqa: F401
    ScenarioRun,
    drain_churn,
    drive_storm,
    run_scenario,
    run_serving_scenario,
    scenario_selftest,
    stage_damaged_objects,
)
from .spec import (  # noqa: F401
    DISASTER_KINDS,
    QOS_CLASSES,
    ChaosSchedule,
    DisasterSchedule,
    DisasterStage,
    QosSpec,
    ScenarioSpec,
    TenantSpec,
    default_scenario,
    tenant_week_scenario,
)
from .week import (  # noqa: F401
    TenantWeekRun,
    isolated_baseline,
    isolation_gate,
    run_tenant_week,
    week_selftest,
    week_service_model,
)

__all__ = [
    "ChaosSchedule", "DISASTER_KINDS", "DisasterSchedule",
    "DisasterStage", "MClockArbiter", "QOS_CLASSES", "QosSpec",
    "ScenarioReport", "ScenarioRun", "ScenarioSpec", "TenantSpec",
    "TenantWeekRun", "default_scenario", "drain_churn", "drive_storm",
    "isolated_baseline", "isolation_gate", "qos_selftest",
    "run_scenario", "run_serving_scenario", "run_tenant_week",
    "scenario_selftest", "stage_damaged_objects",
    "tenant_week_scenario", "week_selftest", "week_service_model",
]
