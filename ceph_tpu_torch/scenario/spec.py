"""Declarative "production day" scenarios — one spec, one replayable run;
a copy of ``ceph_tpu/scenario/spec.py`` (its JSON is the reference's:
each package's ``from_json`` reads the other's ``to_json``).

A :class:`ScenarioSpec` names everything a production-shape day needs
in one JSON-round-trippable value:

- a **cluster** (:class:`~ceph_tpu_torch.cluster.topology.ClusterSpec` —
  the seeded synthetic topology the recovery pg places into),
- client **traffic** (:class:`~ceph_tpu_torch.serve.loadgen.TrafficSpec` —
  the seeded request stream with per-op deadlines, i.e. the SLO),
- a timed **chaos schedule** (:class:`ChaosSchedule` — churn-storm
  budget and cadence, the straggler, and the shard damage that seeds
  recovery work),
- **QoS tags** (:class:`QosSpec` — per-class mClock
  reservation/weight/limit vectors plus the burn-rate feedback knobs
  the arbiter closes the SLO loop with, scenario/qos.py).

``run_scenario`` (scenario/runner.py) stands the whole thing up from
the spec and interleaves it on ONE injectable clock, so a FakeClock
run replays byte-identically from ``seed`` — the same contract every
chaos artifact in this repo carries, now for the full composed system.

Everything here is a pure value: building a spec never touches a device,
never builds a cluster, never touches a clock.  ``to_json``/
``from_json`` round-trip exactly,
so a scenario JSON checked into a bug report IS the reproducer.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, Optional, Tuple

from ..cluster.topology import ClusterSpec
from ..serve.loadgen import CodecSpec, TrafficSpec

# the background work classes the QoS arbiter schedules against the
# foreground ``client`` class (scenario/qos.py)
QOS_CLASSES = ("client", "recovery", "scrub", "rebalance")


@dataclass(frozen=True)
class ChaosSchedule:
    """The timed adversary half of a scenario (all seeds derive from
    the ScenarioSpec seed, so the schedule alone carries no RNG
    state)."""

    # churn storm: MapChurn event budget, fired every Nth runner turn
    # once the scenario clock passes ``storm_at_s``; leftover downed
    # osds are drained (revived) after the stream ends, exactly like
    # cluster/storms.py, so recovery can always converge
    storm_events: int = 6
    storm_at_s: float = 0.0
    storm_every_turns: int = 8
    max_down: int = 2
    # rateless-recovery straggler (chaos.Straggler): one mesh shard
    # ``straggler_factor`` x slower
    straggler_shard: int = 0
    straggler_factor: float = 10.0
    # the damage that seeds recovery work: shards erased/corrupted per
    # damaged object
    damaged_objects: int = 4
    erasures: int = 1
    corruptions: int = 0
    # background scrub verify ticks over the healthy objects, one per
    # admitted turn, up to this budget
    scrub_ticks: int = 8
    # device-plane events (chaos/dispatch.py + the
    # supervised dispatch plane ops/supervisor.py): lose the backend
    # mid-stream.  ``dispatch_fault`` arms one seeded DispatchFault
    # (transient|oom|backend_loss|hang|corrupt) against
    # ``dispatch_fault_seam`` starting at that seam's
    # ``dispatch_fault_at``-th call; it stays active for
    # ``dispatch_fault_calls`` calls (None = until the runner heals
    # the plan after the client stream drains).  None = no
    # device-plane chaos (every older scenario JSON).
    dispatch_fault: Optional[str] = None
    dispatch_fault_seam: str = "engine.fused_repair"
    dispatch_fault_at: int = 2
    dispatch_fault_calls: Optional[int] = 4
    # host fault domains (chaos/hosts.py): lose a whole host
    # mid-stream.  ``host_loss`` arms one seeded HostFault
    # (host_loss|host_flap|host_partition) against ``host_loss_host``
    # at ``host_loss_seam``'s ``host_loss_at``-th call, active for
    # ``host_loss_calls`` calls (None = until the runner heals the
    # plan after the stream drains).  The runner activates a simulated
    # ``host_loss_hosts``-domain plane for the run when armed.  None =
    # no host-plane chaos (every older scenario JSON).
    host_loss: Optional[str] = None
    host_loss_host: int = 1
    host_loss_hosts: int = 2
    host_loss_seam: str = "engine.fused_repair"
    host_loss_at: int = 2
    host_loss_calls: Optional[int] = 4

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosSchedule":
        return cls(**d)


@dataclass(frozen=True)
class TenantSpec:
    """One tenant in a multi-tenant scenario: its own
    seeded traffic stream, per-op deadlines (the SloPolicy rides the
    TrafficSpec), mClock client tags, and an optional causal-trace
    sampling rate (telemetry/tracing.py per-tenant affordability).

    ``reservation``/``limit`` are ops/s (0 = none); ``weight`` is the
    proportional share.  The limit is THE isolation contract: a
    tenant bursting past it is rejected at the door (counted against
    its own scorecard), never served at its neighbors' expense."""

    name: str
    traffic: TrafficSpec
    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0
    trace_sample: float = 1.0

    def to_dict(self) -> dict:
        return {"name": self.name, "traffic": self.traffic.to_dict(),
                "reservation": self.reservation, "weight": self.weight,
                "limit": self.limit, "trace_sample": self.trace_sample}

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        return cls(name=d["name"],
                   traffic=TrafficSpec.from_dict(d["traffic"]),
                   reservation=d.get("reservation", 0.0),
                   weight=d.get("weight", 1.0),
                   limit=d.get("limit", 0.0),
                   trace_sample=d.get("trace_sample", 1.0))


# disaster-stage catalogue: what each kind does at
# fire time and undoes at heal time (scenario/week.py runs the
# arm -> fire -> heal machine with a flight-recorder dump per stage)
DISASTER_KINDS = ("rack_loss", "host_loss", "backend_loss",
                  "tenant_burst")


@dataclass(frozen=True)
class DisasterStage:
    """One staged correlated disaster on the week timeline.

    ``at_s`` is the fire time on the scenario clock (stream-relative),
    ``duration_s`` the fire->heal window, ``arm_lead_s`` how far ahead
    the stage arms (the flight recorder notes the arm so the dump
    brackets the whole incident).  Kind-specific knobs: ``rack`` /
    ``host`` pick the blast radius for the loss kinds, ``tenant`` +
    ``factor`` shape the burst storm, ``objects`` is how many
    recovery objects the loss damages."""

    kind: str
    at_s: float
    duration_s: float = 1.0
    arm_lead_s: float = 0.5
    rack: int = 0
    host: int = 0
    tenant: str = ""
    factor: float = 8.0
    objects: int = 2
    # the supervised seam backend_loss faults ride: the week runner
    # dispatches its heal-phase recovery rounds through this seam, so
    # the injected faults and the retry ladder that survives them are
    # both on the record (ops/supervisor.py counters)
    seam: str = "week.recovery"

    def __post_init__(self) -> None:
        if self.kind not in DISASTER_KINDS:
            raise ValueError(f"disaster kind {self.kind!r} not in "
                             f"{DISASTER_KINDS}")
        if self.duration_s <= 0:
            raise ValueError(f"duration_s {self.duration_s} must be "
                             f"> 0")

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DisasterStage":
        return cls(**d)


@dataclass(frozen=True)
class DisasterSchedule:
    """The week's correlated-disaster timeline: existing adversary
    planes (map churn downs, host loss, device-plane backend loss,
    tenant burst storms) composed as arm/fire/heal stages on ONE
    clock.  A pure value like every other spec half."""

    stages: Tuple[DisasterStage, ...] = ()

    def to_dict(self) -> dict:
        return {"stages": [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, d: dict) -> "DisasterSchedule":
        return cls(stages=tuple(DisasterStage.from_dict(s)
                                for s in d.get("stages", ())))


@dataclass(frozen=True)
class QosSpec:
    """mClock-style per-class tags + the SLO feedback knobs.

    ``reservation``/``limit`` are ops/s (0 = none); ``weight`` is the
    proportional share, granted at ``weight_rate`` ops/s per weight
    unit while the client SLO is healthy.  ``miss_budget`` is the
    tolerated client deadline-miss rate over a rolling ``window``;
    as the measured rate climbs toward ``burn`` x budget the arbiter
    scales background weight/limit down to ``floor`` (reservations
    are never scaled — a background class is throttled, not starved).
    """

    enabled: bool = True
    reservation: Dict[str, float] = field(default_factory=lambda: {
        "recovery": 4.0, "scrub": 1.0, "rebalance": 2.0})
    weight: Dict[str, float] = field(default_factory=lambda: {
        "client": 8.0, "recovery": 4.0, "scrub": 1.0, "rebalance": 2.0})
    limit: Dict[str, float] = field(default_factory=lambda: {
        "recovery": 200.0, "scrub": 50.0, "rebalance": 100.0})
    weight_rate: float = 40.0
    miss_budget: float = 0.02
    burn: float = 4.0
    window: int = 32
    floor: float = 0.05

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QosSpec":
        return cls(enabled=d["enabled"],
                   reservation=dict(d["reservation"]),
                   weight=dict(d["weight"]),
                   limit=dict(d["limit"]),
                   weight_rate=d["weight_rate"],
                   miss_budget=d["miss_budget"], burn=d["burn"],
                   window=d["window"], floor=d["floor"])


@dataclass(frozen=True)
class ScenarioSpec:
    """One declarative, seeded, byte-identically replayable scenario."""

    name: str = "production-day"
    seed: int = 42
    cluster: ClusterSpec = field(default_factory=ClusterSpec)
    traffic: TrafficSpec = None  # required; validated below
    chaos: ChaosSchedule = field(default_factory=ChaosSchedule)
    qos: QosSpec = field(default_factory=QosSpec)
    # the codec recovery heals with (None = traffic.codecs[0]); its
    # chunk count must match the cluster's EC pool width so every
    # erased shard has a placement slot
    recovery_codec: Optional[CodecSpec] = None
    recovery_stripe: int = 1 << 12
    recovery_ps: int = 5
    # sim-mode service models (FakeClock runs): modeled device
    # bandwidth for serving dispatches and per-recovery-round /
    # per-scrub-tick / per-churn-step costs in seconds — the shared
    # "device seconds" foreground and background contend for
    service_gbps: float = 10.0
    recovery_round_s: float = 0.008
    scrub_tick_s: float = 0.002
    churn_step_s: float = 0.004
    max_recovery_rounds: int = 200
    # multi-tenant week (scenario/week.py): the tenant
    # roster and the staged-disaster timeline.  Empty = every
    # older scenario JSON (run_scenario ignores both).
    tenants: Tuple[TenantSpec, ...] = ()
    disasters: DisasterSchedule = field(
        default_factory=DisasterSchedule)
    # the week's timeline cadences: background scrub ticks and churn
    # epochs fire at these sim-second intervals (0 = never)
    week_scrub_every_s: float = 0.0
    week_churn_every_s: float = 0.0
    # sim dispatch overhead (seconds) for the week's service model —
    # with service_gbps it fixes the modeled serving capacity the
    # tenants contend for
    service_overhead_s: float = 2e-4

    def __post_init__(self) -> None:
        if self.traffic is None:
            raise ValueError("ScenarioSpec needs a TrafficSpec")
        ec = self.codec_for_recovery()
        n = self._codec_width(ec)
        pool_n = self.cluster.ec_k + self.cluster.ec_m
        if not self.cluster.ec_pg_num:
            raise ValueError("scenario cluster needs an EC pool "
                             "(ec_pg_num > 0) for the recovery pg")
        if pool_n < n:
            raise ValueError(
                f"recovery codec {ec.name} needs {n} placement slots "
                f"but the cluster EC pool is size {pool_n}")

    def codec_for_recovery(self) -> CodecSpec:
        return self.recovery_codec or self.traffic.codecs[0]

    @staticmethod
    def _codec_width(codec: CodecSpec) -> int:
        # k+m from the profile without instantiating the plugin (the
        # spec is a pure value; lrc's l adds locals, counted via k+m
        # only for the slot check, which the runner re-validates live)
        p = codec.profile
        return int(p.get("k", 0)) + int(p.get("m", 0))

    # -- JSON round trip -------------------------------------------------

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "seed": self.seed,
            "cluster": asdict(self.cluster),
            "traffic": self.traffic.to_dict(),
            "chaos": self.chaos.to_dict(),
            "qos": self.qos.to_dict(),
            "recovery_codec": (self.recovery_codec.to_dict()
                               if self.recovery_codec else None),
            "recovery_stripe": self.recovery_stripe,
            "recovery_ps": self.recovery_ps,
            "service_gbps": self.service_gbps,
            "recovery_round_s": self.recovery_round_s,
            "scrub_tick_s": self.scrub_tick_s,
            "churn_step_s": self.churn_step_s,
            "max_recovery_rounds": self.max_recovery_rounds,
        }
        if self.tenants:
            # week-only keys appear only on week specs, so every
            # older spec JSON round-trips byte-identically
            out["tenants"] = [t.to_dict() for t in self.tenants]
            out["disasters"] = self.disasters.to_dict()
            out["week_scrub_every_s"] = self.week_scrub_every_s
            out["week_churn_every_s"] = self.week_churn_every_s
            out["service_overhead_s"] = self.service_overhead_s
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        cl = dict(d["cluster"])
        cl["weight_tiers"] = tuple(cl["weight_tiers"])
        cl["device_classes"] = tuple(cl["device_classes"])
        rc = d.get("recovery_codec")
        return cls(
            name=d["name"], seed=d["seed"],
            cluster=ClusterSpec(**cl),
            traffic=TrafficSpec.from_dict(d["traffic"]),
            chaos=ChaosSchedule.from_dict(d["chaos"]),
            qos=QosSpec.from_dict(d["qos"]),
            recovery_codec=CodecSpec.from_dict(rc) if rc else None,
            recovery_stripe=d["recovery_stripe"],
            recovery_ps=d["recovery_ps"],
            service_gbps=d["service_gbps"],
            recovery_round_s=d["recovery_round_s"],
            scrub_tick_s=d["scrub_tick_s"],
            churn_step_s=d["churn_step_s"],
            max_recovery_rounds=d["max_recovery_rounds"],
            tenants=tuple(TenantSpec.from_dict(t)
                          for t in d.get("tenants", ())),
            disasters=DisasterSchedule.from_dict(
                d.get("disasters", {})),
            week_scrub_every_s=d.get("week_scrub_every_s", 0.0),
            week_churn_every_s=d.get("week_churn_every_s", 0.0),
            service_overhead_s=d.get("service_overhead_s", 2e-4),
        )

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))

    def with_qos(self, **kw) -> "ScenarioSpec":
        """A copy with QoS knobs replaced (``with_qos(enabled=False)``
        is the arbiter-off control every contention claim compares
        against)."""
        return replace(self, qos=replace(self.qos, **kw))


def default_scenario(seed: int = 42, n_requests: int = 128,
                     stripe_size: int = 1 << 14,
                     damaged_objects: int = 4, erasures: int = 1,
                     storm_events: int = 6,
                     straggler_factor: float = 10.0,
                     **overrides) -> ScenarioSpec:
    """The canonical contention day: the mixed rs/shec/clay client
    stream at TIGHT deadlines while a churn storm forces remaps and
    rateless recovery heals straggler-skewed damage — the pinned tier-1
    scenario, the demo default, and the bench ``--workload scenario``
    row all run this shape.

    Deadlines are deliberately tight against the sim service model
    (``service_gbps``/``recovery_round_s``): contention must COST
    something, or arbiter-on vs arbiter-off proves nothing.
    """
    codecs = [
        CodecSpec("rs_k4_m2", "jerasure",
                  {"technique": "reed_sol_van", "k": "4", "m": "2"},
                  stripe_size, weight=3.0),
        CodecSpec("shec_k4_m3_c2", "shec",
                  {"k": "4", "m": "3", "c": "2"}, stripe_size,
                  weight=2.0),
        CodecSpec("clay_k4_m2_d5", "clay",
                  {"k": "4", "m": "2", "d": "5"}, stripe_size,
                  weight=1.0),
    ]
    # client decode/repair requests always carry a single erasure (a
    # decodable pattern for every codec in the mix); ``erasures`` is
    # the CHAOS knob — how many shards each damaged object loses,
    # i.e. the recovery difficulty (past the code's budget ⇒ the
    # structured-unrecoverable rc-2 path)
    traffic = TrafficSpec(
        seed=seed, n_requests=n_requests, codecs=codecs,
        arrival="closed", erasures=1, concurrency=16,
        ladder=(1, 2, 4, 8),
        deadlines={"encode": 0.006, "decode": 0.006, "repair": 0.015})
    cluster = ClusterSpec(seed=seed, racks=4, hosts_per_rack=3,
                          osds_per_host=2, replicated_pg_num=32,
                          ec_pg_num=16, ec_k=4, ec_m=2)
    chaos = ChaosSchedule(storm_events=storm_events,
                          damaged_objects=damaged_objects,
                          erasures=erasures,
                          straggler_factor=straggler_factor)
    return ScenarioSpec(seed=seed, cluster=cluster, traffic=traffic,
                        chaos=chaos, **overrides)


def tenant_week_scenario(seed: int = 42, days: int = 7,
                         day_s: float = 40.0,
                         peak_rates: Tuple[float, float, float] = (
                             260.0, 200.0, 140.0),
                         burst_factor: float = 12.0,
                         diurnal_min_frac: float = 0.1,
                         noisy_limit_factor: float = 2.0,
                         **overrides) -> ScenarioSpec:
    """The pinned multi-tenant compressed week: three tenants with
    diurnal arrival curves (10x trough-to-peak swing by default) share
    one serving plane for ``days`` compressed days of ``day_s`` sim
    seconds each, while the disaster schedule lands a rack loss at a
    traffic peak, a backend-seam loss mid-rebalance, a host loss at
    the next peak, and a noisy-neighbor burst storm.

    Tenant QoS shape: ``alpha``/``bravo`` are the victims — reserved
    and uncapped — while ``noisy`` carries a limit tag at
    ``noisy_limit_factor`` times its base peak rate, so its
    ``burst_factor`` storm is clamped at the door when the arbiter is
    on and saturates the shared service clock when it is off (the
    isolation gate's control arm).

    Request counts are derived, not chosen: each stream's
    ``n_requests`` is the integral of its diurnal rate over the week
    (plus the burst window's extra arrivals for ``noisy``), so the
    stream spans the full week at any scale — the tier-1 test runs a
    2-day miniature and the demo runs the full ~1e5-request week from
    the SAME factory.
    """
    week_s = float(days) * day_s
    mean_frac = diurnal_min_frac + (1.0 - diurnal_min_frac) * 0.5

    def _frac(t: float) -> float:
        # the diurnal multiplier at sim-time t (loadgen.diurnal_rate)
        return diurnal_min_frac + (1.0 - diurnal_min_frac) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / day_s))

    deadlines = {"encode": 0.06, "decode": 0.06, "repair": 0.12}
    # stage times are WEEK fractions (day-1.5/2.8/3.5/4.4 of a 7-day
    # week), not absolute day multiples — a 2-day miniature must land
    # every disaster inside its compressed week, or the burst storm
    # plays out after the victim streams already drained
    burst_at = (4.4 / 7.0) * week_s
    burst_dur = 0.3 * day_s
    stages = (
        DisasterStage(kind="rack_loss", at_s=(1.5 / 7.0) * week_s,
                      duration_s=0.2 * day_s, arm_lead_s=0.05 * day_s,
                      rack=1, objects=3),
        DisasterStage(kind="backend_loss", at_s=(2.8 / 7.0) * week_s,
                      duration_s=0.1 * day_s, arm_lead_s=0.05 * day_s,
                      objects=2, seam="week.recovery"),
        DisasterStage(kind="host_loss", at_s=(3.5 / 7.0) * week_s,
                      duration_s=0.15 * day_s, arm_lead_s=0.05 * day_s,
                      host=4, objects=2),
        DisasterStage(kind="tenant_burst", at_s=burst_at,
                      duration_s=burst_dur, arm_lead_s=0.05 * day_s,
                      tenant="noisy", factor=burst_factor),
    )

    def _stream(name: str, idx: int, rate: float, stripe: int,
                extra: int = 0) -> TrafficSpec:
        n = int(rate * mean_frac * week_s) + extra
        return TrafficSpec(
            seed=seed + 11 * (idx + 1), n_requests=n,
            codecs=[CodecSpec(
                f"rs_k4_m2_{name}", "jerasure",
                {"technique": "reed_sol_van", "k": "4", "m": "2"},
                stripe)],
            op_mix={"encode": 0.7, "decode": 0.25, "repair": 0.05},
            deadlines=dict(deadlines), arrival="open", rate=rate,
            erasures=1, ladder=(1, 2, 4, 8),
            queue_capacity=1 << 16, pool=8, tenant=name,
            diurnal_period_s=day_s,
            diurnal_min_frac=diurnal_min_frac)

    r_alpha, r_bravo, r_noisy = (float(r) for r in peak_rates)
    # the burst window's extra arrivals: rate * diurnal(t_mid) *
    # (factor - 1) * duration, so the noisy stream still spans the
    # whole week instead of exhausting early
    extra = int(r_noisy * _frac(burst_at + 0.5 * burst_dur)
                * (burst_factor - 1.0) * burst_dur)
    tenants = (
        TenantSpec(name="alpha",
                   traffic=_stream("alpha", 0, r_alpha, 1 << 14),
                   reservation=0.25 * r_alpha, weight=4.0, limit=0.0,
                   trace_sample=0.05),
        TenantSpec(name="bravo",
                   traffic=_stream("bravo", 1, r_bravo, 1 << 13),
                   reservation=0.25 * r_bravo, weight=3.0, limit=0.0,
                   trace_sample=0.02),
        TenantSpec(name="noisy",
                   traffic=_stream("noisy", 2, r_noisy, 1 << 15,
                                   extra=extra),
                   reservation=0.1 * r_noisy, weight=1.0,
                   limit=noisy_limit_factor * r_noisy,
                   trace_sample=0.005),
    )
    cluster = ClusterSpec(seed=seed, racks=4, hosts_per_rack=3,
                          osds_per_host=2, replicated_pg_num=32,
                          ec_pg_num=16, ec_k=4, ec_m=2)
    defaults = dict(
        seed=seed, cluster=cluster, traffic=tenants[0].traffic,
        tenants=tenants, disasters=DisasterSchedule(stages=stages),
        week_scrub_every_s=day_s / 8.0,
        week_churn_every_s=day_s / 5.0,
        service_gbps=0.5, service_overhead_s=4e-3)
    defaults.update(overrides)
    return ScenarioSpec(**defaults)


__all__ = ["QOS_CLASSES", "ChaosSchedule", "DisasterSchedule",
           "DisasterStage", "DISASTER_KINDS", "QosSpec",
           "ScenarioSpec", "TenantSpec", "default_scenario",
           "tenant_week_scenario"]
