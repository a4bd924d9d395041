"""The replay-domain registry — the declarative half of the ``det``
tier (docs/LINT.md "Determinism tier").

Mirrors entrypoints.py / lockmodel.py: the intended replay-safety
discipline is *written down* here and drift fails loudly.  Every
byte-identity gate the repo carries — event ≡ step clock equivalence,
batched ≡ per-request across the plugin families, byte-identical
flight dumps and heal, and ROADMAP item 4's trace-driven what-if
replay — rests on one property: given a seed and an injected clock,
the replay-critical planes consult *nothing* the replay cannot
reproduce.  This module declares which modules carry that obligation
and which are legitimately wall-clock, and names every sanctioned
seam through which real time, RNG state or the process environment
may enter:

- :data:`DOMAINS` — dotted module prefixes classified ``replay``
  (the static det-* rules apply in full) or ``wallclock`` (real
  timers ARE the product: benches, the perf counters, the lockcheck
  monitor).  Unlisted modules default to **replay** — a new module
  is born with the obligation and must be declared out, never
  silently exempted.
- :data:`CLOCK_SEAMS` — the classes/functions allowed to touch
  ``time.*`` directly inside a replay domain: the ``SystemClock``
  family itself, i.e. the single gateway everything else must route
  through.
- :data:`CLOCK_FALLBACKS` — every registered *default wall-clock
  fallback*: a ``clock=None`` parameter that falls back to the system
  clock through ``utils.detcheck.default_clock(id, factory)``.  The
  static pass cross-checks the literal id both ways (an unknown or
  drifting id, or a registered id with no surviving site, is a
  ``det-clock-leak``), and the runtime half (``CEPH_TPU_DETCHECK=1``)
  wraps exactly these seams so a wall-clock consultation while an
  injected clock is installed is counted and flight-recorded.
- :data:`ENV_SEAMS` — the functions allowed to consult
  ``os.environ`` at call time inside a replay domain (the config
  seams: each names the knobs it owns).  Everywhere else, env state
  must be read at a config seam or at import time, so a replayed run
  cannot fork on ambient process state mid-flight.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Tuple

REPLAYMODEL_SCHEMA_VERSION = 1

# unlisted modules carry the replay obligation by default: exemption
# is a declaration, never an accident
DEFAULT_KIND = "replay"


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """One declared domain: a dotted module prefix and its kind."""

    prefix: str    # dotted module prefix relative to ceph_tpu_torch
    kind: str      # "replay" | "wallclock"
    why: str       # one line: why this classification


DOMAINS: Tuple[DomainSpec, ...] = (
    # -- replay-critical planes (declared for the record; this is
    #    also the default for anything unlisted) ----------------------
    DomainSpec("scenario", "replay",
               "seeded production days/weeks: byte-identical reruns "
               "are the pinned contract"),
    DomainSpec("serve", "replay",
               "admission/batching/SLO ledger: dispatch_crc and "
               "batched==per-request identity gates"),
    DomainSpec("recovery", "replay",
               "repair orchestration: byte-identical heal is pinned"),
    DomainSpec("chaos", "replay",
               "seeded fault injection: a chaos schedule must replay "
               "exactly"),
    DomainSpec("cluster", "replay",
               "maps, churn storms, rateless planning: seeded"),
    DomainSpec("telemetry", "replay",
               "dump paths are part of the replay witness: "
               "byte-identical flight dumps from a FakeClock run"),
    DomainSpec("ops", "replay",
               "dispatch supervision rides the scenario clock"),
    DomainSpec("parallel", "replay",
               "mesh topology decisions feed sharded dispatch"),
    DomainSpec("codes", "replay", "codec planes are pure compute"),
    DomainSpec("crush", "replay", "placement must be deterministic"),

    # -- legitimately wall-clock --------------------------------------
    DomainSpec("bench", "wallclock",
               "benchmarks: real timers are the measurement"),
    DomainSpec("crush.tester", "wallclock",
               "mapping validator CLI: timed sweeps over real maps"),
    DomainSpec("utils.perf", "wallclock",
               "perf counters: wall timings are the payload"),
    DomainSpec("utils.locks", "wallclock",
               "lockcheck monitor: measures real held-durations; "
               "active only under CEPH_TPU_LOCKCHECK"),
    DomainSpec("utils.detcheck", "wallclock",
               "the determinism tripwire itself: it wraps the wall "
               "clock to observe it"),
    DomainSpec("tune", "wallclock",
               "autotuner measurement plane: sweeps time real "
               "executions on device"),
    DomainSpec("analysis", "wallclock",
               "static/trace analysis tooling, not the dataplane"),

    # tools: drivers that measure real overhead or wrap benches, by
    # file stem (module_name_for gives the stem outside the package: the
    # repo-root tools/) and as the package's own tools/ modules
    DomainSpec("perf_dump", "wallclock",
               "overhead gate: measures enabled-vs-disabled on real "
               "timers"),
    DomainSpec("roofline", "wallclock", "device measurement driver"),
    DomainSpec("bench_diff", "wallclock", "bench comparison CLI"),
    DomainSpec("bulk_crush_row", "wallclock",
               "bulk-mapping probe: times real device sweeps"),
    DomainSpec("crush_times", "wallclock",
               "rule-kernel probe: times real device sweeps"),
    DomainSpec("sharded_bench", "wallclock",
               "mesh throughput driver: wall timers are the payload"),
    DomainSpec("host_chaos_demo", "wallclock",
               "live-mode host-loss demo: real sleeps pace the fault "
               "timeline on purpose"),
    DomainSpec("tools.perf_dump", "wallclock",
               "overhead gate: measures enabled-vs-disabled on real "
               "timers"),
    DomainSpec("tools.roofline", "wallclock", "device measurement driver"),
    DomainSpec("tools.bench_diff", "wallclock", "bench comparison CLI"),
    DomainSpec("tools.bulk_crush_row", "wallclock",
               "bulk-mapping probe: times real device sweeps"),
    DomainSpec("tools.crush_times", "wallclock",
               "rule-kernel probe: times real device sweeps"),
    DomainSpec("tools.sharded_bench", "wallclock",
               "mesh throughput driver: wall timers are the payload"),
    DomainSpec("tools.host_chaos_demo", "wallclock",
               "live-mode host-loss demo: real sleeps pace the fault "
               "timeline on purpose"),
)


@dataclasses.dataclass(frozen=True)
class ClockSeam:
    """A class/function sanctioned to touch ``time.*`` directly in a
    replay domain — the SystemClock gateways everything routes
    through."""

    module: str    # dotted module (relative to ceph_tpu_torch)
    qual: str      # class name or function qualname within the module
    why: str


CLOCK_SEAMS: Tuple[ClockSeam, ...] = (
    ClockSeam("utils.retry", "SystemClock",
              "THE production clock: the one sanctioned wall-time "
              "gateway"),
    ClockSeam("telemetry.spans", "_SystemClock",
              "span tracer default-clock gateway"),
    ClockSeam("telemetry.metrics", "_SystemClock",
              "metrics registry default-clock gateway"),
    ClockSeam("telemetry.profiler", "_SystemClock",
              "profiler default-clock gateway"),
    ClockSeam("telemetry.recorder", "_SystemClock",
              "flight recorder default-clock gateway"),
)


@dataclasses.dataclass(frozen=True)
class ClockFallback:
    """One registered default wall-clock fallback: the literal id
    passed to ``utils.detcheck.default_clock`` at the creation site."""

    id: str        # "<module>.<Owner-or-function>"
    module: str    # dotted module the site lives in
    why: str       # what defaults to wall time when no clock is given


CLOCK_FALLBACKS: Tuple[ClockFallback, ...] = (
    ClockFallback("telemetry.spans.SpanTracer", "telemetry.spans",
                  "span start/end stamps"),
    ClockFallback("telemetry.metrics.MetricsRegistry",
                  "telemetry.metrics", "timed()/record_dispatch"),
    ClockFallback("telemetry.profiler.ProgramProfiler",
                  "telemetry.profiler", "measured dispatch latencies"),
    ClockFallback("telemetry.recorder.FlightRecorder",
                  "telemetry.recorder", "ring-entry t stamps"),
    ClockFallback("telemetry.tracing.TraceCollector",
                  "telemetry.tracing", "trace segment boundaries"),
    ClockFallback("serve.batcher.ContinuousBatcher", "serve.batcher",
                  "batch deadlines + service estimates"),
    ClockFallback("serve.queue.AdmissionQueue", "serve.queue",
                  "arrival stamps (queue-wait measurement)"),
    ClockFallback("scenario.qos.MClockArbiter", "scenario.qos",
                  "mClock tag arithmetic"),
    ClockFallback("scenario.runner.run_scenario", "scenario.runner",
                  "live-mode scenario driver clock"),
    ClockFallback("scenario.runner.run_serving_scenario",
                  "scenario.runner",
                  "live-mode serving driver clock"),
    ClockFallback("ops.supervisor.DispatchSupervisor",
                  "ops.supervisor", "probe pacing + retry backoff"),
    ClockFallback("recovery.orchestrator.RecoveryOrchestrator",
                  "recovery.orchestrator",
                  "recovery round deadlines"),
    ClockFallback("utils.retry.retry_call", "utils.retry",
                  "backoff sleeps + deadline arithmetic"),
    ClockFallback("utils.retry.probe_call", "utils.retry",
                  "probe deadline arithmetic"),
)


@dataclasses.dataclass(frozen=True)
class EnvSeam:
    """A function sanctioned to consult ``os.environ`` at call time
    inside a replay domain — a declared config seam."""

    module: str            # dotted module (relative to ceph_tpu_torch)
    qual: str              # function qualname ("f" or "Cls.meth")
    vars: Tuple[str, ...]  # the knobs this seam owns
    why: str


ENV_SEAMS: Tuple[EnvSeam, ...] = (
    EnvSeam("utils.config", "Config.get", ("CEPH_TPU_*",),
            "THE config seam: schema-typed env overlay"),
    EnvSeam("utils.log", "_parse_env", ("CEPH_TPU_DEBUG",),
            "log-level table bootstrap"),
    EnvSeam("utils.debug", "verification_enabled", ("CEPH_TPU_VERIFY",),
            "sanitizer gate: diagnostics, not dataplane state"),
    EnvSeam("utils.compile_cache", "compile_cache_dir",
            ("CEPH_TPU_COMPILE_CACHE",),
            "persistent-cache dir knob, read under an init memo"),
    EnvSeam("ops.fallback", "FallbackPolicy.__init__",
            ("CEPH_TPU_ENGINE",),
            "engine-tier override, bound at policy construction"),
    EnvSeam("ops.supervisor", "DispatchSupervisor.__init__",
            ("CEPH_TPU_DISPATCH_DEADLINE", "CEPH_TPU_SELF_VERIFY"),
            "supervision knobs, bound at construction"),
    EnvSeam("ops.xor_schedule", "_max_ones",
            ("CEPH_TPU_XOR_SCHED_MAX_ONES",),
            "scheduler cutover knob (build-time, memo-cached use)"),
    EnvSeam("telemetry.tracing", "maybe_install_from_env",
            ("CEPH_TPU_TRACE",),
            "the documented tracing opt-in, consulted at run start"),
    EnvSeam("telemetry.profiler", "resolve_peak_gbps",
            ("CEPH_TPU_HBM_PEAK_GBPS",),
            "roofline denominator override"),
    EnvSeam("telemetry.recorder", "FlightRecorder.dump",
            ("CEPH_TPU_FLIGHT_DIR",),
            "post-mortem sink dir; dump contents stay deterministic"),
    EnvSeam("parallel.plane", "_resolve_hosts", ("CEPH_TPU_HOSTS",),
            "host-domain topology probe, resolved once per plane"),
    EnvSeam("parallel.plane", "_resolve_env", ("CEPH_TPU_MESH",),
            "mesh default, resolved once under the _env_resolved memo"),
    EnvSeam("parallel.mesh", "visible_devices",
            ("CEPH_TPU_TORCH_VIRTUAL_DEVICES",),
            "virtual members over one device (the reference's forced "
            "host device count), read when a plane forms"),
    EnvSeam("ops._build", "_nvcc", ("CUDA_HOME", "CUDA_PATH"),
            "where the CUDA toolkit is, read once per kernel build"),
    EnvSeam("parallel.plane", "init_distributed",
            ("CEPH_TPU_DIST_COORD", "CEPH_TPU_DIST_PROCS",
             "CEPH_TPU_DIST_ID"),
            "multi-process bootstrap gate, called once at startup"),
)


# ----------------------------------------------------------------------
# accessors

_DOMAINS_BY_PREFIX: Dict[str, DomainSpec] = {d.prefix: d
                                             for d in DOMAINS}
assert len(_DOMAINS_BY_PREFIX) == len(DOMAINS), \
    "duplicate domain prefix in DOMAINS"

_FALLBACKS_BY_ID: Dict[str, ClockFallback] = {f.id: f
                                              for f in CLOCK_FALLBACKS}
assert len(_FALLBACKS_BY_ID) == len(CLOCK_FALLBACKS), \
    "duplicate fallback id in CLOCK_FALLBACKS"


def domain_for(module: str) -> Optional[DomainSpec]:
    """Longest-prefix domain match for a dotted module, or None."""
    parts = module.split(".")
    for i in range(len(parts), 0, -1):
        d = _DOMAINS_BY_PREFIX.get(".".join(parts[:i]))
        if d is not None:
            return d
    return None


def domain_kind(module: str) -> str:
    d = domain_for(module)
    return d.kind if d is not None else DEFAULT_KIND


def is_replay(module: str) -> bool:
    return domain_kind(module) == "replay"


def clock_seam_quals(module: str) -> FrozenSet[str]:
    return frozenset(s.qual for s in CLOCK_SEAMS
                     if s.module == module)


def env_seam_quals(module: str) -> FrozenSet[str]:
    return frozenset(s.qual for s in ENV_SEAMS if s.module == module)


def fallback_ids() -> FrozenSet[str]:
    return frozenset(_FALLBACKS_BY_ID)


def fallback(seam_id: str) -> Optional[ClockFallback]:
    return _FALLBACKS_BY_ID.get(seam_id)


def fallbacks_for_module(module: str) -> Tuple[ClockFallback, ...]:
    return tuple(f for f in CLOCK_FALLBACKS if f.module == module)


__all__ = ["CLOCK_FALLBACKS", "CLOCK_SEAMS", "DEFAULT_KIND", "DOMAINS",
           "ENV_SEAMS", "REPLAYMODEL_SCHEMA_VERSION", "ClockFallback",
           "ClockSeam", "DomainSpec", "EnvSeam", "clock_seam_quals",
           "domain_for", "domain_kind", "env_seam_quals", "fallback",
           "fallback_ids", "fallbacks_for_module", "is_replay"]
