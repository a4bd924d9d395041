"""The lock-order registry — a port of
``ceph_tpu/analysis/lockmodel.py``, its ids those of the port's own
``make_lock`` / ``make_rlock`` sites.

The intended host-side locking discipline is *written down* here, one
:class:`LockSpec` per lock the package creates; the runtime validator
(utils/locks.py, ``CEPH_TPU_LOCKCHECK=1``) flags any observed
acquisition that inverts the declared ranks, and
tests/test_torch_lockcheck.py requires every ``make_lock`` id in
``ceph_tpu_torch/`` to have a rank here.  (The reference's static pass,
``analysis/concurrency.py``, comes with ROADMAP Queue A item 8.)

Rank semantics: **lower rank = acquired first (outer)**.  A thread
holding lock A may only acquire lock B when ``rank(A) < rank(B)``.
Equal ranks are mutually exclusive (never nested) — two leaf locks
that are never held together may share a band.  The bands:

=========  ==========================================================
100–199    orchestration front doors (serve queue, dispatch
           supervisor, fallback policy) — outermost
200–299    engine/caches + plugin registry + kernel builds + chaos
           plans + the tuning table (taken while orchestration locks
           may be held)
300–399    telemetry singleton-installer + collector locks (any
           layer above may emit telemetry)
400–499    telemetry leaf structures (histogram)
500–599    leaf utility state (config, log levels, perf counters)
=========  ==========================================================

The reference's locks the port has no counterpart of are left out: the
compile-cache memo (the port's kernel build cache needs no lock: the
build's own table lock, ``ops._build._lock``, guards its libraries),
the compile monitor's memo, the sanitizer-mode lock, and the jaxpr
audit's counter, which has no torch analog.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

LOCKMODEL_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LockSpec:
    """One declared lock: its dotted id, module, kind and rank."""

    id: str        # "<module>.<Owner>.<attr>" or "<module>.<attr>"
    module: str    # dotted module (relative to ceph_tpu_torch)
    rank: int      # acquisition order: lower = outer
    kind: str      # "lock" | "rlock" | "condition"
    guards: str    # one line: what state this lock protects


LOCKS: Tuple[LockSpec, ...] = (
    # -- 100s: orchestration front doors (outermost) -------------------
    LockSpec("serve.queue.AdmissionQueue._lock", "serve.queue", 100,
             "lock", "admission/run/done queues + stream stats"),
    LockSpec("ops.supervisor.DispatchSupervisor._lock", "ops.supervisor",
             110, "lock", "dispatch counters, pacing floor, probe state"),
    LockSpec("ops.supervisor._global_lock", "ops.supervisor", 120,
             "lock", "process-global supervisor singleton install"),
    LockSpec("ops.fallback._global_lock", "ops.fallback", 130,
             "lock", "process-global fallback-policy singleton install"),
    LockSpec("ops.fallback.FallbackPolicy._lock", "ops.fallback", 140,
             "lock", "backend health state + demotion bookkeeping"),

    # -- 200s: engines, caches, plugin registry, kernel builds, chaos --
    LockSpec("codes.registry.ErasureCodePluginRegistry._instance_lock",
             "codes.registry", 200, "lock",
             "singleton construction of the plugin registry"),
    LockSpec("codes.registry.ErasureCodePluginRegistry._lock",
             "codes.registry", 210, "rlock",
             "plugin table; held across plugin load (plugins_lock role)"),
    LockSpec("codes.engine._global_lock", "codes.engine", 220, "lock",
             "process-global pattern-cache singleton install"),
    LockSpec("codes.engine.PatternCache._lock", "codes.engine", 230,
             "lock", "decode-pattern compile cache table"),
    LockSpec("ops._build._lock", "ops._build", 235, "lock",
             "loaded kernel-library table (builds run unlocked)"),
    LockSpec("parallel.plane._lock", "parallel.plane", 240, "lock",
             "active data plane + env-resolution flag"),
    LockSpec("chaos.dispatch._lock", "chaos.dispatch", 250, "lock",
             "active fault-plan install/uninstall"),
    LockSpec("chaos.dispatch.DispatchFaultPlan._lock", "chaos.dispatch",
             260, "lock", "fault schedule cursor + fired-fault log"),
    LockSpec("chaos.hosts._lock", "chaos.hosts", 252, "lock",
             "active host-fault-plan install/uninstall"),
    LockSpec("chaos.hosts.HostFaultPlan._lock", "chaos.hosts", 262,
             "lock", "host-fault schedule cursor + fired-fault log"),
    LockSpec("tune.table._lock", "tune.table", 270, "lock",
             "active best-config table install + generation counter"),
    LockSpec("tune.table.BestConfigTable._lock", "tune.table", 280,
             "lock", "per-table row map + stale-warning memo"),
    LockSpec("tune.table._env_lock", "tune.table", 290, "lock",
             "resolved-env memo for table key matching"),

    # -- 300s: telemetry collectors + singleton installers -------------
    LockSpec("telemetry.tracing._lock", "telemetry.tracing", 300,
             "lock", "process-global trace-collector install"),
    LockSpec("telemetry.tracing.TraceCollector._lock",
             "telemetry.tracing", 310, "lock",
             "finished-trace ring + exemplar reservoirs"),
    LockSpec("telemetry.spans._global_lock", "telemetry.spans", 320,
             "lock", "process-global span-tracer install"),
    LockSpec("telemetry.spans.SpanTracer._lock", "telemetry.spans", 330,
             "lock", "finished-span ring buffer"),
    LockSpec("telemetry.metrics._global_lock", "telemetry.metrics", 340,
             "lock", "process-global metrics-registry install"),
    LockSpec("telemetry.metrics.MetricsRegistry._lock",
             "telemetry.metrics", 350, "lock",
             "counter/gauge/event/histogram tables"),
    LockSpec("telemetry.profiler._global_lock", "telemetry.profiler",
             370, "lock", "process-global profiler install"),
    LockSpec("telemetry.profiler.ProgramProfiler._lock",
             "telemetry.profiler", 380, "lock",
             "per-program cost/roofline record table + pending CUDA "
             "event pairs"),
    LockSpec("telemetry.recorder._global_lock", "telemetry.recorder",
             390, "lock", "process-global flight-recorder install"),
    LockSpec("telemetry.recorder.FlightRecorder._lock",
             "telemetry.recorder", 395, "lock",
             "event ring + frozen post-mortem dumps"),

    # -- 400s: telemetry leaf structures -------------------------------
    LockSpec("telemetry.histogram.LatencyHistogram._lock",
             "telemetry.histogram", 400, "lock",
             "bucket counts + sum/max accumulators"),

    # -- 500s: leaf utility state (innermost) --------------------------
    LockSpec("utils.config.Config._lock", "utils.config", 520, "lock",
             "config value overlay"),
    LockSpec("utils.log._lock", "utils.log", 530, "lock",
             "per-subsystem log-level table"),
    LockSpec("utils.perf.PerfCounters._lock", "utils.perf", 550,
             "lock", "u64/time/gauge counter stores"),
)

_BY_ID: Dict[str, LockSpec] = {s.id: s for s in LOCKS}
assert len(_BY_ID) == len(LOCKS), "duplicate lock id in LOCKS"


def all_ranks() -> Dict[str, int]:
    """lock id -> declared rank (the runtime validator's order table)."""
    return {s.id: s.rank for s in LOCKS}


def lock_ids() -> frozenset:
    return frozenset(_BY_ID)


def spec(lock_id: str) -> Optional[LockSpec]:
    return _BY_ID.get(lock_id)


def modules() -> frozenset:
    """Every module the registry declares at least one lock for."""
    return frozenset(s.module for s in LOCKS)


__all__ = ["LOCKS", "LOCKMODEL_SCHEMA_VERSION", "LockSpec", "all_ranks",
           "lock_ids", "modules", "spec"]
