"""ceph_tpu_torch.telemetry — span tracing, latency histograms, the
unified metrics plane and causal tracing, the parts of
``ceph_tpu/telemetry`` the serving plane needs.

- ``histogram`` — log-bucketed latency histograms with exact
                  p50/p99/p999 readout (a copy).
- ``metrics``   — the labeled counter/gauge/histogram/event registry,
                  and the kernel-setup count that stands in for the
                  reference's compile monitor.
- ``spans``     — deterministic, clock-injectable span trees.
- ``tracing``   — per-request causal traces, off unless asked for.
- ``analyzer``  — the critical-path analyzer over the traces: segment
                  decomposition, tail attribution, timeline export (a
                  copy).
- ``recorder``  — the flight recorder: a bounded ring of recent events
                  and span roots, frozen into a post-mortem dump at each
                  failure trigger (a copy).
- ``schema``    — shape validation for the unified dump and the flight
                  and trace dumps (a copy).
- ``profiler``  — per-program cost/roofline attribution: analytic cost
                  models, CUDA-event timing on the card, the join.

Host-side only at import: nothing here touches a device until a CUDA
record is timed.  :func:`telemetry_selftest`, ``profiler_selftest``,
``flight_recorder_selftest`` and ``tracing_selftest`` are the host
entries of the entry-point registry (analysis/entrypoints.py).
"""

from __future__ import annotations

from .histogram import LatencyHistogram, bucket_index, bucket_lower
from .metrics import (
    KERNEL_SETUPS,
    MetricsRegistry,
    counter,
    event,
    gauge,
    global_metrics,
    kernel_setups,
    note_kernel_setup,
    observe,
    record_dispatch,
    set_enabled,
    set_global_metrics,
)
from .profiler import (
    ProgramProfiler,
    global_profiler,
    profile_entrypoints,
    profiler_selftest,
    set_global_profiler,
)
from .recorder import (
    FlightRecorder,
    flight_recorder_selftest,
    global_flight_recorder,
    install_flight_recorder,
    set_global_flight_recorder,
)
from .schema import (
    SCHEMA_VERSION,
    validate_dump,
    validate_flight_dump,
    validate_profile_section,
    validate_trace_dump,
)
from .spans import Span, SpanTracer, global_tracer, set_global_tracer, span
from .tracing import TraceCollector, TraceContext, tracing_selftest


def dump_all(profile: bool = False, flight: bool = False,
             traces: bool = False) -> dict:
    """The unified observability dump: the legacy perf-counter
    registry (utils/perf.py, the reference's `perf dump` shape), the
    telemetry metrics registry, and the finished span trees — one
    JSON object, validated by schema.validate_dump.

    ``profile`` adds the program profiler's attribution section
    (whatever programs the process has captured so far); ``flight``
    adds the flight recorder's ring + post-mortem dumps; ``traces``
    adds the causal-tracing collector's dump (empty-shaped when no
    collector is installed)."""
    from ..utils.perf import global_perf

    out: dict = {"schema_version": SCHEMA_VERSION}
    out.update(global_perf().dump())
    out.update(global_metrics().dump())
    out["spans"] = global_tracer().to_dict()
    if profile:
        out["profile"] = global_profiler().to_dict()
    if flight:
        out["flight_recorder"] = global_flight_recorder().to_dict()
    if traces:
        from . import tracing as _tracing
        coll = _tracing.active()
        out["traces"] = (coll.to_dict() if coll is not None
                         else _tracing.TraceCollector().to_dict())
    return out


def reset_all() -> None:
    """Reset every process-global observability surface (tests and
    the perf-dump CLI's fresh-scenario runs)."""
    from ..utils.perf import global_perf

    global_perf().reset()
    global_metrics().reset()
    global_tracer().reset()
    global_profiler().reset()
    global_flight_recorder().reset()


def telemetry_selftest() -> dict:
    """The host-tier representative workload of the registry: drive a
    span tree, a histogram, labeled counters and both exporters on
    isolated instances with a fixed fake clock, validate the combined
    shape, and return plain host data.  Registered in
    analysis/entrypoints.py with ``kind="host"``: the audit fails it if
    it returns a CUDA tensor."""

    class _Tick:
        def __init__(self) -> None:
            self.now = 0.0

        def monotonic(self) -> float:
            self.now += 0.001
            return self.now

    clock = _Tick()
    tracer = SpanTracer(clock=clock)
    registry = MetricsRegistry(clock=clock)
    with tracer.span("repair", objects=2):
        with tracer.span("scrub"):
            registry.counter("selftest_scrubs", 2)
        with tracer.span("dispatch", engine="host"):
            with registry.timed("selftest_dispatch_seconds",
                                engine="host"):
                pass
    registry.observe("selftest_dispatch_seconds", 0.002, engine="host")
    registry.gauge("selftest_patterns", 1)
    registry.event("selftest", phase="done")
    dump = {"schema_version": SCHEMA_VERSION}
    dump.update(registry.dump())
    dump["spans"] = tracer.to_dict()
    errors = validate_dump(dump)
    if errors:
        raise AssertionError(f"telemetry selftest dump invalid: "
                             f"{errors}")
    prom = registry.to_prometheus()
    if "selftest_scrubs_total" not in prom:
        raise AssertionError("prometheus exposition lost a counter")
    json_a = tracer.to_json()
    if not json_a or json_a != tracer.to_json():
        raise AssertionError("span JSON export is not deterministic")
    return dump


__all__ = [
    "FlightRecorder",
    "KERNEL_SETUPS",
    "LatencyHistogram",
    "MetricsRegistry",
    "ProgramProfiler",
    "SCHEMA_VERSION",
    "Span",
    "SpanTracer",
    "TraceCollector",
    "TraceContext",
    "bucket_index",
    "bucket_lower",
    "counter",
    "dump_all",
    "event",
    "flight_recorder_selftest",
    "gauge",
    "global_flight_recorder",
    "global_metrics",
    "global_profiler",
    "global_tracer",
    "install_flight_recorder",
    "kernel_setups",
    "note_kernel_setup",
    "observe",
    "profile_entrypoints",
    "profiler_selftest",
    "record_dispatch",
    "reset_all",
    "set_enabled",
    "set_global_flight_recorder",
    "set_global_metrics",
    "set_global_profiler",
    "set_global_tracer",
    "span",
    "telemetry_selftest",
    "tracing_selftest",
    "validate_dump",
    "validate_flight_dump",
    "validate_profile_section",
    "validate_trace_dump",
]
