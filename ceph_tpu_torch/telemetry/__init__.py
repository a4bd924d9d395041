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

Host-side only: nothing here touches a device.  Not ported yet: the
program profiler (ROADMAP Queue A item 6), so :func:`dump_all` has no
``profile`` section.
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
    validate_trace_dump,
)
from .spans import Span, SpanTracer, global_tracer, set_global_tracer, span
from .tracing import TraceCollector, TraceContext


def dump_all(flight: bool = False, traces: bool = False) -> dict:
    """The unified observability dump: the legacy perf-counter
    registry (utils/perf.py, the reference's `perf dump` shape), the
    telemetry metrics registry, and the finished span trees — one
    JSON object, validated by schema.validate_dump.

    ``flight`` adds the flight recorder's ring + post-mortem dumps;
    ``traces`` adds the causal-tracing collector's dump (empty-shaped
    when no collector is installed).  The reference's ``profile``
    section comes with the program profiler (ROADMAP Queue A item 6)."""
    from ..utils.perf import global_perf

    out: dict = {"schema_version": SCHEMA_VERSION}
    out.update(global_perf().dump())
    out.update(global_metrics().dump())
    out["spans"] = global_tracer().to_dict()
    if flight:
        out["flight_recorder"] = global_flight_recorder().to_dict()
    if traces:
        from . import tracing as _tracing
        coll = _tracing.active()
        out["traces"] = (coll.to_dict() if coll is not None
                         else _tracing.TraceCollector().to_dict())
    return out



__all__ = [
    "FlightRecorder",
    "KERNEL_SETUPS",
    "LatencyHistogram",
    "MetricsRegistry",
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
    "global_tracer",
    "install_flight_recorder",
    "kernel_setups",
    "note_kernel_setup",
    "observe",
    "record_dispatch",
    "set_enabled",
    "set_global_flight_recorder",
    "set_global_metrics",
    "set_global_tracer",
    "span",
    "validate_dump",
    "validate_flight_dump",
    "validate_trace_dump",
]
