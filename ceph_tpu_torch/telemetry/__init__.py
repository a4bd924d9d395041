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

Host-side only: nothing here touches a device.  Not ported yet: the
flight recorder, the program profiler and the dump schema (ROADMAP
Queue A item 6).
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
from .spans import Span, SpanTracer, global_tracer, set_global_tracer, span
from .tracing import TraceCollector, TraceContext

__all__ = [
    "KERNEL_SETUPS",
    "LatencyHistogram",
    "MetricsRegistry",
    "Span",
    "SpanTracer",
    "TraceCollector",
    "TraceContext",
    "bucket_index",
    "bucket_lower",
    "counter",
    "event",
    "gauge",
    "global_metrics",
    "global_tracer",
    "kernel_setups",
    "note_kernel_setup",
    "observe",
    "record_dispatch",
    "set_enabled",
    "set_global_metrics",
    "set_global_tracer",
    "span",
]
