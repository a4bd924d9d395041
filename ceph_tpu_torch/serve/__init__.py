"""ceph_tpu_torch.serve — the ragged continuous-batching serving
front end, a port of ``ceph_tpu/serve``.

Everything below this package is a batch library: hand it a
pre-stacked ``(B, k, C)`` array and it runs one dispatch.  Production
traffic is a *stream* of mixed (plugin, k, m, stripe-size, op) requests
with deadlines.  This package is the conversion layer:

- ``queue``   — :class:`EcRequest` + the bounded, clock-injectable
                admission queue (reject-at-the-door overload policy).
- ``batcher`` — the continuous batcher: shape buckets keyed like the
                PatternCache, batch dim padded up a small fixed rung
                ladder, deadline-slack firing.  ``paged=True`` swaps the
                buckets for ragged page-pool queues (mixed stripe
                sizes, one dispatch per pattern, page-tail-only
                padding).
- ``pool``    — the paged stripe pool: fixed-size pages, page-table
                indirection, explicit reclaim at demux.
- ``sla``     — per-op-class SLO policy + evaluation (p50/p99/p999,
                GB/s-under-SLO, deadline-miss and padding overheads).
- ``loadgen`` — seeded open/closed-loop traffic generation and the
                shared scenario event loop.

Host bookkeeping touches no device; the device seams are
:func:`ceph_tpu_torch.codes.engine.serve_dispatch_call` and
``serve_dispatch_ragged``.
"""

from .queue import OPS, AdmissionQueue, EcRequest, EcResult
from .sla import BurnRateMonitor, SlaRecorder, SloPolicy
from .batcher import LADDER, ContinuousBatcher, rung_for
from .pool import (
    PagedStripePool,
    PoolExhausted,
    effective_page_size,
    join_pages,
    pool_selftest,
    split_pages,
    tuned_pool_config,
)
from .loadgen import (
    CodecSpec,
    LoadGenerator,
    ServingRun,
    TrafficSpec,
    default_spec,
    run_serving_scenario,
    throughput_service_model,
    verify_results,
)

__all__ = [
    "AdmissionQueue",
    "BurnRateMonitor",
    "CodecSpec",
    "ContinuousBatcher",
    "EcRequest",
    "EcResult",
    "LADDER",
    "LoadGenerator",
    "OPS",
    "PagedStripePool",
    "PoolExhausted",
    "ServingRun",
    "SlaRecorder",
    "SloPolicy",
    "TrafficSpec",
    "default_spec",
    "effective_page_size",
    "join_pages",
    "pool_selftest",
    "rung_for",
    "run_serving_scenario",
    "split_pages",
    "throughput_service_model",
    "tuned_pool_config",
    "verify_results",
]
