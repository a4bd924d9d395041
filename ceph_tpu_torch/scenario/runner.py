"""The scenario runner — the part of ``ceph_tpu/scenario/runner.py``
the serving plane needs: :func:`run_serving_scenario`, the serving
event loop, with a ``device`` argument.  Composed scenarios
(``run_scenario``: churn, recovery and scrub interleaved on one clock)
and the loop's hooks for them (``sla``, ``interleave``, ``on_result``)
come with ROADMAP Queue A item 7.

Determinism: with a FakeClock and a deterministic service model, batch
composition and the SLO report are a pure function of the spec, and
equal to the reference's.  With the real clock and no model, the same
loop is a wall-clock measurement.
"""

from __future__ import annotations

from ..telemetry import tracing
from ..telemetry.metrics import kernel_setups

# advance floor when the sim clock would otherwise stall (a due event
# exactly at `now` always makes progress on the next poll)
_TICK = 1e-4


# ----------------------------------------------------------------------
# the serving event loop (serve/loadgen.py wraps it)

def run_serving_scenario(spec, clock=None, executor: str = "device",
                         service_model=None, warmup: bool = True,
                         requests=None, offsets=None, *, device=None):
    """Drive ``spec``'s stream through queue → batcher → SLO ledger.

    ``executor="device"`` runs the batcher's instances on ``device``
    (default: the card; only ``device="cpu"`` runs on the CPU) and
    reports ``stream_compiles`` — kernel setups (kernel libraries
    loaded, kernel data uploaded: ``telemetry.metrics.KERNEL_SETUPS``)
    after warmup, the count the warm-stream gate pins at 0.

    ``requests`` (with ``offsets`` for open-loop arrival) substitutes
    a pre-built request list for the generator's.
    """
    from ..serve.batcher import ContinuousBatcher
    from ..serve.loadgen import LoadGenerator, ServingRun
    from ..serve.queue import AdmissionQueue
    from ..serve.sla import SlaRecorder, SloPolicy
    from ..utils.detcheck import default_clock
    from ..utils.retry import SystemClock

    if clock is None:
        clock = default_clock("scenario.runner.run_serving_scenario",
                              SystemClock)
    # the CEPH_TPU_TRACE opt-in: a causal-trace collector for this
    # run when the env knob asks and none is active (no-op otherwise;
    # tracing is off by default)
    tracing.maybe_install_from_env(clock=clock, seed=spec.seed)
    if requests is not None:
        reqs = requests
        if spec.arrival == "open" and offsets is None:
            raise ValueError("open-loop arrival needs offsets for a "
                             "pre-built request list")
    else:
        gen = LoadGenerator(spec)
        reqs, offsets = gen.generate()
    slo = SloPolicy(deadlines=dict(spec.deadlines))
    queue = AdmissionQueue(clock=clock, capacity=spec.queue_capacity,
                           slo=slo)
    batcher = ContinuousBatcher(clock=clock, ladder=spec.ladder,
                                executor=executor,
                                service_model=service_model,
                                paged=getattr(spec, "paged", False),
                                page_size=getattr(spec, "page_size",
                                                  None),
                                pool_pages=getattr(spec, "pool_pages",
                                                   None),
                                device=device)
    sla = SlaRecorder(slo)
    if warmup:
        batcher.warmup(reqs)
    setups_before = kernel_setups() if executor == "device" else None

    results = []
    start = clock.monotonic()

    def _absorb(batch) -> None:
        for res in batch:
            sla.record(res)
        results.extend(batch)

    if spec.arrival == "open":
        arrivals = [start + off for off in offsets]
        i = 0
        while i < len(reqs) or batcher.pending() or len(queue):
            now = clock.monotonic()
            while i < len(reqs) and arrivals[i] <= now:
                # an open-loop arrival shed at the door IS a miss for
                # that request — the closed loop below retries instead
                # (its submit-False is backpressure, not a shed)
                if not queue.submit(reqs[i]):
                    sla.record_reject(reqs[i], "capacity")
                i += 1
            fired = batcher.poll(queue)
            _absorb(fired)
            if fired:
                continue
            nxt = []
            if i < len(reqs):
                nxt.append(arrivals[i])
            wake = batcher.next_wakeup()
            if wake is not None:
                nxt.append(wake)
            if not nxt:
                _absorb(batcher.flush())
                break
            now = clock.monotonic()
            clock.sleep(max(min(nxt) - now, _TICK))
    else:
        i = 0
        inflight = 0
        while i < len(reqs) or batcher.pending() or len(queue):
            while inflight < spec.concurrency and i < len(reqs):
                if not queue.submit(reqs[i]):
                    break
                i += 1
                inflight += 1
            fired = batcher.poll(queue)
            _absorb(fired)
            inflight -= len(fired)
            if fired:
                continue
            wake = batcher.next_wakeup()
            if wake is None:
                _absorb(batcher.flush())
                break
            clock.sleep(max(wake - clock.monotonic(), _TICK))
    elapsed = clock.monotonic() - start
    report = sla.report(elapsed, padding=batcher.padding_stats())
    report["admitted"] = queue.admitted
    report["rejected"] = queue.rejected
    report["arrival"] = spec.arrival
    report["seed"] = spec.seed
    stream_compiles = None
    if setups_before is not None:
        stream_compiles = kernel_setups() - setups_before
        report["stream_compiles"] = stream_compiles
    return ServingRun(results=results, report=report, queue=queue,
                      batcher=batcher, stream_compiles=stream_compiles)
