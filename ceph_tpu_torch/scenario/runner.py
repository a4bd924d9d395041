"""The scenario runner — ONE event loop for serving, churn, recovery and
scrub on a single injectable clock; a port of
``ceph_tpu/scenario/runner.py``.

- :func:`run_serving_scenario` — the serving event loop, with an
  ``interleave`` hook: one callback per loop turn, where a composed
  scenario runs its background work on the same clock.  With no hook
  the loop is byte-for-byte the standalone serving loop.
- :func:`drive_storm` — the churn-storm loop (cluster/storms.py wraps
  it).
- :func:`stage_damaged_objects` — the store/injector staging the
  bench's cluster workload and the scenarios share.
- :func:`run_scenario` — the composition: build the cluster, stage
  recovery work, pre-compute the rateless first-k schedule under the
  straggler, wire the mClock arbiter (scenario/qos.py) between the
  client SLO ledger and the recovery throttle, then drive the client
  stream while churn, recovery rounds and scrub ticks interleave
  under arbitration.  After the stream drains, the storm is drained
  and recovery runs to convergence at the arbiter's pace.

Devices: :func:`run_scenario` runs on the card unless the caller asks
for the CPU (``device="cpu"``) or the host tier (``executor="host"``:
CPU instances pinned to the numpy region ops, a host recovery).

Determinism: with a FakeClock and deterministic service models every
piece — batch composition, arbitration decisions, recovery rounds,
churn epochs — is a pure function of the spec, so the ScenarioReport
JSON replays byte-identically from one seed, and equals the
reference's.  With the real clock and no models, the same loop is the
bench's ``--workload scenario`` measurement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..telemetry import metrics as tel
from ..telemetry import tracing
from ..telemetry.metrics import kernel_setups

# advance floor when the sim clock would otherwise stall (a due event
# exactly at `now` always makes progress on the next poll)
_TICK = 1e-4


# ----------------------------------------------------------------------
# the serving event loop (serve/loadgen.py wraps it)

def run_serving_scenario(spec, clock=None, executor: str = "device",
                         service_model=None, warmup: bool = True,
                         requests=None, offsets=None, *, device=None,
                         sla=None,
                         interleave: Optional[Callable[[], None]] = None,
                         on_result: Optional[Callable] = None,
                         on_stall: Optional[Callable[[], bool]] = None):
    """Drive ``spec``'s stream through queue → batcher → SLO ledger.

    ``executor="device"`` runs the batcher's instances on ``device``
    (default: the card; only ``device="cpu"`` runs on the CPU) and
    reports ``stream_compiles`` — kernel setups (kernel libraries
    loaded, kernel data uploaded: ``telemetry.metrics.KERNEL_SETUPS``)
    after warmup, the count the warm-stream gate pins at 0.

    ``requests`` (with ``offsets`` for open-loop arrival) substitutes
    a pre-built request list for the generator's.

    ``interleave`` (scenario composition): called once per loop turn
    after fired results are absorbed; background work run there
    shares the loop's clock, so whatever time it charges ages the
    queued requests — contention by construction.  ``on_result`` sees
    every EcResult as it lands (the arbiter's SLO feedback tap).
    ``sla`` injects a pre-built SlaRecorder (the scenario keeps the
    burn-rate monitor's trip ledger for its report).

    On the card a fire whose dispatch raises ``DeviceDispatchError``
    keeps its requests and holds its bucket (the batcher's
    ``release_holds``): the card's work never leaves the card.  When
    only held work is left, ``on_stall()`` is asked whether the backend
    is back; True releases the holds and the loop goes on.  Work still
    held at the end raises ``DeviceDispatchError``.
    """
    from ..serve.batcher import ContinuousBatcher
    from ..serve.loadgen import LoadGenerator, ServingRun
    from ..serve.queue import AdmissionQueue
    from ..serve.sla import SlaRecorder, SloPolicy
    from ..utils.detcheck import default_clock
    from ..utils.errors import DeviceDispatchError
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
    if sla is None:
        sla = SlaRecorder(slo)
    if warmup:
        batcher.warmup(reqs)
    setups_before = kernel_setups() if executor == "device" else None

    results = []
    start = clock.monotonic()

    def _absorb(batch) -> None:
        for res in batch:
            sla.record(res)
            if on_result is not None:
                on_result(res)
        results.extend(batch)

    def _released() -> bool:
        """Only held work left: release it if the backend is back."""
        if batcher.held() and on_stall is not None and on_stall():
            batcher.release_holds()
            return True
        return False

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
            if interleave is not None:
                interleave()
            if fired:
                continue
            nxt = []
            if i < len(reqs):
                nxt.append(arrivals[i])
            wake = batcher.next_wakeup()
            if wake is not None:
                nxt.append(wake)
            if not nxt:
                if _released():
                    continue
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
            if interleave is not None:
                interleave()
            if fired:
                continue
            wake = batcher.next_wakeup()
            if wake is None:
                if _released():
                    continue
                _absorb(batcher.flush())
                break
            clock.sleep(max(wake - clock.monotonic(), _TICK))
    if batcher.held():
        raise DeviceDispatchError(
            "serve.batch", "held",
            f"{batcher.held()} request(s) held by failed fires on the "
            f"card when the stream ended")
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


# ----------------------------------------------------------------------
# the churn-storm loop (cluster/storms.py wraps it)

def drive_storm(m, *, seed: int = 0, events: int = 100,
                max_down: int = 4, pool_ids=None, engine: str = "bulk",
                drain: bool = True, avoid_osds=(), churn=None,
                measure_every: int = 1):
    """Fire a seeded ``events``-epoch churn storm at ``m`` through the
    incremental path, measuring full-cluster remaps per epoch on the
    bulk evaluator; then (``drain``) revive every still-downed osd,
    one epoch each, until the cluster is whole again.

    ``measure_every``: diff the cluster every Nth epoch (>1 trades
    per-epoch resolution for wall time on very large sweeps; the
    remap count then covers the whole stride)."""
    from ..chaos.adversaries import MapChurn
    from ..cluster.storms import StormReport, _diff_count, _snapshot
    from ..crush.incremental import get_epoch
    from ..telemetry.spans import global_tracer

    pids = sorted(m.pools) if pool_ids is None else sorted(pool_ids)
    if churn is None:
        churn = MapChurn(seed=seed, max_down=max_down, fire_every=1,
                         max_events=events, avoid_osds=avoid_osds)
    rep = StormReport(seed=seed, engine=engine, pool_ids=list(pids))
    rep.total_pgs = sum(m.pools[pid].pg_num for pid in pids)
    rep.epoch_start = get_epoch(m)
    tracer = global_tracer()
    measure_every = max(1, measure_every)

    prev = _snapshot(m, pids, engine)
    pending = 0

    def measure(force: bool = False) -> None:
        nonlocal prev, pending
        pending += 1
        if pending < measure_every and not force:
            rep.remapped_per_epoch.append(0)
            return
        cur = _snapshot(m, pids, engine)
        n = _diff_count(prev, cur)
        rep.remapped_per_epoch.append(n)
        rep.total_remapped += n
        rep.peak_remapped = max(rep.peak_remapped, n)
        tel.counter("cluster_storm_remapped_pgs", n)
        prev = cur
        pending = 0

    with tracer.span("cluster.storm", events=events, engine=engine):
        for _ in range(events):
            inc = churn.step(m, stage="storm")
            if inc is None:
                continue
            rep.events += 1
            kind = churn.events[-1]["kind"]
            rep.event_kinds[kind] = rep.event_kinds.get(kind, 0) + 1
            measure()
        if drain:
            with tracer.span("cluster.storm.drain",
                             downed=len(churn.downed)):
                while churn.downed:
                    drain_churn(m, churn, limit=1)
                    rep.drain_events += 1
                    measure(force=not churn.downed)
    rep.epoch_end = get_epoch(m)
    tel.counter("cluster_storm_epochs", rep.epochs)
    tel.gauge("cluster_remap_fraction", rep.mean_remap_fraction,
              phase="storm")
    return rep


def drain_churn(m, churn, limit: Optional[int] = None) -> int:
    """Revive churn-downed osds with one epoch-ordered Incremental
    each (``limit`` caps how many; None = all), recording the events
    on the churn like any other — the storm's drain phase and the
    scenario's post-stream cleanup share this."""
    from ..crush.incremental import CEPH_OSD_UP, Incremental, \
        apply_incremental, get_epoch
    from ..crush.osdmap import IN_WEIGHT

    revived = 0
    while churn.downed and (limit is None or revived < limit):
        osd = churn.downed.pop(0)
        inc = Incremental(epoch=get_epoch(m) + 1,
                          new_state={osd: CEPH_OSD_UP},
                          new_weight={osd: IN_WEIGHT})
        apply_incremental(m, inc)
        churn.incrementals.append(inc)
        churn.events.append({"kind": "drain_revive", "stage": "drain",
                             "epoch": inc.epoch,
                             "detail": f"osd.{osd}"})
        revived += 1
    return revived


# ----------------------------------------------------------------------
# store/injector staging (shared by the bench and the scenarios)

def stage_damaged_objects(sinfo, ec, n_objects: int, *, seed: int,
                          injectors_for: Callable[[int], list],
                          stripes: int = 1,
                          inject_seed: Optional[int] = None):
    """Encode ``n_objects`` seeded objects and damage each through its
    chaos injectors: returns (originals, stores, hinfos, faults) —
    the staging the bench's cluster workload and the scenario runners
    share.

    Byte-compatible with the reference's: object bytes come from ONE
    ``default_rng(seed)`` stream in object order, and object ``i``
    injects with ``seed = inject_seed + i`` (``inject_seed`` defaults
    to ``seed``)."""
    from ..chaos import inject
    from ..codes.stripe import HashInfo
    from ..codes.stripe import encode as stripe_encode

    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    width = k * sinfo.chunk_size
    rng = np.random.default_rng(seed)
    base = seed if inject_seed is None else inject_seed
    originals, stores, hinfos, all_faults = [], [], [], []
    for i in range(n_objects):
        obj = rng.integers(0, 256, size=width * stripes,
                           dtype=np.uint8).tobytes()
        shards = stripe_encode(sinfo, ec, obj)
        hinfo = HashInfo(n)
        hinfo.append(0, shards)
        store, faults = inject(shards, injectors_for(i), seed=base + i,
                               chunk_size=sinfo.chunk_size)
        originals.append(shards)
        stores.append(store)
        hinfos.append(hinfo)
        all_faults.append(faults)
    return originals, stores, hinfos, all_faults


# ----------------------------------------------------------------------
# THE composed scenario

@dataclass
class ScenarioRun:
    """One scenario's live artifacts (the report is the JSON face)."""

    report: object                  # ScenarioReport
    serving: object                 # ServingRun
    recovery: object                # RecoveryReport
    arbiter: object                 # MClockArbiter
    throttle: object
    churn: object
    stores: list
    originals: list


def _sample_placements(m, samples: int = 8):
    """A deterministic scalar placement sample per pool (host math —
    the scenario's remap accounting must never pull the bulk
    evaluator onto a host-tier path)."""
    out = {}
    for pid in sorted(m.pools):
        pg_num = m.pools[pid].pg_num
        step = max(1, pg_num // samples)
        for ps in range(0, pg_num, step):
            up, _, _, _ = m.pg_to_up_acting_osds(pid, ps)
            out[(pid, ps)] = list(up)
    return out


def run_scenario(spec, *, clock=None, executor: str = "device",
                 device=None, service_model=None, enable_arbiter=None,
                 capture_profile: bool = False) -> ScenarioRun:
    """Stand up the whole production day from ``spec`` and run it on
    one clock: client traffic at SLO while a churn storm remaps the
    cluster, recovery rounds heal straggler-skewed damage and scrub
    verifies in the background — all admission-gated by the mClock
    arbiter, which the client SLO ledger feeds live.

    ``service_model`` (sim mode): the serving batcher's deterministic
    service-time model; when set, background work charges the spec's
    modeled per-step costs to the same clock.  With a FakeClock the
    entire run — batch composition, arbitration, recovery rounds,
    churn epochs, the report — replays byte-identically from the
    seed.  Without it (real clock) the same loop is the bench
    measurement.

    ``enable_arbiter=False`` is the control: background work runs
    every turn unthrottled — the contention cost the arbiter exists
    to remove (the pinned claim: arbiter-on client p99 and miss rate
    strictly better, recovery still converges healed).

    ``executor="device"`` (default) runs the codes, the serving stream
    and the recovery on ``device``: the card unless the caller passes
    ``device="cpu"`` (``NoDeviceError`` without a card).  On the card
    the supervisor never demotes: a recovery round its fault raises
    ``DeviceDispatchError`` on is re-queued, as the bench's
    device-chaos pass is, and a client fire it raises on is held with
    its requests; once only held client work is left, the faulted
    backend (or the lost host) comes back — its plan clears, as it
    does when the stream drains — and the held fires run.
    ``executor="host"`` is the host arm: CPU instances pinned to the
    numpy region ops and a host recovery.
    """
    import torch

    from ..ops.fallback import resolve_device
    from ..utils.errors import DeviceDispatchError
    from ..chaos import BitFlip, ShardErasure, Straggler
    from ..chaos.adversaries import MapChurn
    from ..cluster.rateless import (plan_assignments, shard_weights,
                                    simulate_first_k)
    from ..cluster.topology import EC_POOL, build_cluster
    from ..codes.registry import ErasureCodePluginRegistry
    from ..codes.stripe import StripeInfo
    from ..recovery.journal import IntentJournal
    from ..recovery.orchestrator import RecoveryOrchestrator, healed
    from ..recovery.throttle import OsdRecoveryThrottle
    from ..scrub.deep_scrub import deep_scrub
    from ..utils.detcheck import default_clock
    from ..utils.retry import SystemClock
    from .qos import MClockArbiter
    from .report import ScenarioReport

    if clock is None:
        clock = default_clock("scenario.runner.run_scenario",
                              SystemClock)
    tracing.maybe_install_from_env(clock=clock, seed=spec.seed)
    if executor not in ("device", "host"):
        raise ValueError(f"executor {executor!r} must be device|host")
    dev = (torch.device("cpu") if executor == "host"
           else resolve_device(device))
    sim = service_model is not None
    chaos = spec.chaos
    t_start = clock.monotonic()

    # -- cluster + recovery material -------------------------------------
    m = build_cluster(spec.cluster, device=dev)
    codec = spec.codec_for_recovery()
    ec = ErasureCodePluginRegistry.instance().factory(
        codec.plugin, dict(codec.profile), device=dev)
    if executor == "host":
        # the host tier runs the numpy region ops only: the
        # scenario.runner audit entry pins this whole run to no device
        ec.min_xla_bytes = float("inf")
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    pool_n = m.pools[EC_POOL].size
    if pool_n < n:
        raise ValueError(f"recovery codec needs {n} slots, EC pool "
                         f"has {pool_n}")
    chunk = ec.get_chunk_size(spec.recovery_stripe)
    sinfo = StripeInfo(k, k * chunk)

    def injectors_for(i: int) -> list:
        inj = []
        if chaos.erasures:
            inj.append(ShardErasure(n=chaos.erasures))
        if chaos.corruptions:
            inj.append(BitFlip(n=chaos.corruptions, flips=1))
        return inj

    originals, stores, hinfos, faults = stage_damaged_objects(
        sinfo, ec, chaos.damaged_objects, seed=spec.seed + 101,
        injectors_for=injectors_for)

    # -- rateless first-k schedule under the straggler -------------------
    from ..parallel.plane import shard_count
    n_shards = shard_count(default=8)
    redundancy = max(1, min(2, n_shards))
    work = [max(chaos.erasures, 1) * chunk / float(1 << 16)
            ] * chaos.damaged_objects
    plan = plan_assignments(chaos.damaged_objects, n_shards,
                            redundancy, seed=spec.seed + 303)
    straggler = Straggler(seed=spec.seed + 303,
                          slow={chaos.straggler_shard:
                                chaos.straggler_factor})
    sched = simulate_first_k(plan, straggler, work)
    baseline = simulate_first_k(
        plan, Straggler(seed=spec.seed + 303), work)
    weights = shard_weights(sched)
    osd_weights = {o: weights[o % n_shards]
                   for o in range(m.max_osd)
                   if (o % n_shards) in weights
                   and weights[o % n_shards] < 1.0}

    # -- device-plane chaos: arm the seeded DispatchFault
    # plan the spec schedules; the supervised dispatch plane
    # (ops/supervisor.py) classifies and survives it, and the runner
    # ticks the health probe every turn so a cleared fault
    # re-promotes mid-run
    from ..chaos.dispatch import DispatchFault, DispatchFaultPlan, \
        arm_plan
    from ..chaos.hosts import HostFault, HostFaultPlan, arm_host_plan
    from ..ops.supervisor import global_supervisor
    dplan = None
    prev_plan = None
    hplan = None
    prev_hplan = None
    prev_reclaim = None
    host_plane_activated = False
    prev_plane = None
    topo_armed = None
    topo_end = None
    sup = None
    sup_before: dict = {}
    if chaos.dispatch_fault or chaos.host_loss:
        sup = global_supervisor()
        sup.reset_pacing()
        sup_before = {k: v for k, v in sup.stats().items()
                      if isinstance(v, int)}
    if chaos.dispatch_fault:
        dplan = DispatchFaultPlan(
            [DispatchFault(chaos.dispatch_fault,
                           seam=chaos.dispatch_fault_seam,
                           at=chaos.dispatch_fault_at,
                           calls=chaos.dispatch_fault_calls)],
            seed=spec.seed + 404)
        prev_plan = arm_plan(dplan)
    if chaos.host_loss:
        # host fault domains (chaos/hosts.py): arm the seeded host
        # fault; on a device executor, span a multi-host plane of the
        # device's members so the loss is survivable host-granular
        # (the host executor exercises the planeless ladder: loss of
        # host 0 demotes straight to the ground-truth twin; a card
        # with no virtual members forms no plane and raises)
        hplan = HostFaultPlan(
            [HostFault(chaos.host_loss, host=chaos.host_loss_host,
                       seam=chaos.host_loss_seam,
                       at=chaos.host_loss_at,
                       calls=chaos.host_loss_calls)],
            seed=spec.seed + 505)
        prev_hplan = arm_host_plan(hplan)
        if executor != "host":
            from ..parallel import plane as planemod
            prev_plane = planemod.data_plane()
            planemod.activate(None,
                              hosts=max(2, chaos.host_loss_hosts),
                              kind=dev.type)
            host_plane_activated = True
            topo_armed = planemod.host_plane_topology()

    # -- QoS arbiter + throttle (the closed loop) ------------------------
    arbiter = MClockArbiter(spec.qos, clock=clock,
                            enabled=enable_arbiter)
    throttle = OsdRecoveryThrottle(max_inflight=4)
    throttle.set_osd_weights(osd_weights)
    journal = IntentJournal()
    orch = RecoveryOrchestrator(
        sinfo, ec, m, EC_POOL, spec.recovery_ps, stores, hinfos,
        journal=journal, throttle=throttle, clock=clock,
        device=(False if executor == "host" else None),
        max_rounds=spec.max_recovery_rounds)
    if hplan is not None:
        # in-flight survival: when the supervisor quarantines a host it
        # calls back here — the survivors reclaim the lost host's
        # journaled intents (verify/keep/roll back); rolled-back ops
        # re-enter the orchestrator's next planning round on the
        # shrunken plane at a bumped epoch (journal.reclaim docstring)
        def _reclaim_lost_host(seam: str) -> int:
            _stats, redo = journal.reclaim(stores)
            return len(redo)

        prev_reclaim = sup.set_inflight_reclaim(_reclaim_lost_host)
    churn = MapChurn(seed=spec.seed + 202, max_down=chaos.max_down,
                     fire_every=1, max_events=chaos.storm_events)
    placements_before = _sample_placements(m)

    # -- the interleaved background (one call per serving loop turn) -----
    state = {"turns": 0, "churn_events": 0, "recovery_rounds": 0,
             "scrub_ticks": 0, "scrub_idx": 0, "converged": False}

    def on_result(res) -> None:
        arbiter.record_client(res.deadline_met)
        throttle.set_scale(arbiter.background_scale())

    def _charge(cls: str, t0: float, **attrs) -> None:
        # causal tracing: background work that aged waiting
        # client requests on the shared clock is an attribution
        # interval — the analyzer carves it out of queue/batch waits
        # as `arbiter_hold`.  Observation only: clock reads, no sleeps.
        if tracing.enabled():
            tracing.active().add_background(
                cls, t0, clock.monotonic(),
                pressure=round(arbiter.pressure(), 6),
                scale=round(arbiter.background_scale(), 6), **attrs)

    def run_recovery_round() -> None:
        t0 = clock.monotonic()
        try:
            nops = orch.run_round()
        except DeviceDispatchError:
            # raised for a card dispatch only: the card's work never
            # leaves it, so the round's ops stay planned and the next
            # admitted round re-queues them
            nops = 0
        state["recovery_rounds"] += 1
        tel.counter("scenario_recovery_rounds")
        if orch.report.converged:
            state["converged"] = True
        elif sim and nops:
            clock.sleep(spec.recovery_round_s)
        _charge("recovery", t0, round=state["recovery_rounds"],
                ops=nops)

    def interleave() -> None:
        state["turns"] += 1
        tel.counter("scenario_turns")
        if sup is not None:
            sup.tick()
        now = clock.monotonic()
        if (len(churn.events) < chaos.storm_events
                and now - t_start >= chaos.storm_at_s
                and state["turns"] % chaos.storm_every_turns == 0
                and arbiter.admit("rebalance", now)):
            inc = churn.step(m, stage="scenario")
            if inc is not None:
                state["churn_events"] += 1
                tel.counter("scenario_churn_events")
                if sim:
                    clock.sleep(spec.churn_step_s)
                _charge("rebalance", now,
                        event=state["churn_events"])
        if not state["converged"] and arbiter.admit("recovery"):
            run_recovery_round()
        if (state["scrub_ticks"] < chaos.scrub_ticks
                and arbiter.admit("scrub")):
            i = state["scrub_idx"] % len(stores)
            state["scrub_idx"] += 1
            t0 = clock.monotonic()
            deep_scrub(sinfo, ec, stores[i], hinfos[i])
            state["scrub_ticks"] += 1
            tel.counter("scenario_scrub_ticks")
            if sim:
                clock.sleep(spec.scrub_tick_s)
            _charge("scrub", t0, tick=state["scrub_ticks"],
                    object=i)

    def backend_back() -> bool:
        """On the card, a client fire that failed is held; once only
        held work is left, the faulted backend (or lost host) comes
        back, as it does when the stream drains."""
        plans = [p for p in (dplan, hplan) if p is not None]
        for plan in plans:
            plan.clear()
        return bool(plans)

    # -- the client stream (with background interleaved) -----------------
    from ..serve.sla import SlaRecorder, SloPolicy
    sla = SlaRecorder(SloPolicy(deadlines=dict(spec.traffic.deadlines)))
    try:
        serving = run_serving_scenario(
            spec.traffic, clock=clock, executor=executor,
            service_model=service_model, device=dev, sla=sla,
            interleave=interleave, on_result=on_result,
            on_stall=backend_back)

        # -- post-stream: drain the storm, heal the device plane,
        # recovery to convergence -------------------------------------
        drained = drain_churn(m, churn)
        if dplan is not None:
            # a persistent (calls=None) fault heals when the stream
            # drains — the window-bounded ones cleared on their own;
            # the health probe then re-promotes within promote_after
            # clean ticks
            dplan.clear()
        if hplan is not None:
            # the lost host "comes back" (or is replaced) once the
            # stream drains: the plan goes quiet and the health probe
            # re-promotes the plane to full host width
            hplan.clear()
        while (not state["converged"]
               and orch.report.rounds < spec.max_recovery_rounds):
            if sup is not None:
                sup.tick()
            if arbiter.admit("recovery"):
                run_recovery_round()
            else:
                clock.sleep(max(arbiter.hold_for("recovery"), _TICK))
        if sup is not None:
            # the backend healed: drive the probe to re-promotion so
            # the run ends on the restored tier (bounded — tick() is
            # a no-op once nothing is demoted)
            for _ in range(sup.promote_after + 1):
                sup.tick()
        if host_plane_activated:
            from ..parallel.plane import host_plane_topology
            topo_end = host_plane_topology()
        elapsed = clock.monotonic() - t_start
    finally:
        if dplan is not None:
            arm_plan(prev_plan)
        if hplan is not None:
            arm_host_plan(prev_hplan)
            sup.set_inflight_reclaim(prev_reclaim)
        if host_plane_activated:
            from ..parallel import plane as planemod
            planemod.set_data_plane(prev_plane)

    # -- gates + report --------------------------------------------------
    rec = orch.report
    ok_objects = [i for i in range(len(stores))
                  if i not in rec.unrecoverable]
    is_healed = healed([stores[i] for i in ok_objects],
                       [originals[i] for i in ok_objects])
    from ..serve.loadgen import verify_results
    bad = verify_results(serving.results)
    placements_after = _sample_placements(m)
    remapped_sample = sum(
        1 for key, up in placements_before.items()
        if placements_after.get(key) != up)

    base_p99 = (float(np.percentile(
        np.asarray(baseline.completion_s), 99))
        if baseline.completion_s else 0.0)
    p99 = (float(np.percentile(np.asarray(sched.completion_s), 99))
           if sched.completion_s else 0.0)
    rateless = {
        "n_units": chaos.damaged_objects,
        "n_shards": n_shards,
        "redundancy": redundancy,
        "p99_s": round(p99, 6),
        "p99_baseline_s": round(base_p99, 6),
        "p99_ratio": (round(p99 / base_p99, 4) if base_p99 > 0
                      else None),
        "straggler_reassignments": sched.straggler_reassignments,
        "cancelled_copies": sched.cancelled_copies,
        "weighted_osds": len(osd_weights),
    }
    churn_summary = {
        "events": len(churn.events),
        "storm_events": state["churn_events"],
        "drained": drained,
        "epochs_advanced": churn.epochs_advanced,
        "kinds": dict(sorted(
            {} if not churn.events else
            _count_kinds(churn.events).items())),
        "remapped_sample": remapped_sample,
        "sampled_pgs": len(placements_before),
    }
    profile = None
    if capture_profile:
        from ..telemetry.profiler import global_profiler
        profile = global_profiler().attribution_rows()
    supervisor_section = None
    if dplan is not None:
        after = sup.stats()
        delta = {k: after[k] - sup_before.get(k, 0)
                 for k in sup_before if isinstance(after.get(k), int)}
        supervisor_section = {
            "fault": {"kind": chaos.dispatch_fault,
                      "seam": chaos.dispatch_fault_seam,
                      "at": chaos.dispatch_fault_at,
                      "calls": chaos.dispatch_fault_calls},
            "counters": {k: v for k, v in sorted(delta.items()) if v},
            "plan": dplan.summary(),
            "demoted_at_end": after["demoted"],
            "tier_floor_at_end": after["tier_floor"],
        }
    host_plane_section = None
    if hplan is not None:
        after = sup.stats()
        delta = {k: after[k] - sup_before.get(k, 0)
                 for k in sup_before if isinstance(after.get(k), int)}
        host_keys = ("host_quarantines", "host_repromotions",
                     "journal_redispatches", "quarantines",
                     "repromotions", "demotions", "promotions",
                     "injected_faults", "dispatch_errors")
        host_plane_section = {
            "fault": {"kind": chaos.host_loss,
                      "host": chaos.host_loss_host,
                      "hosts": chaos.host_loss_hosts,
                      "seam": chaos.host_loss_seam,
                      "at": chaos.host_loss_at,
                      "calls": chaos.host_loss_calls},
            "counters": {k: delta[k] for k in host_keys
                         if delta.get(k)},
            "plan": hplan.summary(),
            "topology_armed": topo_armed,
            "topology_at_end": topo_end,
            "demoted_at_end": after["demoted"],
        }
    report = ScenarioReport(
        name=spec.name, seed=spec.seed, executor=executor,
        arbiter_enabled=arbiter.enabled,
        elapsed_s=round(elapsed, 6), turns=state["turns"],
        scrub_ticks=state["scrub_ticks"],
        recovery_rounds=state["recovery_rounds"],
        slo=serving.report, recovery=rec.to_dict(),
        rateless=rateless, churn=churn_summary,
        qos=arbiter.snapshot(),
        slo_burn_trips=len(sla.monitor.trips),
        gates={
            "converged": rec.converged,
            "healed": is_healed,
            "verified_requests": not bad,
            "bad_requests": len(bad),
            "unrecoverable": list(rec.unrecoverable),
        },
        profile=profile,
        supervisor=supervisor_section,
        host_plane=host_plane_section,
    )
    tel.gauge("scenario_deadline_miss_rate",
              report.slo.get("deadline_miss_rate") or 0.0)
    return ScenarioRun(report=report, serving=serving, recovery=rec,
                       arbiter=arbiter, throttle=throttle, churn=churn,
                       stores=stores, originals=originals)


def _count_kinds(events) -> dict:
    kinds = {}
    for ev in events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    return kinds


def scenario_selftest() -> dict:
    """The composed scenario as a host-tier audit workload: a tiny
    seeded FakeClock day (client stream + churn + recovery + scrub
    under the arbiter) runs end to end on the host executor and must
    set up no kernel and return no device tensor — the composition layer
    stays host bookkeeping by construction (analysis/entrypoints.py
    ``scenario.runner``)."""
    from ..serve.loadgen import throughput_service_model
    from ..utils.retry import FakeClock
    from .spec import default_scenario

    spec = default_scenario(seed=11, n_requests=16, stripe_size=2048,
                            damaged_objects=2, storm_events=2)
    run = run_scenario(spec, clock=FakeClock(), executor="host",
                       service_model=throughput_service_model())
    assert run.report.gates["converged"], run.report.gates
    assert run.report.gates["healed"], run.report.gates
    return run.report.to_dict()


__all__ = ["ScenarioRun", "drain_churn", "drive_storm",
           "run_scenario", "run_serving_scenario", "scenario_selftest",
           "stage_damaged_objects"]
