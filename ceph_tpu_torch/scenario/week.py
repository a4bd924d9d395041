"""The multi-tenant compressed week — discrete-event scenario runner; a
port of ``ceph_tpu/scenario/week.py``.

``run_scenario`` (scenario/runner.py) interleaves ONE client stream
with background work, one loop turn at a time, and advances the clock
in small increments — honest for a production *day*, hopeless for a
week: a 10x-diurnal stream is mostly idle trough, and ticking through
the idle gaps costs wall time proportional to sim time.

This module is the week-scale counterpart:

- **Per-tenant streams**: every :class:`~.spec.TenantSpec` generates
  its own seeded diurnal request stream
  (serve/loadgen.py::LoadGenerator with ``share_payloads`` so a
  million-request week fits in memory); the streams are merged on one
  arrival timeline and every request carries its tenant label
  end-to-end (queue → batcher → SLO ledger → tracing → telemetry).
- **Per-tenant mClock at the door**: each arrival is gated by
  :meth:`~.qos.MClockArbiter.admit_tenant` — a tenant past its limit
  tag is REJECTED (counted as that tenant's own deadline miss,
  ``serve_rejected{tenant,reason="qos_limit"}``), which is exactly
  the noisy-neighbor clamp: the burst storm bills the burster, not
  the victims.  ``enable_arbiter=False`` is the control arm that
  demonstrably fails the isolation gate.
- **Discrete-event fast-forward**: the runner keeps a next-event
  timeline (arrivals, batcher slack deadlines, disaster stage
  arm/fire/heal, scrub ticks, churn epochs) and jumps the idle gaps.
  ``clock_mode="event"`` advances with ONE sleep per gap
  (:class:`~..utils.retry.EventClock` fast-forward);
  ``clock_mode="step"`` ticks through the same gap in fixed quanta,
  polling the batcher at every intermediate tick.  Both modes land on
  the identical decision times, so the report JSON is byte-identical
  — the step/event equivalence is the proof
  that fast-forward skipped *only* idle time.
- **Staged correlated disasters**: the
  :class:`~.spec.DisasterSchedule` composes adversary planes on the
  week's timeline — rack loss at peak, backend-seam loss
  mid-rebalance, host loss, tenant burst storm — each with
  arm/fire/heal phases and a flight-recorder dump per stage.  Every
  loss stage stages real damaged objects and must heal them
  byte-identically (the zero-data-loss gate), with recovery rounds
  admission-gated by the arbiter on the SAME clock the tenants are
  being served on.

Determinism: FakeClock-family clocks only (the week is a sim
construct — the service model charges modeled time).  Two runs of one
spec + seed produce byte-identical report JSON; the dispatch
composition is pinned by a CRC over the batcher's dispatch log.
"""

from __future__ import annotations

import contextlib
import json
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import metrics as tel
from ..telemetry import recorder as flight
from ..telemetry import tracing

# advance floor when the sim clock would otherwise stall (mirrors
# scenario/runner.py)
_TICK = 1e-4


@dataclass
class TenantWeekRun:
    """One compressed week's live artifacts (report is the JSON face)."""

    report: object                  # ScenarioReport
    sla: object                     # SlaRecorder
    arbiter: object                 # MClockArbiter
    batcher: object                 # ContinuousBatcher
    queue: object                   # AdmissionQueue
    clock: object
    stages: List[dict] = field(default_factory=list)
    churn: object = None


def _burst_boost(spec, tenant: str) -> Optional[Callable[[float], float]]:
    """The arrival-rate boost the DisasterSchedule's tenant_burst
    stages impose on ``tenant`` (None = no burst targets it).  The
    burst lives in arrival GENERATION, so the offered load is
    identical across the arbiter-on/off arms — only admission
    differs."""
    wins = [(st.at_s, st.at_s + st.duration_s, st.factor)
            for st in spec.disasters.stages
            if st.kind == "tenant_burst" and st.tenant == tenant]
    if not wins:
        return None

    def boost(t: float) -> float:
        f = 1.0
        for a, b, fac in wins:
            if a <= t < b:
                f *= fac
        return f

    return boost


def week_service_model(spec):
    """The spec's modeled serving capacity (throughput_service_model
    over ``service_gbps``/``service_overhead_s``) — ONE derivation
    shared by the runner, the demo, the bench row and the tests."""
    from ..serve.loadgen import throughput_service_model

    return throughput_service_model(gbps=spec.service_gbps,
                                    overhead_s=spec.service_overhead_s)


@contextlib.contextmanager
def _instruments_on(clock):
    """Point the process-global telemetry instruments (metrics
    registry, flight recorder, span tracer) at the scenario clock for
    the duration of a simulated run, restoring after.  Swapping the
    clock *attribute* — not the instruments themselves — preserves
    counter continuity for tests that read global counters post-run,
    and keeps the run's breadcrumb/series stamps on simulated time so
    a byte-identity rerun stamps identically (and CEPH_TPU_DETCHECK
    sees zero wall-clock trips).  The global dispatch supervisor
    rides along too: its retry backoffs and hang-watch deadlines must
    charge *simulated* time, or every heal round burns real wall time
    and stamps nondeterministic elapsed values."""
    from ..ops.supervisor import global_supervisor
    from ..telemetry import global_metrics
    from ..telemetry.recorder import global_flight_recorder
    from ..telemetry.spans import global_tracer

    insts = (global_metrics(), global_flight_recorder(),
             global_tracer(), global_supervisor())
    saved = [inst.clock for inst in insts]
    for inst in insts:
        inst.clock = clock
    try:
        yield
    finally:
        for inst, prev in zip(insts, saved):
            inst.clock = prev


def run_tenant_week(spec, *, clock=None, executor: str = "device",
                    device=None, service_model=None,
                    enable_arbiter=None,
                    clock_mode: str = "event",
                    clock_step_s: float = 0.05) -> TenantWeekRun:
    """Run ``spec``'s multi-tenant compressed week end to end.

    Requires ``spec.tenants`` (see
    :func:`~.spec.tenant_week_scenario`) and a FakeClock-family clock
    (default: a fresh :class:`~..utils.retry.EventClock`) — the week
    is a simulation; the service model charges modeled dispatch time
    to the shared clock, which is the contention mechanism.

    ``clock_mode="event"`` advances with ONE sleep per gap;
    ``"step"`` ticks through the same gap in ``clock_step_s`` quanta.
    Both produce byte-identical reports — pinned by the equivalence
    test.

    ``executor="device"`` (default) serves and heals on ``device``: the
    card unless the caller passes ``device="cpu"`` (``NoDeviceError``
    without a card).  ``executor="host"`` is the host arm: CPU
    instances pinned to the numpy region ops and a host recovery.

    The whole run executes inside a ``utils.detcheck``
    *injected-clock window* with the global telemetry instruments
    riding the scenario clock: under ``CEPH_TPU_DETCHECK=1`` any
    component falling back to real wall time mid-week is counted and
    flight-recorded as a trip.
    """
    import torch

    from ..ops.fallback import resolve_device
    from ..utils.detcheck import injected_clock
    from ..utils.retry import EventClock

    if executor not in ("device", "host"):
        raise ValueError(f"executor {executor!r} must be device|host")
    dev = (torch.device("cpu") if executor == "host"
           else resolve_device(device))
    if clock is None:
        clock = EventClock()
    if not hasattr(clock, "now"):
        raise ValueError("run_tenant_week is a simulation: it needs "
                         "a FakeClock-family clock (EventClock)")
    with injected_clock(f"tenant_week:{spec.name}"), \
            _instruments_on(clock):
        return _run_week_body(spec, clock=clock, executor=executor,
                              device=dev, service_model=service_model,
                              enable_arbiter=enable_arbiter,
                              clock_mode=clock_mode,
                              clock_step_s=clock_step_s)


def _run_week_body(spec, *, clock, executor, device, service_model,
                   enable_arbiter, clock_mode,
                   clock_step_s) -> TenantWeekRun:
    from ..chaos import ShardErasure
    from ..chaos.adversaries import MapChurn
    from ..chaos.dispatch import DispatchFault, DispatchFaultPlan, \
        arm_plan
    from ..cluster.topology import EC_POOL, build_cluster
    from ..codes.registry import ErasureCodePluginRegistry
    from ..codes.stripe import StripeInfo
    from ..crush.incremental import CEPH_OSD_UP, Incremental, \
        apply_incremental, get_epoch
    from ..crush.osdmap import IN_WEIGHT
    from ..ops.supervisor import global_supervisor
    from ..recovery.journal import IntentJournal
    from ..recovery.orchestrator import RecoveryOrchestrator, healed
    from ..recovery.throttle import OsdRecoveryThrottle
    from ..scrub.deep_scrub import deep_scrub
    from ..serve.batcher import ContinuousBatcher
    from ..serve.loadgen import LoadGenerator
    from ..serve.queue import AdmissionQueue
    from ..serve.sla import SlaRecorder, SloPolicy
    from ..utils.retry import EventClock
    from .qos import MClockArbiter
    from .report import ScenarioReport
    from .runner import drain_churn, stage_damaged_objects

    if not spec.tenants:
        raise ValueError("run_tenant_week needs spec.tenants "
                         "(see tenant_week_scenario)")
    if clock_mode not in ("event", "step"):
        raise ValueError(f"clock_mode {clock_mode!r} must be "
                         f"event|step")
    if service_model is None:
        service_model = week_service_model(spec)
    tracing.maybe_install_from_env(clock=clock, seed=spec.seed)
    if tracing.enabled():
        tracing.active().set_tenant_sample(
            {t.name: t.trace_sample for t in spec.tenants})
    sim = True
    t_start = clock.monotonic()

    # -- cluster + recovery material (mirrors run_scenario) --------------
    m = build_cluster(spec.cluster, device=device)
    codec = spec.codec_for_recovery()
    ec = ErasureCodePluginRegistry.instance().factory(
        codec.plugin, dict(codec.profile), device=device)
    if executor == "host":
        ec.min_xla_bytes = float("inf")
    chunk = ec.get_chunk_size(spec.recovery_stripe)
    k = ec.get_data_chunk_count()
    sinfo = StripeInfo(k, k * chunk)

    # -- tenant streams merged on one arrival timeline -------------------
    merged: List[Tuple[float, int, object]] = []
    deadlines_by_tenant: Dict[str, dict] = {}
    for ti, ten in enumerate(spec.tenants):
        gen = LoadGenerator(ten.traffic, share_payloads=True)
        reqs, offs = gen.generate(boost=_burst_boost(spec, ten.name))
        deadlines_by_tenant[ten.name] = dict(ten.traffic.deadlines)
        for j, (req, off) in enumerate(zip(reqs, offs)):
            merged.append((float(off), ti, req))
    # stable deterministic order: arrival time, then tenant index
    # (requests within one tenant are already time-ordered)
    merged.sort(key=lambda e: (e[0], e[1]))
    n_merged = len(merged)
    # pre-stamp absolute deadlines from the TRUE arrival time: a
    # stepped and a jumped clock must stamp identical deadlines even
    # when the loop catches up late after a big background charge
    for off, ti, req in merged:
        req.deadline = (t_start + off
                        + deadlines_by_tenant[req.tenant][req.op])

    # -- serving plane ---------------------------------------------------
    base_traffic = spec.tenants[0].traffic
    slo = SloPolicy(deadlines=dict(base_traffic.deadlines))
    sla = SlaRecorder(slo)
    queue = AdmissionQueue(clock=clock,
                           capacity=base_traffic.queue_capacity,
                           slo=slo)
    batcher = ContinuousBatcher(clock=clock,
                                ladder=base_traffic.ladder,
                                executor=executor,
                                service_model=service_model,
                                device=device)
    batcher.warmup([req for _, _, req in merged[:256]])

    # -- QoS arbiter: per-(tenant, class) mClock -------------------------
    arbiter = MClockArbiter(spec.qos, clock=clock,
                            enabled=enable_arbiter)
    for ten in spec.tenants:
        arbiter.register_tenant(ten.name, reservation=ten.reservation,
                                weight=ten.weight, limit=ten.limit)
    throttle = OsdRecoveryThrottle(max_inflight=4)
    sup = global_supervisor()
    sup.reset_pacing()
    sup_before = {kk: v for kk, v in sup.stats().items()
                  if isinstance(v, int)}

    # -- background material ---------------------------------------------
    # a small standing set of PRISTINE objects the scrub cadence
    # cycles over (scrub must find nothing; damage arrives via stages)
    scrub_orig, scrub_stores, scrub_hinfos, _ = stage_damaged_objects(
        sinfo, ec, 2, seed=spec.seed + 77,
        injectors_for=lambda i: [])
    churn = MapChurn(seed=spec.seed + 202, max_down=2, fire_every=1,
                     max_events=1 << 30)

    # -- the staged-disaster machine -------------------------------------
    cl = spec.cluster
    oph, hpr = cl.osds_per_host, cl.hosts_per_rack

    def _stage_osds(st) -> List[int]:
        if st.kind == "rack_loss":
            per_rack = hpr * oph
            return list(range(st.rack * per_rack,
                              (st.rack + 1) * per_rack))
        if st.kind == "host_loss":
            return list(range(st.host * oph, (st.host + 1) * oph))
        return []

    stages_state: List[dict] = []
    stage_events: List[Tuple[float, int, int]] = []
    for i, st in enumerate(spec.disasters.stages):
        stages_state.append({
            "kind": st.kind, "at_s": st.at_s,
            "duration_s": st.duration_s, "armed_at": None,
            "fired_at": None, "healed_at": None, "objects": 0,
            "recovery_rounds": 0, "converged": True, "healed": True,
            "osds_downed": 0, "fence_deferrals": 0, "dumped": False})
        stage_events.append((max(st.at_s - st.arm_lead_s, 0.0), i, 0))
        stage_events.append((st.at_s, i, 1))
        stage_events.append((st.at_s + st.duration_s, i, 2))
    stage_events.sort()
    stage_ctx: Dict[int, dict] = {}
    state = {"turns": 0, "recovery_rounds": 0, "scrub_ticks": 0,
             "scrub_idx": 0, "churn_events": 0, "bad": 0}

    def _verify(res) -> bool:
        exp = res.request.expect
        if exp is None:
            return True
        if res.request.op == "repair":
            rec, parity = res.output
            return (np.array_equal(rec, exp[0])
                    and np.array_equal(parity, exp[1]))
        return bool(np.array_equal(res.output, exp))

    def _absorb(batch) -> None:
        # results are verified and dropped, never retained: a
        # million-request week must not hold a million EcResults
        for res in batch:
            sla.record(res)
            arbiter.record_client(res.deadline_met)
            if not _verify(res):
                state["bad"] += 1
        if batch:
            throttle.set_scale(arbiter.background_scale())

    def _admit(entry) -> None:
        off, ti, req = entry
        if arbiter.admit_tenant(req.tenant, clock.monotonic()):
            if queue.submit(req):
                # restore the TRUE arrival stamp: latency is measured
                # from when the request arrived, not from when the
                # loop caught up to it
                req.arrival = t_start + off
            else:
                sla.record_reject(req, "capacity")
        else:
            tel.counter("serve_rejected", op=req.op,
                        tenant=req.tenant, reason="qos_limit")
            sla.record_reject(req, "qos_limit")

    def _pump() -> None:
        # serving continues while a disaster stage recovers: every
        # clock charge inside the recovery loop is followed by an
        # arrival drain + batcher poll, so recovery contends with the
        # tenants through the arbiter, not by wedging the event loop
        nonlocal i
        now = clock.monotonic()
        while i < n_merged and arr_t[i] <= now:
            _admit(merged[i])
            i += 1
        _absorb(batcher.poll(queue))

    def _charge(dur: float) -> None:
        # charge `dur` of modeled background time (a recovery round,
        # an admission hold, a scrub tick) WHILE serving: the sleep is
        # sliced at arrival times and batcher wakeups with a pump at
        # every slice, so background work contends for capacity
        # without ever wedging the serving plane for its whole length
        end = clock.monotonic() + dur
        while True:
            now = clock.monotonic()
            rem = end - now
            if rem <= 0:
                break
            step = rem
            if i < n_merged and arr_t[i] > now:
                step = min(step, arr_t[i] - now)
            wake = batcher.next_wakeup()
            if wake is not None and wake > now:
                step = min(step, wake - now)
            clock.sleep(max(step, _TICK))
            _pump()
        clock.now = float(end)

    def _recover_stage(si: int, st, ctx: dict,
                       budget: Optional[int] = None) -> None:
        """Drive the stage's recovery at the arbiter's pace.

        Called TWICE per loss stage on the same orchestrator: at fire
        with a small ``budget`` — mid-loss degraded recovery, where a
        whole-rack loss legitimately fence-defers write-backs whose
        CRUSH slots are unplaceable (counted, on the record) — and at
        heal with no budget, after the OSDs revive, where it must
        converge.  For backend_loss the dispatch-fault plan is still
        armed, so heal rounds ride the supervisor's retry ladder
        through the stage's seam."""
        ss = stages_state[si]
        orch = ctx.get("orch")
        if orch is None:
            orch = RecoveryOrchestrator(
                sinfo, ec, m, EC_POOL, spec.recovery_ps,
                ctx["stores"], ctx["hinfos"], journal=IntentJournal(),
                throttle=throttle, clock=clock,
                device=(False if executor == "host" else None),
                max_rounds=spec.max_recovery_rounds)
            ctx["orch"] = orch

        def one_round() -> int:
            return orch.run_round()

        done = 0
        while (not orch.report.converged
               and orch.report.rounds < spec.max_recovery_rounds
               and (budget is None or done < budget)):
            if arbiter.admit("recovery"):
                if ctx.get("dplan") is not None:
                    nops = sup.dispatch(st.seam, one_round, (),
                                        host_fn=one_round,
                                        splittable=False,
                                        verifiable=False)
                else:
                    nops = one_round()
                done += 1
                ss["recovery_rounds"] += 1
                state["recovery_rounds"] += 1
                if sim and nops:
                    _charge(spec.recovery_round_s)
            else:
                _charge(max(arbiter.hold_for("recovery"), _TICK))
        ss["fence_deferrals"] = orch.report.fence_deferrals
        if budget is None:
            ss["converged"] = bool(orch.report.converged
                                   and not orch.report.unrecoverable)
            ss["healed"] = bool(ss["converged"] and healed(
                ctx["stores"], ctx["originals"]))

    def _stage_phase(si: int, phase: int) -> None:
        st = spec.disasters.stages[si]
        ss = stages_state[si]
        now = clock.monotonic()
        if phase == 0:                                   # arm
            ss["armed_at"] = round(now - t_start, 6)
            flight.note("disaster_arm", stage=si, disaster=st.kind)
            tel.counter("week_disaster_phase", kind=st.kind,
                        phase="arm")
            return
        if phase == 1:                                   # fire
            ss["fired_at"] = round(now - t_start, 6)
            ctx = stage_ctx.setdefault(si, {})
            osds = _stage_osds(st)
            if osds:
                inc = Incremental(
                    epoch=get_epoch(m) + 1,
                    new_state={o: CEPH_OSD_UP for o in osds},
                    new_weight={o: 0 for o in osds})
                apply_incremental(m, inc)
                ctx["osds"] = osds
                ss["osds_downed"] = len(osds)
            if st.kind in ("rack_loss", "host_loss", "backend_loss"):
                orig, stores, hinfos, _faults = stage_damaged_objects(
                    sinfo, ec, st.objects,
                    seed=spec.seed + 9000 + si,
                    injectors_for=lambda i: [ShardErasure(n=1)])
                ctx.update(originals=orig, stores=stores,
                           hinfos=hinfos)
                ss["objects"] = st.objects
                ss["converged"] = ss["healed"] = False
            if st.kind == "backend_loss":
                dplan = DispatchFaultPlan(
                    [DispatchFault("transient", seam=st.seam, at=1,
                                   calls=2)],
                    seed=spec.seed + 404 + si)
                ctx["dplan"] = dplan
                ctx["prev_plan"] = arm_plan(dplan)
            dump = flight.trip(f"disaster_{st.kind}",
                               reason=f"stage {si} fired", stage=si)
            ss["dumped"] = dump is not None
            tel.counter("week_disaster_phase", kind=st.kind,
                        phase="fire")
            if ctx.get("stores") is not None:
                # mid-loss degraded recovery: a few rounds NOW, with
                # the OSDs down — unplaceable slots fence-defer and
                # that cost is recorded, not hidden
                _recover_stage(si, st, ctx, budget=4)
            return
        # phase == 2: heal — revive the lost OSDs first (the rack /
        # host came back), THEN recovery must converge and the stores
        # must match the originals byte-identically
        ctx = stage_ctx.get(si, {})
        if ctx.get("osds"):
            inc = Incremental(
                epoch=get_epoch(m) + 1,
                new_state={o: CEPH_OSD_UP for o in ctx["osds"]},
                new_weight={o: IN_WEIGHT for o in ctx["osds"]})
            apply_incremental(m, inc)
            ctx["osds"] = None
        if ctx.get("stores") is not None:
            _recover_stage(si, st, ctx)
        if ctx.get("dplan") is not None:
            ctx["dplan"].clear()
            arm_plan(ctx.get("prev_plan"))
            ctx["dplan"] = None
        ss["healed_at"] = round(clock.monotonic() - t_start, 6)
        flight.note("disaster_heal", stage=si, disaster=st.kind,
                    healed=ss["healed"])
        tel.counter("week_disaster_phase", kind=st.kind, phase="heal")

    # -- the discrete-event main loop ------------------------------------
    arr_t = [t_start + off for off, _, _ in merged]
    i = 0
    sp = 0
    scrub_every = spec.week_scrub_every_s
    churn_every = spec.week_churn_every_s
    next_scrub = t_start + scrub_every if scrub_every else None
    next_churn = t_start + churn_every if churn_every else None
    is_event_clock = isinstance(clock, EventClock)

    def _advance(target: float) -> None:
        now = clock.monotonic()
        if target <= now:
            clock.sleep(_TICK)
            return
        if clock_mode == "event":
            if is_event_clock:
                clock.advance_to(target)
            else:
                clock.sleep(target - now)
                clock.now = float(target)
            return
        # step mode: tick through the gap, polling at every
        # intermediate quantum — the proof harness that fast-forward
        # skipped only idle time (any fire here breaks equivalence)
        while True:
            now = clock.monotonic()
            rem = target - now
            if rem <= 0:
                break
            if rem <= clock_step_s:
                clock.sleep(rem)
                break
            clock.sleep(clock_step_s)
            _absorb(batcher.poll(queue))
        clock.now = float(target)

    while (i < n_merged or batcher.pending() or len(queue)
           or sp < len(stage_events)):
        state["turns"] += 1
        now = clock.monotonic()
        while i < n_merged and arr_t[i] <= now:
            _admit(merged[i])
            i += 1
        while sp < len(stage_events) and stage_events[sp][0] <= (
                clock.monotonic() - t_start):
            _, si, phase = stage_events[sp]
            sp += 1
            _stage_phase(si, phase)
        now = clock.monotonic()
        serving_live = i < n_merged or batcher.pending() or len(queue)
        if next_scrub is not None:
            while next_scrub <= now and serving_live:
                if arbiter.admit("scrub"):
                    j = state["scrub_idx"] % len(scrub_stores)
                    state["scrub_idx"] += 1
                    deep_scrub(sinfo, ec, scrub_stores[j],
                               scrub_hinfos[j], clock=clock)
                    state["scrub_ticks"] += 1
                    if sim:
                        _charge(spec.scrub_tick_s)
                next_scrub += scrub_every
        if next_churn is not None:
            while next_churn <= now and serving_live:
                if arbiter.admit("rebalance"):
                    if churn.step(m, stage="week") is not None:
                        state["churn_events"] += 1
                        if sim:
                            _charge(spec.churn_step_s)
                next_churn += churn_every
        fired = batcher.poll(queue)
        if fired:
            _absorb(fired)
            continue
        cands = []
        if i < n_merged:
            cands.append(arr_t[i])
        if sp < len(stage_events):
            cands.append(t_start + stage_events[sp][0])
        wake = batcher.next_wakeup()
        if wake is not None:
            cands.append(wake)
        serving_live = i < n_merged or batcher.pending() or len(queue)
        if serving_live:
            if next_scrub is not None:
                cands.append(next_scrub)
            if next_churn is not None:
                cands.append(next_churn)
        if not cands:
            if batcher.pending():
                _absorb(batcher.flush())
                continue
            break
        _advance(min(cands))
    _absorb(batcher.flush())
    drained = drain_churn(m, churn)
    elapsed = clock.monotonic() - t_start

    # -- report ----------------------------------------------------------
    comp = [(d["bucket"], d["op"], d["occupancy"], d["rung"])
            for d in batcher.dispatch_log]
    dispatch_crc = zlib.crc32(
        json.dumps(comp).encode("utf-8")) & 0xFFFFFFFF
    sup_after = sup.stats()
    sup_delta = {kk: sup_after[kk] - sup_before.get(kk, 0)
                 for kk in sup_before
                 if isinstance(sup_after.get(kk), int)
                 and sup_after[kk] != sup_before.get(kk, 0)}
    slo_report = sla.report(elapsed,
                            padding=batcher.padding_stats())
    all_converged = all(s["converged"] for s in stages_state)
    all_healed = all(s["healed"] for s in stages_state)
    report = ScenarioReport(
        name=spec.name, seed=spec.seed, executor=executor,
        arbiter_enabled=arbiter.enabled,
        elapsed_s=round(elapsed, 6), turns=state["turns"],
        recovery_rounds=state["recovery_rounds"],
        scrub_ticks=state["scrub_ticks"],
        slo=slo_report,
        recovery={"rounds": state["recovery_rounds"],
                  "converged": all_converged,
                  "supervisor": dict(sorted(sup_delta.items()))},
        rateless={},
        churn={"events": state["churn_events"], "drained": drained,
               "epochs_advanced": churn.epochs_advanced},
        qos=arbiter.snapshot(),
        slo_burn_trips=len(sla.monitor.trips),
        gates={
            "converged": all_converged,
            "healed": all_healed,
            "verified_requests": state["bad"] == 0,
            "bad_requests": state["bad"],
            "unrecoverable": [],
            "dispatch_crc": int(dispatch_crc),
            "dispatched": len(batcher.dispatch_log),
            "requests_offered": n_merged,
        },
        tenants=slo_report.get("tenants", {}),
        disasters=[dict(s) for s in stages_state],
    )
    tel.gauge("scenario_deadline_miss_rate",
              report.slo.get("deadline_miss_rate") or 0.0)
    return TenantWeekRun(report=report, sla=sla, arbiter=arbiter,
                         batcher=batcher, queue=queue, clock=clock,
                         stages=stages_state, churn=churn)


def isolated_baseline(spec, tenant: str, *, executor: str = "device",
                      device=None, clock_mode: str = "event"):
    """The per-tenant isolated baseline the isolation gate compares
    against: the SAME tenant stream, alone on the plane, no
    disasters, arbiter on — its scorecard is what the tenant's SLO
    looks like when nobody else is misbehaving."""
    from dataclasses import replace

    from .spec import DisasterSchedule

    ten = next(t for t in spec.tenants if t.name == tenant)
    solo = replace(spec, tenants=(ten,),
                   disasters=DisasterSchedule(),
                   name=f"{spec.name}-baseline-{tenant}")
    run = run_tenant_week(solo, executor=executor, device=device,
                          clock_mode=clock_mode)
    return run.report.tenants[tenant]


def isolation_gate(report, baselines: Dict[str, dict],
                   victims: Tuple[str, ...] = ("alpha", "bravo"),
                   p99_factor: float = 1.5,
                   miss_factor: float = 2.0,
                   miss_floor: float = 0.025) -> dict:
    """The pinned noisy-neighbor gate: every victim tenant's p99 and
    deadline-miss rate under the full week (burst storm included)
    must stay within fixed factors of its isolated baseline.

    ``miss_floor`` is the additive epsilon on the miss-rate bound: a
    baseline miss rate of exactly 0 would otherwise make ANY miss a
    failure, which measures luck, not isolation."""
    tenants = getattr(report, "tenants", None)
    if tenants is None:           # a report dict or the bare tenants map
        tenants = report.get("tenants", report)
    out = {"ok": True, "victims": {}}
    for name in victims:
        t = tenants.get(name, {})
        b = baselines[name]
        p99 = t.get("p99_ms")
        b_p99 = b.get("p99_ms")
        miss = t.get("deadline_miss_rate", 0.0) or 0.0
        b_miss = b.get("deadline_miss_rate", 0.0) or 0.0
        p99_ok = (p99 is not None and b_p99 is not None
                  and p99 <= p99_factor * b_p99)
        miss_ok = miss <= miss_factor * b_miss + miss_floor
        out["victims"][name] = {
            "p99_ms": p99, "baseline_p99_ms": b_p99,
            "p99_ok": bool(p99_ok),
            "miss_rate": miss, "baseline_miss_rate": b_miss,
            "miss_ok": bool(miss_ok),
        }
        out["ok"] = out["ok"] and bool(p99_ok and miss_ok)
    return out


def week_selftest() -> dict:
    """The ``scenario.week`` host-tier audit workload: a miniature
    2-day 3-tenant week (diurnal curves, all four disaster kinds,
    per-tenant mClock) runs end to end on an EventClock and must
    set up no kernel — the week layer is host bookkeeping by
    construction (analysis/entrypoints.py)."""
    from .spec import tenant_week_scenario

    spec = tenant_week_scenario(seed=17, days=2, day_s=6.0,
                                peak_rates=(40.0, 30.0, 20.0),
                                burst_factor=6.0)
    run = run_tenant_week(spec, executor="host")
    rep = run.report
    assert rep.gates["converged"], rep.gates
    assert rep.gates["healed"], rep.gates
    assert rep.gates["verified_requests"], rep.gates
    assert set(rep.tenants) == {"alpha", "bravo", "noisy"}, \
        sorted(rep.tenants)
    return rep.to_dict()


__all__ = ["TenantWeekRun", "isolated_baseline", "isolation_gate",
           "run_tenant_week", "week_selftest", "week_service_model"]
