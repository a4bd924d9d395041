"""Epoch-aware recovery orchestrator — crash-consistent repair under
OSDMap churn.

A copy of ``ceph_tpu/recovery/orchestrator.py``.

Reference: the peering/recovery machinery the scrub and EC layers have
so far only assumed (src/osd/PeeringState.cc, ECBackend's RecoveryOp
state machine, the PG log): recovery ops are epoch-stamped, every
interval change re-plans them against the new map, and writes are
journaled so a crash mid-repair resumes instead of corrupting.  This
module is that discipline over the framework's pure-math pipeline:

- every damaged object becomes an epoch-stamped ``RecoveryOp``
  ``(pg/object, erased set, target placement, epoch)``;
- decode dispatch rides ``scrub.repair_batched`` (one fused device
  call per erasure-pattern batch) with its epoch-fenced regrouping —
  a map that moves between plan and dispatch re-scrubs and re-groups
  instead of dispatching stale batches;
- before write-back the epoch is re-checked AGAIN
  (crush/incremental.get_epoch): a stale op re-plans its placement
  against the current map (counted in ``replans``), and the fence
  refuses to write any shard whose target OSD is down/out or
  unplaceable (deferred to the next round, never written blind);
- write-back runs through the write-ahead ``IntentJournal``
  (intent → write → verify → commit → clear), so an ``InjectedCrash``
  at ANY named crash site (chaos.CRASH_SITES) resumes idempotently:
  replay keeps completed writes, rolls back torn ones, and a re-run
  of recovery is a no-op once converged;
- per-OSD write admissions are bounded by ``OsdRecoveryThrottle`` and
  reads carry deadline-aware retries (utils/retry.py) — an op never
  retries past its deadline (expired ops are reported, not retried).

``recover_to_completion`` is the crash/resume harness: it owns the
journal, catches InjectedCrash, and re-instantiates the orchestrator
(the "restarted daemon") until recovery converges — only what the
journal + stores + osdmap carry survives each crash, by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..chaos.store import ensure_store
from ..crush.incremental import get_epoch
from ..crush.types import CRUSH_ITEM_NONE
from ..scrub.deep_scrub import deep_scrub, repair_batched, \
    unrecoverable_extents
from ..telemetry import metrics as tel
from ..telemetry import tracing
from ..telemetry.spans import global_tracer
from ..utils.detcheck import default_clock
from ..utils.errors import InjectedCrash
from ..utils.log import dout
from ..utils.retry import RetryPolicy, SystemClock
from .journal import IntentJournal, ReplayStats, payload_digest
from .throttle import OsdRecoveryThrottle


@dataclass
class RecoveryOp:
    """One epoch-stamped recovery op: rebuild ``erased`` shards of
    object ``obj`` and land them on ``placement``'s slots, planned at
    map epoch ``epoch``."""

    op_id: int
    obj: int
    erased: Tuple[int, ...]
    available: Tuple[int, ...]
    shard_length: int
    epoch: int
    placement: Tuple[int, ...]      # slot -> osd (acting at `epoch`)
    deadline: Optional[float] = None


@dataclass
class WriteRecord:
    """One shard write-back that actually landed (the fence proof:
    tests assert no record's osd was down/out at its epoch)."""

    op_id: int
    obj: int
    shard: int
    osd: int
    epoch: int


@dataclass
class RecoveryReport:
    """The orchestrator's full accounting — every counter a
    correctness claim leans on (re-plans prove the fence ran, journal
    stats prove replay did its job, deferrals prove the throttle
    held)."""

    epoch_start: int = 0
    epoch_end: int = 0
    rounds: int = 0
    objects: int = 0
    ops_planned: int = 0
    ops_completed: int = 0
    replans: int = 0              # stale-epoch re-plans at write-back
    regroups: int = 0             # stale-epoch regroups at dispatch
    fence_deferrals: int = 0      # target down/out/unplaceable
    throttle_deferrals: int = 0
    decode_deferrals: int = 0     # decode round disagreed with plan
    torn_rewrites: int = 0        # torn writes caught + rewritten live
    pattern_batches: int = 0
    device_calls: int = 0
    host_batches: int = 0
    crashes: int = 0              # InjectedCrash survived (harness)
    journal_replays: int = 0
    journal: ReplayStats = field(default_factory=ReplayStats)
    writes: List[WriteRecord] = field(default_factory=list)
    expired: List[int] = field(default_factory=list)        # obj ids
    unrecoverable: List[int] = field(default_factory=list)  # obj ids
    converged: bool = False

    def merge_from(self, other: "RecoveryReport") -> None:
        """Fold a crashed run's partial report into this one (the
        resume harness accumulates across restarts)."""
        for f in ("rounds", "ops_planned", "ops_completed", "replans",
                  "regroups", "fence_deferrals", "throttle_deferrals",
                  "decode_deferrals", "torn_rewrites",
                  "pattern_batches", "device_calls", "host_batches",
                  "crashes", "journal_replays"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.journal.merge(other.journal)
        self.writes.extend(other.writes)
        self.expired = sorted(set(self.expired) | set(other.expired))
        self.unrecoverable = sorted(
            set(self.unrecoverable) | set(other.unrecoverable))
        self.objects = max(self.objects, other.objects)
        self.epoch_end = other.epoch_end
        self.converged = other.converged

    def to_dict(self) -> dict:
        return {
            "epoch_start": self.epoch_start,
            "epoch_end": self.epoch_end,
            "rounds": self.rounds,
            "objects": self.objects,
            "ops_planned": self.ops_planned,
            "ops_completed": self.ops_completed,
            "replans": self.replans,
            "regroups": self.regroups,
            "fence_deferrals": self.fence_deferrals,
            "throttle_deferrals": self.throttle_deferrals,
            "decode_deferrals": self.decode_deferrals,
            "torn_rewrites": self.torn_rewrites,
            "pattern_batches": self.pattern_batches,
            "device_calls": self.device_calls,
            "host_batches": self.host_batches,
            "crashes": self.crashes,
            "journal": {
                "replays": self.journal_replays,
                "completed": self.journal.completed,
                "rolled_back": self.journal.rolled_back,
                "shards_kept": self.journal.shards_kept,
                "shards_deleted": self.journal.shards_deleted,
            },
            "writes": len(self.writes),
            "expired": list(self.expired),
            "unrecoverable": list(self.unrecoverable),
            "converged": self.converged,
        }


class RecoveryOrchestrator:
    """Drive scrub findings to durable repair for ONE pg's objects.

    One instance models one daemon lifetime: ``run()`` replays the
    journal (crash recovery), then loops plan → decode → write-back
    rounds until nothing actionable remains.  All the durable state —
    ``journal``, ``stores``, ``osdmap`` — is owned by the caller so a
    crash/restart (``recover_to_completion``) hands it to a fresh
    instance, exactly like an OSD restarting against its disk and the
    mon's current map."""

    def __init__(self, sinfo, ec, osdmap, pool_id: int, ps: int,
                 stores, hinfos, *,
                 journal: Optional[IntentJournal] = None,
                 throttle: Optional[OsdRecoveryThrottle] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 clock=None,
                 crashpoint=None,
                 churn=None,
                 device: Optional[bool] = None,
                 op_deadline: Optional[float] = None,
                 round_delay: float = 0.0,
                 max_rounds: int = 12) -> None:
        self.sinfo = sinfo
        self.ec = ec
        self.osdmap = osdmap
        self.pool_id = pool_id
        self.ps = ps
        self.stores = [ensure_store(s, chunk_size=sinfo.chunk_size)
                       for s in stores]
        self.hinfos = list(hinfos)
        if len(self.stores) != len(self.hinfos):
            raise ValueError(f"{len(self.stores)} stores != "
                             f"{len(self.hinfos)} HashInfos")
        self.journal = journal if journal is not None else IntentJournal()
        self.throttle = throttle or OsdRecoveryThrottle()
        self.retry_policy = retry_policy or RetryPolicy()
        self.clock = clock if clock is not None \
            else default_clock(
                "recovery.orchestrator.RecoveryOrchestrator",
                SystemClock)
        self.crashpoint = crashpoint
        self.churn = churn
        self.device = device
        self.op_deadline = op_deadline
        self.round_delay = round_delay
        self.max_rounds = max_rounds
        self.n = ec.get_chunk_count()
        self.k = ec.get_data_chunk_count()
        self.report = RecoveryReport(objects=len(self.stores))
        self._obj_deadline: Dict[int, float] = {}
        self._unrecoverable: set = set()
        self._expired: set = set()
        # first time each damaged object was planned (telemetry: the
        # end-to-end recovery latency histogram measures from here to
        # journal clear, throttle/fence deferral rounds included)
        self._obj_first_planned: Dict[int, float] = {}
        # journal replay runs once per daemon lifetime, on the first
        # round (run() or an incremental run_round() caller alike)
        self._replayed = False

    # -- adversary hooks -------------------------------------------------

    def _crash(self, site: str) -> None:
        if self.crashpoint is not None:
            self.crashpoint.visit(site)

    def _churn(self, stage: str) -> None:
        if self.churn is not None:
            self.churn.step(self.osdmap, stage)

    def _batch_hook(self, batch_index: int, key) -> None:
        # the documented interleave point inside repair_batched: churn
        # may advance the map here (repair_batched's own epoch fence
        # then regroups) and a CrashPoint may kill the "process"
        self._churn("dispatch")
        self._crash("dispatch.before_decode")

    # -- stage 1: plan ---------------------------------------------------

    def _acting(self) -> Tuple[int, ...]:
        _, _, acting, _ = self.osdmap.pg_to_up_acting_osds(
            self.pool_id, self.ps)
        acting = [int(o) for o in acting]
        acting += [CRUSH_ITEM_NONE] * (self.n - len(acting))
        return tuple(acting[:self.n])

    def _plan(self) -> List[RecoveryOp]:
        """Scrub every object; damaged + feasible + unexpired ones
        become epoch-stamped ops against the CURRENT acting set."""
        epoch = get_epoch(self.osdmap)
        acting = self._acting()
        now = self.clock.monotonic()
        ops: List[RecoveryOp] = []
        for i in range(len(self.stores)):
            if i in self._unrecoverable or i in self._expired:
                continue
            rep = deep_scrub(self.sinfo, self.ec, self.stores[i],
                             self.hinfos[i],
                             retry_policy=self.retry_policy,
                             clock=self.clock)
            if rep.is_clean:
                continue
            n_stripes = rep.shard_length // self.sinfo.chunk_size
            feasible = len(rep.clean) >= self.k
            if feasible:
                try:
                    self.ec.minimum_to_decode(set(rep.bad),
                                              set(rep.clean))
                except (IOError, ValueError):
                    feasible = False
            if not feasible:
                self._unrecoverable.add(i)
                self.report.unrecoverable = sorted(self._unrecoverable)
                dout("ec", 1, f"recovery: object {i} unrecoverable "
                              f"(bad={rep.bad}); extents "
                              f"{unrecoverable_extents(self.sinfo, self.ec, rep.bad, n_stripes)}")
                continue
            if self.op_deadline is not None:
                dl = self._obj_deadline.setdefault(
                    i, now + self.op_deadline)
                if now > dl:
                    self._expired.add(i)
                    self.report.expired = sorted(self._expired)
                    continue
                deadline = dl
            else:
                deadline = None
            self._obj_first_planned.setdefault(i, now)
            ops.append(RecoveryOp(
                op_id=self.journal.allocate_op_id(), obj=i,
                erased=tuple(rep.bad), available=tuple(rep.clean),
                shard_length=rep.shard_length, epoch=epoch,
                placement=acting, deadline=deadline))
        self.report.ops_planned += len(ops)
        tel.counter("recovery_ops_planned", len(ops))
        return ops

    # -- stage 2: decode (batched, epoch-fenced by repair_batched) -------

    def _decode(self, ops: Sequence[RecoveryOp]) -> Dict[int, Dict[int, bytes]]:
        """One repair_batched pass over the ops' objects (write-back
        OFF — durable writes only ever go through the journal).
        Returns obj -> {shard: verified payload bytes}."""
        objs = sorted({op.obj for op in ops})
        if not objs:
            return {}
        batch = repair_batched(
            self.sinfo, self.ec,
            [self.stores[i] for i in objs],
            [self.hinfos[i] for i in objs],
            retry_policy=self.retry_policy, clock=self.clock,
            write_back=False, device=self.device,
            osdmap=self.osdmap, on_batch=self._batch_hook)
        self.report.pattern_batches += batch.pattern_batches
        self.report.device_calls += batch.device_calls
        self.report.host_batches += batch.host_batches
        self.report.regroups += batch.regroups
        if batch.regroups:
            tel.counter("recovery_regroups", batch.regroups)
        return {obj: dict(batch.reports[t].repaired)
                for t, obj in enumerate(objs)}

    # -- stage 3: write-back (epoch fence + throttle + journal) ----------

    def _writeback(self, ops: Sequence[RecoveryOp],
                   payloads: Dict[int, Dict[int, bytes]]) -> None:
        r = self.report
        for op in sorted(ops, key=lambda o: o.op_id):
            self._churn("writeback")
            now = self.clock.monotonic()
            if op.deadline is not None and now > op.deadline:
                self._expired.add(op.obj)
                r.expired = sorted(self._expired)
                continue
            cur = get_epoch(self.osdmap)
            if cur != op.epoch:
                # the map moved since this op was planned: re-plan the
                # placement against the CURRENT map — never write to
                # where the old epoch said the shards live
                op.placement = self._acting()
                op.epoch = cur
                r.replans += 1
                tel.counter("recovery_replans")
            payload = payloads.get(op.obj)
            if payload is None or set(payload) != set(op.erased):
                # the decode round's (regrouped) classification no
                # longer matches this op — replan next round
                r.decode_deferrals += 1
                continue
            targets = {s: op.placement[s] for s in op.erased}
            fenced = [s for s, o in targets.items()
                      if o == CRUSH_ITEM_NONE
                      or not self.osdmap.is_up(o)
                      or self.osdmap.is_out(o)]
            if fenced:
                r.fence_deferrals += 1
                tel.counter("recovery_fence_deferrals")
                dout("ec", 5, f"recovery: op {op.op_id} fenced — "
                              f"shards {fenced} target down/out/"
                              f"unplaceable osds at epoch {cur}")
                continue
            if not self.throttle.admit(targets.values()):
                r.throttle_deferrals += 1
                continue
            store = self.stores[op.obj]
            self.journal.begin(op.op_id, op.obj, cur, payload, targets)
            self._crash("writeback.after_intent")
            for s in sorted(op.erased):
                store.write(s, payload[s])
                r.writes.append(WriteRecord(op.op_id, op.obj, s,
                                            targets[s], cur))
                self._crash("writeback.after_write")
            if not self._verify_landed(op, payload, store):
                continue
            self._crash("writeback.before_commit")
            self.journal.commit(op.op_id)
            self._crash("writeback.after_commit")
            self.journal.clear(op.op_id)
            r.ops_completed += 1
            tel.counter("recovery_ops_completed")
            # end-to-end op latency: first plan of this object →
            # durable clear, every deferral/throttle/journal wait in
            # between included (self.clock, so FakeClock tests pin it)
            started = self._obj_first_planned.pop(
                op.obj, self.clock.monotonic())
            tel.observe("recovery_op_seconds",
                        self.clock.monotonic() - started)

    def _verify_landed(self, op: RecoveryOp,
                       payload: Dict[int, bytes], store) -> bool:
        """The fsync-point read-back: every written shard must match
        the FULL intended payload (a torn write fails here even though
        its prefix bytes are 'valid data').  Torn shards are rewritten
        (the arm is consumed) up to the retry budget; persistent tears
        roll the op back and defer it."""
        r = self.report
        for s in sorted(op.erased):
            want = payload_digest(payload[s])
            tries = 0
            while not self.journal._shard_matches(store, s, want):
                if tries >= self.retry_policy.attempts:
                    self.journal.rollback(op.op_id, store)
                    dout("ec", 1, f"recovery: op {op.op_id} shard {s} "
                                  f"torn write persists; rolled back")
                    return False
                tries += 1
                r.torn_rewrites += 1
                store.write(s, payload[s])
        return True

    # -- the round loop --------------------------------------------------

    def run_round(self) -> int:
        """One recovery round, callable incrementally: journal replay
        on the first call (the daemon's crash-recovery step), then one
        plan → decode → write-back pass.  Returns the number of ops
        the plan produced — 0 means nothing actionable remained and
        the report is marked ``converged``; a non-zero return with
        ``rounds`` already at ``max_rounds`` means the budget is
        spent (the round was NOT executed).

        ``run()`` loops this to convergence; a composed scenario
        (scenario/runner.py) calls it one round at a time under QoS
        arbitration, interleaved with client traffic on the same
        clock."""
        r = self.report
        tracer = global_tracer()
        if not self._replayed:
            r.epoch_start = get_epoch(self.osdmap)
            with tracer.span("journal_replay"):
                stats = self.journal.replay(self.stores)
            r.journal_replays += 1
            tel.counter("recovery_journal_replays")
            r.journal.merge(stats)
            self._replayed = True
        self._churn("plan")
        with tracer.span("plan"):
            ops = self._plan()
        self._crash("plan.after_scrub")
        r.epoch_end = get_epoch(self.osdmap)
        if not ops:
            r.converged = True
            return 0
        if r.rounds >= self.max_rounds:
            return len(ops)
        r.rounds += 1
        # causal trace: each executed recovery round is a
        # background trace naming the objects it touched, so a client
        # tail sample's arbiter_hold joins back to the exact round —
        # and its objects — that charged the shared clock
        rtrace = None
        if tracing.enabled():
            rtrace = tracing.active().begin(
                "recovery", op="repair",
                plugin=type(self.ec).__name__)
            if rtrace is not None:
                rtrace.add("round_start", self.clock.monotonic(),
                           round=r.rounds,
                           epoch=get_epoch(self.osdmap),
                           objects=sorted({op.obj for op in ops}),
                           ops=len(ops))
        completed_before = r.ops_completed
        with tracer.span("round", round=r.rounds):
            with tracer.span("decode", ops=len(ops)):
                payloads = self._decode(ops)
            self.throttle.reset_round()
            with tracer.span("writeback", ops=len(ops)):
                self._writeback(ops, payloads)
        r.epoch_end = get_epoch(self.osdmap)
        if self.round_delay:
            self.clock.sleep(self.round_delay)
        if rtrace is not None:
            rtrace.add("round_end", self.clock.monotonic(),
                       completed=r.ops_completed - completed_before,
                       replans=r.replans, regroups=r.regroups,
                       fence_deferrals=r.fence_deferrals)
        return len(ops)

    def run(self) -> RecoveryReport:
        """One daemon lifetime: journal replay, then recovery rounds
        until converged (nothing actionable left) or max_rounds."""
        r = self.report
        tracer = global_tracer()
        with tracer.span("recovery.run", objects=len(self.stores)):
            while True:
                before = r.rounds
                n = self.run_round()
                if n == 0:
                    break               # converged
                if r.rounds == before:
                    break               # budget spent, round not run
            r.epoch_end = get_epoch(self.osdmap)
        return r


def recover_to_completion(sinfo, ec, osdmap, pool_id: int, ps: int,
                          stores, hinfos, *,
                          journal: Optional[IntentJournal] = None,
                          crashpoint=None, churn=None,
                          max_resumes: int = 32,
                          **kw) -> RecoveryReport:
    """The crash/resume harness: run orchestrator 'daemon lifetimes'
    until one completes, surviving InjectedCrash by re-instantiating
    against the SAME journal + stores + osdmap (everything else — ops
    in flight, decode results, counters — dies with the crash, as it
    would with the process).  Returns the merged report across all
    lifetimes, ``crashes`` counting the restarts."""
    journal = journal if journal is not None else IntentJournal()
    stores = [ensure_store(s) for s in stores]
    total: Optional[RecoveryReport] = None
    crashes = 0
    while True:
        orch = RecoveryOrchestrator(
            sinfo, ec, osdmap, pool_id, ps, stores, hinfos,
            journal=journal, crashpoint=crashpoint, churn=churn, **kw)
        try:
            rep = orch.run()
            if total is None:
                total = rep
            else:
                total.merge_from(rep)
                total.epoch_start = min(total.epoch_start,
                                        rep.epoch_start)
            total.crashes = crashes
            return total
        except InjectedCrash:
            crashes += 1
            if crashes > max_resumes:
                raise
            part = orch.report
            part.epoch_end = get_epoch(osdmap)
            if total is None:
                total = part
            else:
                total.merge_from(part)


def healed(stores, originals) -> bool:
    """True when every store is byte-identical to its ground-truth
    shard dict (the torture gate's zero-data-loss check)."""
    return all(ensure_store(s).snapshot() == dict(o)
               for s, o in zip(stores, originals))


__all__ = ["RecoveryOp", "RecoveryOrchestrator", "RecoveryReport",
           "WriteRecord", "healed", "recover_to_completion"]
