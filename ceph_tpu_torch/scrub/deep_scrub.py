"""Deep-scrub → repair → remap — the PGScrubber/ECBackend recovery loop.

A copy of ``ceph_tpu/scrub/deep_scrub.py``, whose fused repair runs on
the code's device (the card unless the caller asks for the CPU).

Reference: src/osd/scrubber/pg_scrubber.cc + ScrubStore (deep scrub
reads every shard and compares stored digests), ECBackend's recovery
path (ReadOp/RecoveryOp: minimum_to_decode over survivors →
decode_chunks → write the rebuilt shard, gated on the HashInfo crc),
and the mon's response to scrub errors (mark the bad OSD out, let
CRUSH remap).  The daemons are out of scope; this module is that loop
as pure math over a ShardStore:

1. ``deep_scrub``   — read every shard (bounded retry over transient
   errors, utils/retry.py), verify ALL shards against HashInfo crc32c
   in ONE vectorized CRC call (stripe.ceph_crc32c_batch), classify
   clean / missing / corrupt.
2. ``repair``       — demote corrupt shards to erasures, plan with
   minimum_to_decode, reconstruct with the plugin's batched decode,
   RE-ENCODE the object and require byte-identical parity plus
   matching recomputed CRCs before writing anything back; raise a
   structured UnrecoverableError naming shards AND logical extents
   when the faults exceed the code's budget.
3. ``apply_osd_feedback`` — feed confirmed-bad OSDs into
   OSDMap.mark_down/mark_out so CRUSH remaps, closing the
   placement↔EC loop.

``read_degraded`` is the client-facing composition: a degraded-mode
read that treats corrupt shards as erasures and NEVER returns garbage
— past the failure budget it raises with the precise unrecoverable
extents of the requested range.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chaos.store import ShardStore, ensure_store
from ..codes import stripe as stripe_mod
from ..codes.stripe import HashInfo, StripeInfo, ceph_crc32c_batch
from ..telemetry import metrics as tel
from ..telemetry.spans import global_tracer
from ..utils.errors import (
    RetryExhausted,
    ScrubError,
    UnrecoverableError,
)
from ..utils.log import dout
from ..utils.retry import RetryPolicy, retry_call

CRC_SEED = 0xFFFFFFFF  # HashInfo's cumulative seed (-1, ECUtil.h)


class ShardState(enum.Enum):
    CLEAN = "clean"
    MISSING = "missing"
    CORRUPT = "corrupt"


@dataclass(frozen=True)
class ShardVerdict:
    """One shard's scrub outcome (expected/actual crc kept for the
    report; actual is None when the shard never produced bytes)."""

    shard: int
    state: ShardState
    expected_crc: int
    actual_crc: Optional[int] = None
    length: Optional[int] = None
    error: str = ""


@dataclass
class ScrubReport:
    """deep_scrub's classification of every shard of one object."""

    verdicts: Dict[int, ShardVerdict] = field(default_factory=dict)
    shard_length: int = 0          # expected per-shard bytes (HashInfo)
    retried_shards: Tuple[int, ...] = ()

    def _with(self, state: ShardState) -> List[int]:
        return sorted(s for s, v in self.verdicts.items()
                      if v.state is state)

    @property
    def clean(self) -> List[int]:
        return self._with(ShardState.CLEAN)

    @property
    def missing(self) -> List[int]:
        return self._with(ShardState.MISSING)

    @property
    def corrupt(self) -> List[int]:
        return self._with(ShardState.CORRUPT)

    @property
    def bad(self) -> List[int]:
        """Shards needing repair: missing + corrupt."""
        return sorted(self.missing + self.corrupt)

    @property
    def is_clean(self) -> bool:
        return not self.bad


@dataclass
class RepairReport:
    """repair's outcome: which shards were rebuilt and the proof."""

    scrub: ScrubReport
    repaired: Dict[int, bytes] = field(default_factory=dict)
    reencode_verified: bool = False
    crc_verified: bool = False


@dataclass
class BatchRepairReport:
    """repair_batched's outcome across many objects: per-object
    RepairReports plus the device-traffic accounting the batching
    exists for (one fused dispatch per erasure-pattern batch) and the
    epoch-fencing accounting (how often the OSDMap moved between plan
    and dispatch, forcing a re-scrub + re-group)."""

    reports: List[RepairReport] = field(default_factory=list)
    pattern_batches: int = 0     # distinct (reads, erased, len) groups
    device_calls: int = 0        # fused decode+re-encode dispatches
    host_batches: int = 0        # groups served by the numpy tier
    regroups: int = 0            # stale-epoch re-plans before dispatch
    plan_epoch: Optional[int] = None   # map epoch the live grouping is
                                       # keyed to (None: no osdmap given)

    @property
    def repaired_objects(self) -> List[int]:
        return [i for i, r in enumerate(self.reports) if r.repaired]


@dataclass
class RemapReport:
    """apply_osd_feedback's outcome."""

    marked_osds: Tuple[int, ...] = ()
    old_acting: Tuple[int, ...] = ()
    new_acting: Tuple[int, ...] = ()

    @property
    def moved(self) -> Dict[int, Tuple[int, int]]:
        """shard slot -> (old osd, new osd) for slots that remapped."""
        return {i: (o, n) for i, (o, n) in
                enumerate(zip(self.old_acting, self.new_acting)) if o != n}


# -- stage 1: deep scrub -------------------------------------------------

def deep_scrub(sinfo: StripeInfo, ec, store, hinfo: HashInfo, *,
               retry_policy: Optional[RetryPolicy] = None,
               clock=None) -> ScrubReport:
    """Read + verify + classify every shard of one object.

    Transient read errors retry under ``retry_policy`` (injectable
    ``clock``: tests run the whole backoff schedule without sleeping);
    a shard whose retries exhaust is classified MISSING with the error
    recorded.  Wrong-length shards are CORRUPT immediately (truncation
    can't crc-match a cumulative hash); everything else verifies
    against HashInfo in one ceph_crc32c_batch call across all shards.
    """
    _t0 = tel.global_metrics().clock.monotonic()
    store = ensure_store(store, chunk_size=sinfo.chunk_size)
    n = ec.get_chunk_count()
    expected_len = hinfo.total_chunk_size
    policy = retry_policy or RetryPolicy()
    verdicts: Dict[int, ShardVerdict] = {}
    retried: List[int] = []
    bufs: Dict[int, bytes] = {}
    for s in range(n):
        failures = store.transient.get(s, 0) if isinstance(
            store, ShardStore) else 0
        try:
            bufs[s] = retry_call(store.read, s, policy=policy,
                                 clock=clock)
            if failures:
                retried.append(s)
        except KeyError:
            verdicts[s] = ShardVerdict(s, ShardState.MISSING,
                                       hinfo.get_chunk_hash(s),
                                       error="shard not in store")
        except RetryExhausted as e:
            verdicts[s] = ShardVerdict(s, ShardState.MISSING,
                                       hinfo.get_chunk_hash(s),
                                       error=str(e))
    # length gate: a cumulative crc only speaks over full-length shards
    full: List[int] = []
    for s, b in bufs.items():
        if len(b) != expected_len:
            verdicts[s] = ShardVerdict(
                s, ShardState.CORRUPT, hinfo.get_chunk_hash(s),
                length=len(b),
                error=f"length {len(b)} != expected {expected_len}")
        else:
            full.append(s)
    if full:
        stack = np.stack([np.frombuffer(bufs[s], dtype=np.uint8)
                          for s in full])
        actual = ceph_crc32c_batch([CRC_SEED] * len(full), stack)
        for i, s in enumerate(full):
            want = hinfo.get_chunk_hash(s)
            got = int(actual[i])
            state = (ShardState.CLEAN if got == want
                     else ShardState.CORRUPT)
            verdicts[s] = ShardVerdict(
                s, state, want, actual_crc=got, length=expected_len,
                error="" if state is ShardState.CLEAN
                else "crc mismatch")
    report = ScrubReport(verdicts=verdicts, shard_length=expected_len,
                         retried_shards=tuple(retried))
    if report.bad:
        dout("ec", 5, f"deep_scrub: missing={report.missing} "
                      f"corrupt={report.corrupt}")
    tel.observe("scrub_deep_scrub_seconds",
                tel.global_metrics().clock.monotonic() - _t0)
    return report


# -- unrecoverable extents ----------------------------------------------

def unrecoverable_extents(sinfo: StripeInfo, ec, bad_shards,
                          n_stripes: int,
                          window: Optional[Tuple[int, int]] = None
                          ) -> Tuple[Tuple[int, int], ...]:
    """Logical (offset, length) ranges covered by lost DATA chunks,
    merged where adjacent; parity shards carry no client bytes.
    ``window`` clips to a requested (offset, length) read range."""
    mapping = stripe_mod._chunk_mapping(ec)
    inv = {shard: chunk for chunk, shard in enumerate(mapping)}
    k = ec.get_data_chunk_count()
    bad_chunks = sorted(inv[s] for s in bad_shards if inv[s] < k)
    if not bad_chunks:
        return ()
    cs, width = sinfo.chunk_size, sinfo.stripe_width
    lo, hi = 0, n_stripes * width
    if window is not None:
        lo, hi = window[0], window[0] + window[1]
    spans: List[Tuple[int, int]] = []
    for stripe_i in range(n_stripes):
        for c in bad_chunks:
            start = stripe_i * width + c * cs
            end = start + cs
            start, end = max(start, lo), min(end, hi)
            if start >= end:
                continue
            if spans and spans[-1][0] + spans[-1][1] == start:
                spans[-1] = (spans[-1][0], spans[-1][1] + end - start)
            else:
                spans.append((start, end - start))
    return tuple(spans)


# -- stage 2: repair -----------------------------------------------------

def repair(sinfo: StripeInfo, ec, store, hinfo: HashInfo,
           report: Optional[ScrubReport] = None, *,
           retry_policy: Optional[RetryPolicy] = None,
           clock=None, write_back: bool = True) -> RepairReport:
    """Rebuild every bad shard, or raise structured errors.

    Corrupt shards are demoted to erasures (their bytes are never fed
    to the decoder); the plugin's own minimum_to_decode is the
    feasibility oracle, so the failure budget is exactly the code's —
    m for MDS, locality-dependent for lrc/shec/clay.  The repaired
    object must survive BOTH gates before any write-back: re-encode
    reproduces every shard byte-identically (parity included) and the
    recomputed CRCs match HashInfo.
    """
    store = ensure_store(store, chunk_size=sinfo.chunk_size)
    if report is None:
        report = deep_scrub(sinfo, ec, store, hinfo,
                            retry_policy=retry_policy, clock=clock)
    if report.is_clean:
        return RepairReport(scrub=report, reencode_verified=True,
                            crc_verified=True)
    n = ec.get_chunk_count()
    n_stripes = report.shard_length // sinfo.chunk_size
    mapping = stripe_mod._chunk_mapping(ec)
    bad = report.bad
    clean = report.clean

    def _unrecoverable(cause=None):
        return UnrecoverableError(
            f"{len(bad)} shards lost/corrupt exceed the failure budget "
            f"of this {ec.get_data_chunk_count()}+"
            f"{ec.get_coding_chunk_count()} code",
            shards=bad,
            extents=unrecoverable_extents(sinfo, ec, bad, n_stripes),
            cause=cause)

    if len(clean) < ec.get_data_chunk_count():
        raise _unrecoverable()
    try:
        # shard space: the space every plugin's decode path speaks
        # (identity chunk ids, or lrc's global positions)
        plan = ec.minimum_to_decode(set(bad), set(clean))
    except (IOError, ValueError) as e:
        raise _unrecoverable(cause=e) from e
    reads = {s: retry_call(store.read, s, policy=retry_policy,
                           clock=clock)
             for s in plan}
    rec = stripe_mod.decode(sinfo, ec, reads, set(bad))

    # -- re-verify: re-encode and require byte identity + crc match ----
    k = ec.get_data_chunk_count()
    current: Dict[int, bytes] = {}
    for s in range(n):
        current[s] = rec[s] if s in rec else retry_call(
            store.read, s, policy=retry_policy, clock=clock)
    data_shards = {c: current[mapping[c]] for c in range(k)}
    logical = stripe_mod._window_bytes(sinfo, data_shards, k, n_stripes)
    reencoded = stripe_mod.encode(sinfo, ec, logical)
    mismatch = [s for s in range(n) if reencoded[s] != current[s]]
    if mismatch:
        raise ScrubError(
            "repair re-encode is not byte-identical to the surviving "
            "shards — refusing to write back", shards=mismatch)
    stack = np.stack([np.frombuffer(current[s], dtype=np.uint8)
                      for s in range(n)])
    crcs = ceph_crc32c_batch([CRC_SEED] * n, stack)
    crc_bad = [s for s in range(n)
               if int(crcs[s]) != hinfo.get_chunk_hash(s)]
    if crc_bad:
        raise ScrubError(
            "repaired shards fail the HashInfo crc gate — refusing to "
            "write back", shards=crc_bad)
    if write_back:
        for s in bad:
            store.write(s, rec[s])
    dout("ec", 5, f"repair: rebuilt shards {bad} "
                  f"(read plan {sorted(plan)})")
    return RepairReport(scrub=report,
                        repaired={s: rec[s] for s in bad},
                        reencode_verified=True, crc_verified=True)


# -- stage 2b: batched repair (one device call per erasure pattern) ------

def repair_batched(sinfo: StripeInfo, ec, stores, hinfos, *,
                   retry_policy: Optional[RetryPolicy] = None,
                   clock=None, write_back: bool = True,
                   device: Optional[bool] = None,
                   osdmap=None,
                   on_batch=None) -> BatchRepairReport:
    """Repair MANY same-geometry objects with one fused device call
    per erasure-pattern batch.

    The per-object ``repair`` loop crosses host↔device once per object
    (and its decode and re-encode are separate dispatches); at fleet
    scale the dispatch latency dominates the math.  Here every object
    is scrub-classified on the host exactly as before (CRC gating
    unchanged), the damaged ones are grouped by (read plan, erased
    set, shard length), each group's stripes are stacked into ONE
    tensor on the code's device (one host→device copy), and a single
    fused decode→re-encode callable (codes/engine.py::fused_repair_call,
    cached per pattern) produces both the rebuilt shards and the
    re-encode proof in one dispatch, copied back once per output.
    Results are byte-identical to per-object ``repair`` — the fused
    program composes the same plugin decode/encode surfaces — and
    both write-back gates (re-encode byte identity, HashInfo CRC)
    still run per object on the host.

    Raises UnrecoverableError on the first object past the failure
    budget (before any device work) and ScrubError if any object
    fails a write-back gate (objects that passed are healed first).

    ``device``: None (default) auto-selects by the live tier, as the
    reference does — the fused device path on the code's device unless
    the fallback policy (ops/fallback.py) runs the numpy tier: inside
    ``numpy_tier()``, at the supervisor's live numpy floor, or forced,
    which a forced tier may be only for a code on the CPU (a forced
    numpy tier on a CUDA code raises ValueError); False forces the
    grouped HOST path (same grouping, one plugin batch call per
    pattern: the bench's ``--device host`` row).  A fused call that
    fails is the supervisor's to survive (ops/supervisor.py: retry and
    rung split; for a CPU code live demotion and the host twin at the
    floor; on the card a persistent failure raises
    ``DeviceDispatchError``, and the objects healed before it stay
    healed).

    ``osdmap``: when given, the grouping is epoch-fenced — the plan is
    stamped with the map's epoch, and before every pattern-batch
    dispatch the CURRENT epoch is re-checked (crush/incremental.py);
    on a stale epoch the not-yet-dispatched objects are re-scrubbed
    and re-grouped against the world as it now is instead of
    dispatching the stale grouping (counted in ``regroups``).
    ``on_batch(batch_index, key)`` fires before each dispatch — the
    documented interleave point where MapChurn / CrashPoint
    adversaries (and the recovery orchestrator's stage hooks) run.
    """
    stores = [ensure_store(s, chunk_size=sinfo.chunk_size)
              for s in stores]
    hinfos = list(hinfos)
    if len(stores) != len(hinfos):
        raise ValueError(f"{len(stores)} stores != {len(hinfos)} "
                         f"HashInfos")
    from ..codes.engine import fused_repair_call
    from ..codes.techniques import _numpy_tier
    from ..crush.incremental import get_epoch
    from ..utils.perf import global_perf
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    mapping = stripe_mod._chunk_mapping(ec)
    reports: List[Optional[RepairReport]] = [None] * len(stores)
    scrubs: List[Optional[ScrubReport]] = [None] * len(stores)

    tracer = global_tracer()

    def _plan(indices) -> Dict[tuple, List[int]]:
        """Scrub + classify + feasibility-check ``indices``; returns
        the (clean, erased, length) pattern grouping.  Re-run whole
        whenever the map epoch moves between plan and dispatch."""
        indices = list(indices)
        with tracer.span("scrub", objects=len(indices)):
            scrubbed = {i: deep_scrub(sinfo, ec, stores[i], hinfos[i],
                                      retry_policy=retry_policy,
                                      clock=clock)
                        for i in indices}
        with tracer.span("plan"):
            return _group(indices, scrubbed)

    def _group(indices, scrubbed) -> Dict[tuple, List[int]]:
        groups: Dict[tuple, List[int]] = {}
        for i in indices:
            rep = scrubbed[i]
            scrubs[i] = rep
            if rep.is_clean:
                reports[i] = RepairReport(scrub=rep,
                                          reencode_verified=True,
                                          crc_verified=True)
                continue
            n_stripes = rep.shard_length // sinfo.chunk_size

            def _unrecoverable(cause=None, i=i, rep=rep,
                               n_stripes=n_stripes):
                return UnrecoverableError(
                    f"object {i}: {len(rep.bad)} shards lost/corrupt "
                    f"exceed the failure budget of this "
                    f"{ec.get_data_chunk_count()}+"
                    f"{ec.get_coding_chunk_count()} code",
                    shards=rep.bad,
                    extents=unrecoverable_extents(sinfo, ec, rep.bad,
                                                  n_stripes),
                    cause=cause)

            if len(rep.clean) < k:
                raise _unrecoverable()
            try:
                # feasibility oracle only — the fused call stacks
                # EVERY clean shard, because the re-encode half needs
                # all k data chunks (lrc's minimum plan can skip clean
                # data shards outside the local group) and the host
                # gates read every shard regardless; decode output is
                # byte-identical at any valid availability
                ec.minimum_to_decode(set(rep.bad), set(rep.clean))
            except (IOError, ValueError) as e:
                raise _unrecoverable(cause=e) from e
            key = (tuple(rep.clean), tuple(rep.bad), rep.shard_length)
            groups.setdefault(key, []).append(i)
        return groups

    perf = global_perf()
    device_calls = 0
    host_batches = 0
    pattern_batches = 0
    regroups = 0
    batch_index = 0
    gate_failures: List[str] = []
    call_hook = True
    with tracer.span("repair", objects=len(stores),
                     plugin=type(ec).__name__):
        plan_epoch = get_epoch(osdmap) if osdmap is not None else None
        pending = list(_plan(range(len(stores))).items())
        while pending:
            (available, erased, shard_len), members = pending[0]
            if call_hook and on_batch is not None:
                on_batch(batch_index, (available, erased, shard_len))
            call_hook = True
            batch_index += 1
            if osdmap is not None and get_epoch(osdmap) != plan_epoch:
                # the map moved between plan and this dispatch: the
                # stale grouping must not be dispatched — re-scrub
                # everything still pending and re-group against the
                # current epoch (the hook is NOT re-fired for the
                # regrouped head, so one churn event costs at most one
                # regroup, never a livelock)
                remaining = sorted({i for _, ms in pending for i in ms})
                plan_epoch = get_epoch(osdmap)
                regroups += 1
                tel.counter("repair_regroups")
                pending = list(_plan(remaining).items())
                call_hook = False
                continue
            pending.pop(0)
            pattern_batches += 1
            tel.counter("repair_pattern_batches")
            n_stripes = shard_len // sinfo.chunk_size
            use_device = (device if device is not None
                          else not _numpy_tier(ec.device))
            engine_label = "device" if use_device else "host"
            with tracer.span("dispatch", batch=batch_index - 1,
                             engine=engine_label,
                             members=len(members)):
                reads_by_obj: List[Dict[int, bytes]] = []
                stacks = []
                for i in members:
                    reads = {s: retry_call(stores[i].read, s,
                                           policy=retry_policy,
                                           clock=clock)
                             for s in available}
                    reads_by_obj.append(reads)
                    stacks.append(np.stack(
                        [np.frombuffer(reads[s], dtype=np.uint8).reshape(
                            n_stripes, sinfo.chunk_size)
                         for s in available],
                        axis=1))
                stack = np.concatenate(stacks, axis=0)  # (B*str, na, C)
                aidx = {s: t for t, s in enumerate(available)}
                eidx = {s: t for t, s in enumerate(erased)}
                with tel.record_dispatch("scrub_dispatch",
                                         engine=engine_label):
                    if not use_device:
                        # numpy tier: still grouped (one host pass per
                        # pattern), zero device traffic by policy
                        rec_arr = np.asarray(ec.decode_chunks_batch(
                            stack, available, erased))
                        cols = [stack[:, aidx[mapping[c]], :]
                                if mapping[c] in aidx
                                else rec_arr[:, eidx[mapping[c]], :]
                                for c in range(k)]
                        parity = np.asarray(ec.encode_chunks_batch(
                            np.ascontiguousarray(
                                np.stack(cols, axis=1))))
                        host_batches += 1
                        perf.inc("scrub_batch_host_calls")
                    else:
                        import torch
                        fn = fused_repair_call(ec, available, erased)
                        rec_dev, par_dev = fn(
                            torch.from_numpy(stack).to(ec.device))
                        rec_arr = rec_dev.cpu().numpy()
                        parity = par_dev.cpu().numpy()
                        device_calls += 1
                        perf.inc("scrub_batch_device_calls")
                perf.inc("scrub_batch_stripes", stack.shape[0])

            to_write: List[Tuple[int, Dict[int, bytes]]] = []
            with tracer.span("verify", members=len(members)):
                for t, i in enumerate(members):
                    lo = t * n_stripes
                    rec = {s: np.ascontiguousarray(
                        rec_arr[lo:lo + n_stripes, eidx[s], :]).tobytes()
                        for s in erased}
                    current: Dict[int, bytes] = {}
                    for s in range(n):
                        if s in rec:
                            current[s] = rec[s]
                        elif s in aidx:
                            current[s] = reads_by_obj[t][s]
                        else:
                            current[s] = retry_call(
                                stores[i].read, s,
                                policy=retry_policy, clock=clock)
                    # re-encode gate: fused parity vs surviving/
                    # recovered shards (data shards are assembled FROM
                    # current, so the byte-identity obligation reduces
                    # to the parity rows — exactly what the per-object
                    # gate checks effectively)
                    mismatch = []
                    for j in range(ec.get_coding_chunk_count()):
                        s = mapping[k + j]
                        expect = np.ascontiguousarray(
                            parity[lo:lo + n_stripes, j, :]).tobytes()
                        if expect != current[s]:
                            mismatch.append(s)
                    if mismatch:
                        gate_failures.append(
                            f"object {i}: re-encode mismatch on shards "
                            f"{mismatch}")
                        reports[i] = RepairReport(scrub=scrubs[i])
                        tel.counter("repair_gate_failures",
                                    gate="reencode")
                        continue
                    crcs = ceph_crc32c_batch(
                        [CRC_SEED] * n,
                        np.stack([np.frombuffer(current[s],
                                                dtype=np.uint8)
                                  for s in range(n)]))
                    crc_bad = [s for s in range(n)
                               if int(crcs[s])
                               != hinfos[i].get_chunk_hash(s)]
                    if crc_bad:
                        gate_failures.append(
                            f"object {i}: crc gate failed on shards "
                            f"{crc_bad}")
                        reports[i] = RepairReport(scrub=scrubs[i])
                        tel.counter("repair_gate_failures", gate="crc")
                        continue
                    to_write.append((i, rec))
                    reports[i] = RepairReport(scrub=scrubs[i],
                                              repaired=rec,
                                              reencode_verified=True,
                                              crc_verified=True)
            if write_back and to_write:
                with tracer.span("write_back", members=len(to_write)):
                    for i, rec in to_write:
                        for s in sorted(rec):
                            stores[i].write(s, rec[s])
    if pattern_batches:
        dout("ec", 5, f"repair_batched: {len(stores)} objects, "
                      f"{pattern_batches} pattern batches, "
                      f"{device_calls} device calls, "
                      f"{regroups} stale-epoch regroups")
    out = BatchRepairReport(reports=reports,  # type: ignore[arg-type]
                            pattern_batches=pattern_batches,
                            device_calls=device_calls,
                            host_batches=host_batches,
                            regroups=regroups,
                            plan_epoch=plan_epoch)
    if gate_failures:
        raise ScrubError(
            "batched repair verification failed — refusing to write "
            "those objects back: " + "; ".join(gate_failures),
            shards=[])
    return out


# -- stage 3: OSD feedback / CRUSH remap ---------------------------------

def apply_osd_feedback(osdmap, pool_id: int, ps: int,
                       acting, bad_shards) -> RemapReport:
    """Mark the OSDs holding confirmed-bad shards down AND out, then
    re-run the placement pipeline: CRUSH reweights and the pg's acting
    set backfills away from the bad devices — the scrub result feeding
    placement, like the mon reacting to scrub errors."""
    from ..crush.types import CRUSH_ITEM_NONE
    old = tuple(int(o) for o in acting)
    marked = []
    for s in sorted(set(bad_shards)):
        osd = old[s]
        if osd == CRUSH_ITEM_NONE:
            continue
        osdmap.mark_down(osd)
        osdmap.mark_out(osd)
        marked.append(osd)
    _, _, new_acting, _ = osdmap.pg_to_up_acting_osds(pool_id, ps)
    dout("crush", 5, f"scrub feedback: marked osds {marked} down+out; "
                     f"pg {pool_id}.{ps} acting {list(old)} -> "
                     f"{list(new_acting)}")
    return RemapReport(marked_osds=tuple(marked), old_acting=old,
                       new_acting=tuple(int(o) for o in new_acting))


# -- degraded-mode read --------------------------------------------------

def read_degraded(sinfo: StripeInfo, ec, store, hinfo: HashInfo,
                  offset: int, length: int, *,
                  retry_policy: Optional[RetryPolicy] = None,
                  clock=None) -> bytes:
    """Client read that survives ≤budget faults and NEVER returns
    garbage: scrub-classify first (corrupt shards become erasures),
    reconstruct through the normal read math, and past the budget
    raise UnrecoverableError carrying the lost extents CLIPPED to the
    requested range."""
    store = ensure_store(store, chunk_size=sinfo.chunk_size)
    report = deep_scrub(sinfo, ec, store, hinfo,
                        retry_policy=retry_policy, clock=clock)
    n_stripes = report.shard_length // sinfo.chunk_size
    survivors = {s: retry_call(store.read, s, policy=retry_policy,
                               clock=clock)
                 for s in report.clean}
    try:
        return stripe_mod.read(sinfo, ec, survivors, offset, length)
    except (IOError, ValueError) as e:
        raise UnrecoverableError(
            f"degraded read [{offset}, +{length}) cannot be served: "
            f"{len(report.bad)} shards lost/corrupt",
            shards=report.bad,
            extents=unrecoverable_extents(sinfo, ec, report.bad,
                                          n_stripes,
                                          window=(offset, length)),
            cause=e) from e


def scrub_and_repair(sinfo: StripeInfo, ec, store, hinfo: HashInfo, *,
                     osdmap=None, pool_id: Optional[int] = None,
                     ps: Optional[int] = None, acting=None,
                     retry_policy: Optional[RetryPolicy] = None,
                     clock=None
                     ) -> Tuple[RepairReport, Optional[RemapReport]]:
    """The whole loop in one call: deep_scrub → repair → (when an
    OSDMap context is given) mark bad OSDs and remap."""
    rep = repair(sinfo, ec, store, hinfo, retry_policy=retry_policy,
                 clock=clock)
    remap = None
    if osdmap is not None and rep.scrub.bad and acting is not None:
        remap = apply_osd_feedback(osdmap, pool_id, ps, acting,
                                   rep.scrub.bad)
    return rep, remap
