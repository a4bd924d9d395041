"""Write-ahead intent journal — crash-consistent shard write-back.

A copy of ``ceph_tpu/recovery/journal.py``.

Reference: the PG log + recovery-reservation discipline
(src/osd/PGLog.{h,cc}, ReplicatedBackend/ECBackend recovery ops): a
recovery write is journaled as an INTENT before any byte lands, the
bytes land, the op COMMITs, and only then is the intent cleared — so
a crash at ANY point leaves enough durable state to either finish the
op or roll it back cleanly.  Here the journal is that state machine
over the chaos ShardStore:

    begin(intent) ──write shards──▶ commit ──▶ clear
        │                            │
        └── crash ⇒ replay:          └── crash ⇒ replay: verify,
            verify each journaled        clear (the op already
            shard against the FULL       proved itself)
            intended payload's crc+len:
            match ⇒ keep (the write
            completed), mismatch/torn
            ⇒ delete (roll back to
            missing; recovery re-runs)

The intent record carries the crc32c AND length of each full intended
payload, so a torn (prefix-only) write can never pass replay "by
accident": a store-side CRC recomputed over whatever bytes are
present would bless the prefix; the journal's CRC is over the bytes
that were SUPPOSED to land.  Replay is idempotent by construction —
it only ever deletes non-matching bytes and clears records, so
running it twice (or re-running a whole recovery after it) is a
no-op.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..codes.stripe import ceph_crc32c
from ..utils.errors import ScrubError

# HashInfo's cumulative seed (-1, ECUtil.h) — the same seed the scrub
# CRC gate uses, so journal CRCs and HashInfo CRCs agree on payloads
CRC_SEED = 0xFFFFFFFF


class IntentState(enum.Enum):
    INTENT = "intent"        # journaled; writes may be in flight
    COMMITTED = "committed"  # all writes landed and verified


@dataclass
class IntentRecord:
    """One op's durable write-ahead state."""

    op_id: int
    obj: int                               # object index in the pg
    epoch: int                             # map epoch at write time
    payloads: Dict[int, Tuple[int, int]]   # shard -> (crc32c, length)
    targets: Dict[int, int]                # shard -> target osd
    state: IntentState = IntentState.INTENT


@dataclass
class ReplayStats:
    """One replay pass's outcome."""

    replayed: int = 0          # records examined
    completed: int = 0         # records whose every payload verified
    rolled_back: int = 0       # records with >=1 torn/absent payload
    shards_kept: int = 0       # journaled shards verified + kept
    shards_deleted: int = 0    # torn/mismatched shards rolled back

    def merge(self, other: "ReplayStats") -> None:
        self.replayed += other.replayed
        self.completed += other.completed
        self.rolled_back += other.rolled_back
        self.shards_kept += other.shards_kept
        self.shards_deleted += other.shards_deleted


def payload_digest(data: bytes) -> Tuple[int, int]:
    """(crc32c, length) of a full intended payload — what the intent
    records and what replay/verify check against."""
    return int(ceph_crc32c(CRC_SEED, data)), len(data)


class IntentJournal:
    """The pg's write-ahead intent log (the durable medium: it —
    like the ShardStore — survives an InjectedCrash; only the
    orchestrator's in-memory state dies)."""

    def __init__(self) -> None:
        self.records: Dict[int, IntentRecord] = {}
        self._next_op_id = 0
        # lifetime counters (reports/tests)
        self.begun = 0
        self.committed = 0
        self.cleared = 0

    # -- op-id allocation (monotonic across resumes: the journal is
    # the only state that survives a crash, so it owns the sequence) --

    def allocate_op_id(self) -> int:
        op_id = self._next_op_id
        self._next_op_id += 1
        return op_id

    # -- the intent → commit → clear state machine ---------------------

    def begin(self, op_id: int, obj: int, epoch: int,
              payloads: Dict[int, bytes],
              targets: Dict[int, int]) -> IntentRecord:
        """Journal the intent BEFORE any write: full-payload digests
        plus the fenced targets.  Returning = the fsync point (the
        record is durable from here on)."""
        if op_id in self.records:
            raise ScrubError(
                f"intent journal: op {op_id} already has a pending "
                f"record — replay before re-planning")
        rec = IntentRecord(
            op_id=op_id, obj=obj, epoch=epoch,
            payloads={int(s): payload_digest(b)
                      for s, b in payloads.items()},
            targets={int(s): int(o) for s, o in targets.items()})
        self.records[op_id] = rec
        self.begun += 1
        return rec

    def commit(self, op_id: int) -> None:
        """All writes landed and verified against the intent."""
        self.records[op_id].state = IntentState.COMMITTED
        self.committed += 1

    def clear(self, op_id: int) -> None:
        """The op is fully durable; drop the record."""
        self.records.pop(op_id, None)
        self.cleared += 1

    def rollback(self, op_id: int, store) -> int:
        """Abandon a pending op mid-flight (no crash): delete every
        journaled shard whose stored bytes do not match the intended
        payload, clear the record; returns shards deleted."""
        rec = self.records.pop(op_id, None)
        if rec is None:
            return 0
        deleted = 0
        for shard, want in rec.payloads.items():
            if not self._shard_matches(store, shard, want):
                store.delete(shard)
                deleted += 1
        return deleted

    def pending(self) -> List[IntentRecord]:
        return [self.records[i] for i in sorted(self.records)]

    # -- crash recovery ------------------------------------------------

    @staticmethod
    def _shard_matches(store, shard: int,
                       want: Tuple[int, int]) -> bool:
        # raw access on purpose: replay is local disk recovery, not a
        # backend read — the transient-fault plan does not apply
        buf = store.shards.get(int(shard))
        if buf is None or len(buf) != want[1]:
            return False
        return int(ceph_crc32c(CRC_SEED, bytes(buf))) == want[0]

    def replay(self, stores) -> ReplayStats:
        """Resume after a crash: for every pending record, verify each
        journaled shard against the FULL intended payload digest —
        keep exact matches (those writes completed; the bytes passed
        every gate before the intent was cut), delete anything torn,
        prefix-only, or absent-but-partial, then clear the record.
        Idempotent: a second replay (or a crash during replay) finds
        either nothing pending or the same deterministic outcome.

        ``stores``: obj index -> ShardStore (a list or dict)."""
        stats = ReplayStats()
        for op_id in sorted(self.records):
            rec = self.records[op_id]
            store = stores[rec.obj]
            matched = {int(s): self._shard_matches(store, s, w)
                       for s, w in rec.payloads.items()}
            stats.shards_kept += sum(matched.values())
            torn = [s for s, ok in matched.items()
                    if not ok and s in store.shards]
            for shard in torn:
                store.delete(shard)
                stats.shards_deleted += 1
            stats.replayed += 1
            if all(matched.values()):
                stats.completed += 1     # every write landed in full
            else:
                stats.rolled_back += 1   # torn/absent: recovery re-runs
            del self.records[op_id]
            self.cleared += 1
        return stats

    def reclaim(self, stores, *, fence_epoch: Optional[int] = None
                ) -> Tuple[ReplayStats, List[IntentRecord]]:
        """Host-loss in-flight reclaim: the survivors'
        answer to "what was the lost host in the middle of?".

        Same verify/keep/roll-back discipline as :meth:`replay` — the
        journal cannot tell a crash from a host loss, and does not
        need to — but the rolled-back records are RETURNED (snapshot
        taken before the record clears) so the host-quarantine path
        can re-dispatch exactly those ops on the shrunken plane.  The
        re-dispatch must ``begin()`` fresh intents at a **bumped
        epoch**: anything the lost (or partitioned — it may still be
        writing) host lands under the old epoch then fails the epoch
        fence exactly like a stale recovery op does today.

        ``fence_epoch``: only records with ``epoch < fence_epoch`` are
        reclaimed (None = all pending) — ops begun after the loss was
        detected belong to the survivors and stay pending."""
        from ..telemetry import metrics as tel
        stats = ReplayStats()
        redo: List[IntentRecord] = []
        for op_id in sorted(self.records):
            rec = self.records[op_id]
            if fence_epoch is not None and rec.epoch >= fence_epoch:
                continue
            store = stores[rec.obj]
            matched = {int(s): self._shard_matches(store, s, w)
                       for s, w in rec.payloads.items()}
            stats.shards_kept += sum(matched.values())
            torn = [s for s, ok in matched.items()
                    if not ok and s in store.shards]
            for shard in torn:
                store.delete(shard)
                stats.shards_deleted += 1
            stats.replayed += 1
            if all(matched.values()):
                stats.completed += 1
            else:
                stats.rolled_back += 1
                redo.append(rec)
            del self.records[op_id]
            self.cleared += 1
        tel.counter("journal_reclaims")
        tel.event("journal_reclaim", ops=stats.replayed,
                  redispatch=len(redo), fence_epoch=fence_epoch)
        return stats, redo


__all__ = ["CRC_SEED", "IntentJournal", "IntentRecord", "IntentState",
           "ReplayStats", "payload_digest"]
