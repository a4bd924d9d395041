"""ShardStore — the mutable substrate faults are injected into.

A copy of ``ceph_tpu/chaos/store.py``.

Plays the ObjectStore role for one EC object: shard id → stored bytes,
plus the transient-failure plan the TransientErrors injector arms.
Reads raise TransientBackendError while a shard has pending transient
faults (decrementing — the "flaky then fine" media model), so the
scrub pipeline's bounded-retry path is exercised by construction, and
KeyError for a missing shard (the -ENOENT analog).

Everything is plain host bytes; determinism comes from the injectors'
seeded rng, not from the store.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.errors import TransientBackendError


class ShardStore:
    """In-memory shard store with injectable read faults."""

    def __init__(self, shards: Dict[int, bytes],
                 chunk_size: Optional[int] = None) -> None:
        self.shards: Dict[int, bytearray] = {
            int(s): bytearray(b) for s, b in shards.items()}
        # per-stripe chunk bytes (StripeInfo.chunk_size); injectors
        # that target stripe geometry (ZeroStripe) require it
        self.chunk_size = chunk_size
        # shard -> remaining transient read errors before success
        self.transient: Dict[int, int] = {}
        # shard -> keep-bytes for the NEXT write (TornWrite injector:
        # the prefix-only write-back of a crashing/partitioned OSD;
        # consumed by the first write to that shard)
        self.torn: Dict[int, int] = {}
        self.reads = 0
        self.writes = 0
        self.transient_failures = 0
        self.torn_writes = 0

    # -- I/O -------------------------------------------------------------

    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    def read(self, shard: int) -> bytes:
        self.reads += 1
        pending = self.transient.get(shard, 0)
        if pending > 0:
            self.transient[shard] = pending - 1
            self.transient_failures += 1
            raise TransientBackendError(
                f"transient read error on shard {shard} "
                f"({pending - 1} more pending)")
        if shard not in self.shards:
            raise KeyError(shard)
        return bytes(self.shards[shard])

    def write(self, shard: int, data: bytes) -> None:
        self.writes += 1
        keep = self.torn.pop(int(shard), None)
        if keep is not None:
            self.torn_writes += 1
            data = data[:max(0, keep)]
        self.shards[int(shard)] = bytearray(data)

    def delete(self, shard: int) -> None:
        self.shards.pop(shard, None)

    def arm_transient(self, shard: int, count: int) -> None:
        """Queue ``count`` transient read failures for ``shard``."""
        self.transient[shard] = self.transient.get(shard, 0) + count

    def arm_torn_write(self, shard: int, keep: int) -> None:
        """The NEXT write to ``shard`` persists only its first ``keep``
        bytes — the torn-write fault the intent journal's payload CRC
        exists to catch (a store-recomputed CRC over the prefix would
        pass by construction; the journal's is over the full intended
        payload, so a prefix can never pass)."""
        self.torn[int(shard)] = int(keep)

    def snapshot(self) -> Dict[int, bytes]:
        return {s: bytes(b) for s, b in self.shards.items()}

    @classmethod
    def from_shards(cls, shards: Dict[int, bytes],
                    chunk_size: Optional[int] = None) -> "ShardStore":
        return cls(shards, chunk_size=chunk_size)


def ensure_store(shards_or_store, chunk_size: Optional[int] = None
                 ) -> ShardStore:
    """Accept either a ShardStore or a plain shard dict (wrapped)."""
    if isinstance(shards_or_store, ShardStore):
        if chunk_size is not None and shards_or_store.chunk_size is None:
            shards_or_store.chunk_size = chunk_size
        return shards_or_store
    return ShardStore(dict(shards_or_store), chunk_size=chunk_size)


__all__ = ["ShardStore", "ensure_store"]
