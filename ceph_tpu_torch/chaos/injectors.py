"""Deterministic, composable fault injectors.

A copy of ``ceph_tpu/chaos/injectors.py``.

The reference earns durability through what it survives, and proves it
with thrashers (qa/tasks/thrasher.py), EIO injection
(test-erasure-eio.sh's `ceph osd pool set ... inject_read_error`
path), and the scrubber's corruption fixtures.  This module is that
fault model as a library: each injector mutates a ShardStore and
returns Fault records describing exactly what it did; ALL randomness
flows through the seeded rng handed to apply(), so a (seed, injector
list) pair replays byte-identically from any test, the fuzz suite,
or the degraded benchmark.

Fault kinds (the classification the scrub pipeline must recover):

- erase       — shard deleted outright (lost OSD / -ENOENT),
- bitflip     — N single-bit flips (silent media corruption; the crc
                gate's reason to exist),
- truncate    — shard cut short (torn write / partial recovery),
- zero_stripe — one stripe's chunk zeroed across every shard (a
                misdirected full-stripe write),
- transient   — the shard's next N reads raise TransientBackendError
                (flaky path; exercises utils/retry.py, carries no
                data damage),
- torn_write  — the shard's NEXT write persists only a prefix (torn
                write-back of a crashing OSD; no damage until the
                recovery path writes — the intent journal's payload
                CRC must catch it).

The orchestrator-level adversaries (CrashPoint, MapChurn) live in
chaos/adversaries.py — they act on pipeline stages and the OSDMap,
not on a ShardStore's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .store import ShardStore, ensure_store


@dataclass(frozen=True)
class Fault:
    """One applied fault, precise enough to predict scrub's verdict."""

    kind: str
    shard: int
    offset: int = -1       # byte offset within the shard (-1: whole-shard)
    length: int = 0        # bytes affected at offset (0: n/a)
    detail: str = ""

    @property
    def damages_data(self) -> bool:
        """True when the stored bytes changed at apply() time
        (transient faults never do; torn-write arms only damage the
        FUTURE write they truncate)."""
        return self.kind not in ("transient", "torn_write")


class Injector:
    """Base: apply(store, rng) mutates the store, returns Fault records.

    Subclass fields are TARGETS when set and drawn from ``rng`` when
    None — a fully-pinned injector is deterministic even without the
    seed, a loose one is deterministic GIVEN the seed.
    """

    kind = "?"

    def apply(self, store: ShardStore,
              rng: np.random.Generator) -> List[Fault]:
        raise NotImplementedError

    def _pick_shards(self, store: ShardStore, rng: np.random.Generator,
                     shards: Optional[Sequence[int]], n: int) -> List[int]:
        if shards is not None:
            return [int(s) for s in shards]
        pool = store.shard_ids()
        n = min(n, len(pool))
        return [int(s) for s in rng.choice(pool, size=n, replace=False)]


@dataclass
class ShardErasure(Injector):
    """Delete ``n`` shards (or exactly ``shards``)."""

    shards: Optional[Sequence[int]] = None
    n: int = 1
    kind = "erase"

    def apply(self, store, rng):
        out = []
        for s in self._pick_shards(store, rng, self.shards, self.n):
            store.delete(s)
            out.append(Fault("erase", s, detail="shard deleted"))
        return out


@dataclass
class BitFlip(Injector):
    """Flip ``flips`` random bits in each of ``n`` shards (or the
    pinned ``shards``/``offsets``)."""

    shards: Optional[Sequence[int]] = None
    n: int = 1
    flips: int = 1
    offsets: Optional[Sequence[int]] = None   # pinned byte offsets
    kind = "bitflip"

    def apply(self, store, rng):
        out = []
        for s in self._pick_shards(store, rng, self.shards, self.n):
            buf = store.shards[s]
            if not buf:
                continue
            if self.offsets is not None:
                offs = [int(o) for o in self.offsets]
            else:
                offs = sorted(int(o) for o in rng.choice(
                    len(buf), size=min(self.flips, len(buf)),
                    replace=False))
            for off in offs:
                bit = int(rng.integers(0, 8))
                buf[off] ^= 1 << bit
                out.append(Fault("bitflip", s, offset=off, length=1,
                                 detail=f"bit {bit}"))
        return out


@dataclass
class Truncate(Injector):
    """Cut a shard to ``keep`` bytes (random cut point when None)."""

    shard: Optional[int] = None
    keep: Optional[int] = None
    kind = "truncate"

    def apply(self, store, rng):
        (s,) = self._pick_shards(store, rng,
                                 None if self.shard is None else [self.shard],
                                 1)
        buf = store.shards[s]
        old = len(buf)
        keep = (self.keep if self.keep is not None
                else int(rng.integers(0, max(old, 1))))
        keep = min(keep, old)
        del buf[keep:]
        return [Fault("truncate", s, offset=keep, length=old - keep,
                      detail=f"{old} -> {keep} bytes")]


@dataclass
class ZeroStripe(Injector):
    """Zero stripe ``stripe``'s chunk in EVERY stored shard (random
    stripe when None).  Requires store.chunk_size."""

    stripe: Optional[int] = None
    kind = "zero_stripe"

    def apply(self, store, rng):
        cs = store.chunk_size
        if not cs:
            raise ValueError("ZeroStripe needs store.chunk_size")
        n_stripes = min((len(b) // cs for b in store.shards.values()),
                        default=0)
        if n_stripes == 0:
            return []
        z = (self.stripe if self.stripe is not None
             else int(rng.integers(0, n_stripes)))
        out = []
        for s in store.shard_ids():
            store.shards[s][z * cs:(z + 1) * cs] = b"\x00" * cs
            out.append(Fault("zero_stripe", s, offset=z * cs, length=cs,
                             detail=f"stripe {z}"))
        return out


@dataclass
class TransientErrors(Injector):
    """Arm ``count`` transient read errors on ``n`` shards (no data
    damage — exercises retry, must NOT trip scrub)."""

    shards: Optional[Sequence[int]] = None
    n: int = 1
    count: int = 1
    kind = "transient"

    def apply(self, store, rng):
        out = []
        for s in self._pick_shards(store, rng, self.shards, self.n):
            store.arm_transient(s, self.count)
            out.append(Fault("transient", s,
                             detail=f"{self.count} flaky reads"))
        return out


@dataclass
class TornWrite(Injector):
    """Arm a prefix-only NEXT write on ``n`` shards (or the pinned
    ``shards``): the write-back half of the torn-write fault model.
    ``keep`` bytes survive (when None, a random cut point is drawn per
    shard against the shard's CURRENT length — or chunk_size when the
    shard is absent, the recovery-write case this exists for)."""

    shards: Optional[Sequence[int]] = None
    n: int = 1
    keep: Optional[int] = None
    kind = "torn_write"

    def _candidates(self, store: ShardStore) -> List[int]:
        # unlike the data-damage injectors, torn writes target shards
        # the RECOVERY path will write — absent shards are the usual
        # victims, so draw from the full 0..max-shard range the store
        # has ever seen plus live ids
        pool = set(store.shard_ids()) | set(store.transient)
        return sorted(pool)

    def apply(self, store, rng):
        if self.shards is not None:
            victims = [int(s) for s in self.shards]
        else:
            pool = self._candidates(store)
            nn = min(self.n, len(pool))
            victims = [int(s) for s in
                       rng.choice(pool, size=nn, replace=False)]
        out = []
        for s in victims:
            if self.keep is not None:
                keep = int(self.keep)
            else:
                cur = len(store.shards[s]) if s in store.shards else \
                    (store.chunk_size or 1)
                keep = int(rng.integers(0, max(cur, 1)))
            store.arm_torn_write(s, keep)
            out.append(Fault("torn_write", s, offset=keep,
                             detail=f"next write keeps {keep} bytes"))
        return out


@dataclass
class Compose(Injector):
    """Apply injectors in order (one rng stream threads through all,
    so the composite is as deterministic as its parts)."""

    injectors: Sequence[Injector] = field(default_factory=tuple)
    kind = "compose"

    def apply(self, store, rng):
        out: List[Fault] = []
        for inj in self.injectors:
            out.extend(inj.apply(store, rng))
        return out


def inject(shards_or_store, injectors: Sequence[Injector], seed: int,
           chunk_size: Optional[int] = None
           ) -> Tuple[ShardStore, List[Fault]]:
    """THE entry point: wrap/reuse the store, seed one rng, run the
    injectors in order.  (store, faults) — replayable from (seed,
    injectors) alone."""
    store = ensure_store(shards_or_store, chunk_size=chunk_size)
    rng = np.random.default_rng(seed)
    faults = Compose(tuple(injectors)).apply(store, rng)
    if faults:
        from ..telemetry import metrics as tel
        for f in faults:
            tel.counter("chaos_injections", kind=f.kind)
    return store, faults


def damaged_shards(faults: Sequence[Fault]) -> List[int]:
    """Shard ids whose stored bytes a fault list actually changed —
    the exact set scrub must flag (transient faults excluded)."""
    return sorted({f.shard for f in faults if f.damages_data})


def random_injectors(rng: np.random.Generator, n_faults: int,
                     allow_kinds: Sequence[str] = ("erase", "bitflip",
                                                   "truncate")
                     ) -> List[Injector]:
    """Draw ``n_faults`` independent single-shard injectors — the fuzz
    suite's fault generator.  Shard targets stay unpinned so apply()
    draws DISTINCT victims per fault kind from the live store."""
    mk = {"erase": lambda: ShardErasure(n=1),
          "bitflip": lambda: BitFlip(n=1,
                                     flips=int(rng.integers(1, 4))),
          "truncate": lambda: Truncate(),
          "zero_stripe": lambda: ZeroStripe(),
          "transient": lambda: TransientErrors(
              n=1, count=int(rng.integers(1, 3)))}
    kinds = list(allow_kinds)
    return [mk[kinds[int(rng.integers(0, len(kinds)))]]()
            for _ in range(n_faults)]
