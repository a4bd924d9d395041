"""OSDMap incremental — epoch-ordered map mutation; a copy of
``ceph_tpu/crush/incremental.py``.

Reference: src/osd/OSDMap.h → OSDMap::Incremental and
src/osd/OSDMap.cc → OSDMap::apply_incremental: the mon publishes map
CHANGES as epoch-numbered deltas; every daemon advances its map by
applying each incremental in sequence ("resume" in this system =
OSDMap-epoch catch-up, SURVEY.md §5).  This module carries the
placement-relevant subset of that machinery — osd state/weight/
affinity deltas, pool create/delete, pg_temp / primary_temp / upmap
layer edits, crush map replacement — with upstream's semantics:

- an incremental applies ONLY at epoch == map.epoch + 1 (applying out
  of order or twice raises, as upstream asserts);
- ``new_state`` XORs state bits (CEPH_OSD_EXISTS / CEPH_OSD_UP), which
  is how upstream marks an osd down (xor UP) or purges it;
- an empty ``new_pg_temp`` vector / ``new_primary_temp`` of -1 REMOVE
  the override, mirroring the mon's cleanup messages;
- ``old_pg_upmap_items`` / ``old_pg_upmap`` erase upmap entries.

Out of scope (daemon-side, SURVEY §7): up_thru/last_clean intervals,
blocklists, mon addrs, encode/decode of the incremental wire format.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .osdmap import MAX_PRIMARY_AFFINITY, OSDMap, PGPool
from .types import CrushMap

# osd_types.h → osd state bits (placement-relevant two)
CEPH_OSD_EXISTS = 1
CEPH_OSD_UP = 2

PgId = Tuple[int, int]  # (pool_id, folded pg seed)


@dataclass
class Incremental:
    """OSDMap.h → OSDMap::Incremental (placement subset)."""

    epoch: int
    new_crush: Optional[CrushMap] = None
    new_max_osd: Optional[int] = None
    new_pools: Dict[int, PGPool] = field(default_factory=dict)
    old_pools: List[int] = field(default_factory=list)
    new_weight: Dict[int, int] = field(default_factory=dict)   # 16.16
    new_state: Dict[int, int] = field(default_factory=dict)    # XOR bits
    new_primary_affinity: Dict[int, int] = field(default_factory=dict)
    new_pg_temp: Dict[PgId, List[int]] = field(default_factory=dict)
    new_primary_temp: Dict[PgId, int] = field(default_factory=dict)
    new_pg_upmap: Dict[PgId, List[int]] = field(default_factory=dict)
    old_pg_upmap: List[PgId] = field(default_factory=list)
    new_pg_upmap_items: Dict[PgId, List[Tuple[int, int]]] = \
        field(default_factory=dict)
    old_pg_upmap_items: List[PgId] = field(default_factory=list)


def get_epoch(m: OSDMap) -> int:
    """OSDMap::get_epoch; maps created before this module default 0."""
    return getattr(m, "epoch", 0)


def apply_incremental(m: OSDMap, inc: Incremental) -> None:
    """OSDMap.cc → OSDMap::apply_incremental: advance ``m`` in place.

    Raises ValueError unless inc.epoch == get_epoch(m) + 1 (upstream
    asserts the same monotonic step; stale or future deltas must be
    fetched in order)."""
    cur = get_epoch(m)
    if inc.epoch != cur + 1:
        raise ValueError(
            f"incremental epoch {inc.epoch} does not follow map epoch "
            f"{cur} (apply_incremental requires e+1)")

    if inc.new_crush is not None:
        m.crush = inc.new_crush
        m.invalidate_compiled()

    if inc.new_max_osd is not None:
        n = inc.new_max_osd
        if n < m.max_osd:
            del m.osd_exists[n:]
            del m.osd_up[n:]
            del m.osd_weight[n:]
            if m.osd_primary_affinity is not None:
                del m.osd_primary_affinity[n:]
        else:
            while len(m.osd_exists) < n:
                m.osd_exists.append(False)
                m.osd_up.append(False)
                m.osd_weight.append(0)
                if m.osd_primary_affinity is not None:
                    m.osd_primary_affinity.append(MAX_PRIMARY_AFFINITY)
        m.max_osd = n

    for pid in inc.old_pools:
        m.pools.pop(pid, None)
    m.pools.update(inc.new_pools)

    for osd, w in inc.new_weight.items():
        m.osd_weight[osd] = w
        if w:
            m.osd_exists[osd] = True

    for osd, bits in inc.new_state.items():
        # upstream: int s = new_state ? new_state : CEPH_OSD_UP (a zero
        # value is the legacy "mark down" encoding); destroying an
        # EXISTING osd clears the whole state word (so a later
        # re-create yields exists+down, never a resurrected up), else
        # osd_state[osd] ^= s
        s = bits if bits else CEPH_OSD_UP
        state = ((CEPH_OSD_EXISTS if m.osd_exists[osd] else 0)
                 | (CEPH_OSD_UP if m.osd_up[osd] else 0))
        if (state & CEPH_OSD_EXISTS) and (s & CEPH_OSD_EXISTS):
            state = 0
        else:
            state ^= s
        m.osd_exists[osd] = bool(state & CEPH_OSD_EXISTS)
        m.osd_up[osd] = bool(state & CEPH_OSD_UP)
        if not m.osd_exists[osd]:
            # purged osd loses its overrides (upstream clears weight
            # and affinity with the EXISTS bit)
            m.osd_weight[osd] = 0
            if m.osd_primary_affinity is not None:
                m.osd_primary_affinity[osd] = MAX_PRIMARY_AFFINITY

    for osd, aff in inc.new_primary_affinity.items():
        m.set_primary_affinity(osd, aff)

    for pgid, temp in inc.new_pg_temp.items():
        if temp:
            m.pg_temp[pgid] = list(temp)
        else:
            m.pg_temp.pop(pgid, None)   # empty vector = remove
    for pgid, prim in inc.new_primary_temp.items():
        if prim >= 0:
            m.primary_temp[pgid] = prim
        else:
            m.primary_temp.pop(pgid, None)

    for pgid in inc.old_pg_upmap:
        m.pg_upmap.pop(pgid, None)
    for pgid, full in inc.new_pg_upmap.items():
        m.pg_upmap[pgid] = list(full)  # never alias the delta's lists
    for pgid in inc.old_pg_upmap_items:
        m.pg_upmap_items.pop(pgid, None)
    for pgid, items in inc.new_pg_upmap_items.items():
        m.pg_upmap_items[pgid] = [tuple(i) for i in items]

    m.epoch = inc.epoch


def catch_up(m: OSDMap, incrementals) -> int:
    """Apply a sequence of incrementals in epoch order ("resume" =
    OSDMap-epoch catch-up, SURVEY §5); returns the final epoch.
    Out-of-order entries are sorted first; gaps raise (a daemon must
    fetch the missing epochs)."""
    for inc in sorted(incrementals, key=lambda i: i.epoch):
        if inc.epoch <= get_epoch(m):
            continue  # already have it (duplicate delivery)
        apply_incremental(m, inc)
    return get_epoch(m)
