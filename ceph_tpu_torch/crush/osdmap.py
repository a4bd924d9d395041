"""OSDMap analog — the pg → OSD placement pipeline above CRUSH; a copy
of ``ceph_tpu.crush.osdmap`` whose bulk path is the port's evaluator.

Reference: src/osd/OSDMap.{h,cc} → OSDMap::pg_to_up_acting_osds =
_pg_to_raw_osds (pps seed from pg_pool_t::raw_pg_to_pps, then
crush->do_rule) → _apply_upmap (pg-upmap / pg-upmap-items) →
_raw_to_up_osds → _apply_primary_affinity → pg_temp / primary_temp
(SURVEY.md §3.4); src/osd/osd_types.{h,cc} → pg_t, pg_pool_t
(raw_pg_to_pg / raw_pg_to_pps / calc_pg_masks), ceph_stable_mod.

Bulk addition: ``pg_to_up_bulk`` evaluates EVERY pg of a pool in
one call — pps seeds vectorized (numpy rjenkins), raw placements through
the bulk evaluator (crush/bulk.py) on the map's ``device`` (the card
unless the caller asks for the CPU), then the sparse override
layers (upmap, temp) applied host-side where they live naturally (they
are small dicts).  This is the balancer's inner loop: score a whole
cluster remap in one shot instead of `pg_num` serial do_rule calls.

Simplifications vs upstream, by design:
- osd state is (exists, up, weight, primary_affinity) flat lists;
  epoch-ordered mutation (OSDMap::Incremental / apply_incremental —
  the mon's publication model and "resume = epoch catch-up") lives in
  crush/incremental.py.
- pg ids are (pool_id, ps) tuples, not the full pg_t wire struct.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hash import crush_hash32_2
from .mapper import crush_do_rule
from .types import CRUSH_ITEM_NONE, CrushMap, RULE_TYPE_REPLICATED

# osd_types.h → CEPH_OSD_MAX_PRIMARY_AFFINITY / DEFAULT (16.16 unit)
MAX_PRIMARY_AFFINITY = 0x10000
IN_WEIGHT = 0x10000


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """include/rados.h → ceph_stable_mod: mod that remains stable as b
    grows through non-powers-of-two (pg splitting)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def pg_mask(n: int) -> int:
    """osd_types.cc → pg_pool_t::calc_pg_masks: smallest 2^k-1 >= n-1."""
    if n <= 1:
        return 0
    return (1 << (n - 1).bit_length()) - 1


@dataclass
class PGPool:
    """osd_types.h → pg_pool_t (placement-relevant subset)."""

    pool_id: int
    pg_num: int
    size: int = 3
    min_size: int = 2
    crush_rule: int = 0
    pgp_num: Optional[int] = None       # defaults to pg_num
    erasure: bool = False               # TYPE_ERASURE: holes preserved
    hashpspool: bool = True             # FLAG_HASHPSPOOL (default on)

    def __post_init__(self) -> None:
        if self.pgp_num is None:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return pg_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return pg_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """osd_types.h → pg_pool_t::can_shift_osds: replicated pools
        compact holes; erasure pools keep positional NONEs."""
        return not self.erasure

    def raw_pg_to_pg(self, ps: int) -> int:
        """osd_types.cc → pg_pool_t::raw_pg_to_pg (seed fold)."""
        return ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, ps: int) -> int:
        """osd_types.cc → pg_pool_t::raw_pg_to_pps: the CRUSH input.

        HASHPSPOOL (default): hash the folded seed WITH the pool so
        pools with the same rule land on different osd sequences."""
        if self.hashpspool:
            return int(crush_hash32_2(
                ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask),
                self.pool_id & 0xFFFFFFFF))
        return ceph_stable_mod(ps, self.pgp_num,
                               self.pgp_num_mask) + self.pool_id

    def pps_all(self) -> np.ndarray:
        """Vectorized raw_pg_to_pps for ps = 0..pg_num-1 (bulk path)."""
        ps = np.arange(self.pg_num, dtype=np.int64)
        folded = np.where((ps & self.pgp_num_mask) < self.pgp_num,
                          ps & self.pgp_num_mask,
                          ps & (self.pgp_num_mask >> 1))
        if self.hashpspool:
            # the hash works over uint32 arrays (wraparound semantics)
            return crush_hash32_2(
                folded.astype(np.uint32),
                np.uint32(self.pool_id & 0xFFFFFFFF)).astype(np.int64)
        return folded + self.pool_id


@dataclass
class OSDMap:
    """src/osd/OSDMap.h → OSDMap (placement-relevant subset)."""

    crush: CrushMap
    epoch: int = 0            # OSDMap::get_epoch; advanced by
                              # incremental.apply_incremental
    pools: Dict[int, PGPool] = field(default_factory=dict)
    max_osd: int = 0
    # per-osd state vectors (OSDMap: osd_state / osd_weight /
    # osd_primary_affinity)
    osd_exists: List[bool] = field(default_factory=list)
    osd_up: List[bool] = field(default_factory=list)
    osd_weight: List[int] = field(default_factory=list)       # 16.16 out
    osd_primary_affinity: Optional[List[int]] = None          # 16.16
    # override layers, keyed by (pool_id, folded pg seed)
    pg_upmap: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    pg_upmap_items: Dict[Tuple[int, int], List[Tuple[int, int]]] = \
        field(default_factory=dict)
    pg_temp: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    primary_temp: Dict[Tuple[int, int], int] = field(default_factory=dict)
    choose_args_name: Optional[str] = None
    # where the bulk path runs: None = the card, "cpu" = the CPU
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if not self.max_osd:
            self.max_osd = self.crush.max_devices
        for vec, fill in ((self.osd_exists, True), (self.osd_up, True),
                          (self.osd_weight, IN_WEIGHT)):
            while len(vec) < self.max_osd:
                vec.append(fill)

    # -- state helpers (OSDMap::exists / is_up / is_down) ----------------

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and self.osd_exists[osd]

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_up[osd]

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == 0

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = [MAX_PRIMARY_AFFINITY] * self.max_osd
        self.osd_primary_affinity[osd] = aff

    def _choose_args(self):
        if self.choose_args_name is None:
            return None
        return self.crush.choose_args[self.choose_args_name]

    def _compiled_map(self):
        """Lazily-built CompiledCrushMap reused across bulk calls (its
        tables live on the device; rebuilding per call would upload them
        again).  Call invalidate_compiled() after editing the crush
        hierarchy or switching choose_args_name."""
        cm = self.__dict__.get("_compiled")
        if cm is None or cm.cmap is not self.crush \
                or cm.choose_args is not self._choose_args():
            from .bulk import CompiledCrushMap
            cm = CompiledCrushMap(self.crush, self._choose_args(),
                                  device=self.device)
            self.__dict__["_compiled"] = cm
        return cm

    def invalidate_compiled(self) -> None:
        self.__dict__.pop("_compiled", None)

    # -- stage 1: raw CRUSH placement (OSDMap::_pg_to_raw_osds) ----------

    def pg_to_raw_osds(self, pool_id: int, ps: int) -> Tuple[List[int], int]:
        """(raw osd vector, pps seed)."""
        pool = self.pools[pool_id]
        pps = pool.raw_pg_to_pps(ps)
        raw = crush_do_rule(self.crush, pool.crush_rule, pps, pool.size,
                            weight=list(self.osd_weight),
                            choose_args=self._choose_args())
        return raw, pps

    # -- stage 2: upmap overrides (OSDMap::_apply_upmap) -----------------

    def _apply_upmap(self, pool: PGPool, pg_seed: int,
                     raw: List[int]) -> List[int]:
        key = (pool.pool_id, pg_seed)
        full = self.pg_upmap.get(key)
        if full:
            # reject wholesale iff a target is marked out (OSDMap.cc
            # checks only in-range osds with weight 0)
            for osd in full:
                if (osd != CRUSH_ITEM_NONE and 0 <= osd < self.max_osd
                        and self.osd_weight[osd] == 0):
                    return raw
            return list(full)
        items = self.pg_upmap_items.get(key)
        if items:
            raw = list(raw)
            for osd_from, osd_to in items:
                if osd_to in raw:
                    continue        # target already holds a replica
                for i, osd in enumerate(raw):
                    if osd == osd_from:
                        if (osd_to != CRUSH_ITEM_NONE
                                and 0 <= osd_to < self.max_osd
                                and self.osd_weight[osd_to] == 0):
                            break   # target marked out: ignore this pair
                        raw[i] = osd_to
                        break       # first occurrence only
        return raw

    # -- stage 3: up-set from raw (OSDMap::_raw_to_up_osds) --------------

    def _raw_to_up_osds(self, pool: PGPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw
                    if o != CRUSH_ITEM_NONE and self.is_up(o)]
        return [o if o != CRUSH_ITEM_NONE and self.is_up(o)
                else CRUSH_ITEM_NONE for o in raw]

    # -- stage 4: primary affinity (OSDMap::_apply_primary_affinity) -----

    def _pick_primary(self, osds: Sequence[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, pps: int, pool: PGPool,
                                osds: List[int]) -> Tuple[List[int], int]:
        aff = self.osd_primary_affinity
        primary = self._pick_primary(osds)
        if aff is None or primary < 0:
            return osds, primary
        if all(aff[o] == MAX_PRIMARY_AFFINITY
               for o in osds if o != CRUSH_ITEM_NONE):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if a < MAX_PRIMARY_AFFINITY and \
                    (int(crush_hash32_2(pps, o)) >> 16) >= a:
                # hash draw says skip; remember the first as fallback
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            # move the chosen primary to the front, preserving order
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    # -- stage 5: temp overrides (OSDMap::_get_temp_osds) ----------------

    def _get_temp_osds(self, pool: PGPool, pg_seed: int
                       ) -> Tuple[Optional[List[int]], int]:
        key = (pool.pool_id, pg_seed)
        temp = self.pg_temp.get(key)
        temp_pg = None
        if temp:
            if pool.can_shift_osds():
                temp_pg = [o for o in temp if self.exists(o)] or None
            else:
                # positional EC pools: a dne osd leaves a NONE hole in
                # its shard slot (OSDMap.cc: "NONE takes over for a dne
                # osd"), never shifting later shards
                temp_pg = [o if o == CRUSH_ITEM_NONE or self.exists(o)
                           else CRUSH_ITEM_NONE for o in temp]
        temp_primary = self.primary_temp.get(key, -1)
        if temp_primary < 0 and temp_pg:
            temp_primary = self._pick_primary(temp_pg)
        return temp_pg, temp_primary

    # -- the public pipeline (OSDMap::pg_to_up_acting_osds) --------------

    def pg_to_up_acting_osds(self, pool_id: int, ps: int
                             ) -> Tuple[List[int], int, List[int], int]:
        """(up, up_primary, acting, acting_primary) for pg = pool.ps."""
        pool = self.pools[pool_id]
        pg_seed = pool.raw_pg_to_pg(ps)
        raw, pps = self.pg_to_raw_osds(pool_id, ps)
        raw = self._apply_upmap(pool, pg_seed, raw)
        up = self._raw_to_up_osds(pool, raw)
        up, up_primary = self._apply_primary_affinity(pps, pool, up)
        temp_pg, temp_primary = self._get_temp_osds(pool, pg_seed)
        acting = list(temp_pg) if temp_pg is not None else list(up)
        acting_primary = temp_primary if temp_primary >= 0 else up_primary
        return up, up_primary, acting, acting_primary

    # -- bulk path: every pg of a pool in one device call ----------------

    def pg_to_raw_bulk(self, pool_id: int, engine: str = "bulk"
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Stage 1 for the whole pool: (raw (pg_num, W) int64 with
        positional NONE holes, pps (pg_num,)).  Exposed separately so
        callers that mutate ONLY the sparse override layers — the
        balancer's move loop — can cache it and re-derive single rows
        host-side (up_row_from_raw) without re-evaluating CRUSH."""
        pool = self.pools[pool_id]
        pps = pool.pps_all()
        if engine == "sharded":
            # the whole-pool sweep sharded over every visible member of
            # the map's device kind
            from ..parallel.sharded_crush import (default_crush_mesh,
                                                  sharded_bulk_do_rule)
            cm = self._compiled_map()
            raw_arr, _ = sharded_bulk_do_rule(
                default_crush_mesh(kind=cm.device.type), cm,
                pool.crush_rule, pps, pool.size,
                weight=list(self.osd_weight))
        elif engine == "bulk":
            from .bulk import bulk_do_rule
            raw_arr, _ = bulk_do_rule(
                self._compiled_map(), pool.crush_rule, pps, pool.size,
                weight=list(self.osd_weight))
        else:
            raw_arr = np.full((pool.pg_num, pool.size), CRUSH_ITEM_NONE,
                              np.int32)
            for i, x in enumerate(pps):
                r = crush_do_rule(self.crush, pool.crush_rule, int(x),
                                  pool.size, weight=list(self.osd_weight),
                                  choose_args=self._choose_args())
                raw_arr[i, :len(r)] = r
        return np.asarray(raw_arr, dtype=np.int64), pps

    def up_row_from_raw(self, pool: PGPool, ps: int, raw_row,
                        pps_val: int) -> Tuple[List[int], int]:
        """Scalar stages 2–4 over ONE pg's cached raw placement:
        (up list, up_primary).  The sparse-override path of
        pg_to_up_bulk and the balancer's incremental row refresh share
        this — the raw CRUSH result is invariant under upmap edits, so
        a move only ever needs this host-side overlay."""
        row = [int(o) for o in raw_row]
        if pool.can_shift_osds():
            # replicated raw results are variable-length; drop the
            # array padding (EC keeps positional NONE holes)
            row = [o for o in row if o != CRUSH_ITEM_NONE]
        raw = self._apply_upmap(pool, pool.raw_pg_to_pg(ps), row)
        u = self._raw_to_up_osds(pool, raw)
        return self._apply_primary_affinity(int(pps_val), pool, u)

    def pg_to_up_bulk(self, pool_id: int, engine: str = "bulk",
                      raw: Optional[np.ndarray] = None,
                      pps: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(up (pg_num, size) int32 with NONE holes kept positional,
        up_primary (pg_num,)) for every pg of the pool.

        Raw placements run through the bulk evaluator (crush/bulk.py,
        engine="bulk") on the map's device, or the host mapper
        (engine="host"); the sparse upmap/affinity layers are then
        applied host-side, mirroring the scalar pipeline exactly.
        pg_temp/primary_temp (the acting overrides) are NOT applied
        here — see pg_to_up_acting_bulk.  ``raw``/``pps``: a cached
        pg_to_raw_bulk result to overlay instead of re-evaluating
        (upmap layers apply AFTER stage 1, so the cache stays valid
        across upmap edits)."""
        pool = self.pools[pool_id]
        if raw is None or pps is None:
            raw_arr, pps = self.pg_to_raw_bulk(pool_id, engine=engine)
        else:
            raw_arr = np.asarray(raw, dtype=np.int64)

        # sparse layer: the few pgs with upmap entries take the scalar
        # stages (and may widen the arrays past pool.size)
        overrides: Dict[int, Tuple[List[int], int]] = {}
        touched = {seed for pid, seed in self.pg_upmap if pid == pool_id}
        touched |= {seed for pid, seed in self.pg_upmap_items
                    if pid == pool_id}
        # for ps in [0, pg_num), raw_pg_to_pg(ps) == ps (the stable-mod
        # fold only matters for raw seeds beyond pg_num), so pgs with
        # upmap entries are exactly the entry seeds themselves
        for ps in sorted(t for t in touched if 0 <= t < pool.pg_num):
            overrides[ps] = self.up_row_from_raw(pool, ps, raw_arr[ps],
                                                 int(pps[ps]))

        up, up_primary = self._bulk_up_from_raw(pool, raw_arr, pps)
        width = max([up.shape[1]]
                    + [len(u) for u, _ in overrides.values()])
        if width > up.shape[1]:
            wider = np.full((pool.pg_num, width), CRUSH_ITEM_NONE,
                            np.int32)
            wider[:, :up.shape[1]] = up
            up = wider
        for ps, (u, prim) in overrides.items():
            up[ps] = u + [CRUSH_ITEM_NONE] * (width - len(u))
            up_primary[ps] = prim
        return up, up_primary

    def _bulk_up_from_raw(self, pool: PGPool, raw: np.ndarray,
                          pps: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized _raw_to_up_osds + _apply_primary_affinity over a
        whole pool: (N, W) raw placements -> (up, up_primary).  Exact
        per-row equivalence with the scalar stages is pinned by
        tests/test_torch_osdmap.py."""
        n, w = raw.shape
        alive = (np.asarray(self.osd_exists[:self.max_osd], dtype=bool)
                 & np.asarray(self.osd_up[:self.max_osd], dtype=bool))
        idx = np.clip(raw, 0, self.max_osd - 1)
        valid = (raw != CRUSH_ITEM_NONE) & (raw >= 0) & \
                (raw < self.max_osd) & alive[idx]
        if pool.can_shift_osds():
            # stable left-compaction of valid entries (replicated pools)
            order = np.argsort(~valid, axis=1, kind="stable")
            up = np.where(np.take_along_axis(valid, order, axis=1),
                          np.take_along_axis(raw, order, axis=1),
                          CRUSH_ITEM_NONE).astype(np.int32)
        else:
            up = np.where(valid, raw, CRUSH_ITEM_NONE).astype(np.int32)

        uvalid = up != CRUSH_ITEM_NONE
        any_valid = uvalid.any(axis=1)
        first_valid = np.argmax(uvalid, axis=1)
        up_primary = np.where(
            any_valid,
            np.take_along_axis(
                up, first_valid[:, None], axis=1)[:, 0],
            -1).astype(np.int32)

        aff_vec = self.osd_primary_affinity
        if aff_vec is None:
            return up, up_primary
        aff = np.asarray(aff_vec + [MAX_PRIMARY_AFFINITY]
                         * (self.max_osd - len(aff_vec)), dtype=np.int64)
        uidx = np.clip(up, 0, self.max_osd - 1)
        a = np.where(uvalid, aff[uidx], MAX_PRIMARY_AFFINITY)
        rows = uvalid & (a != MAX_PRIMARY_AFFINITY)
        affected = rows.any(axis=1) & any_valid
        if not affected.any():
            return up, up_primary
        # keep osd at position j iff a == MAX or hash(pps, o) >> 16 < a
        draws = (crush_hash32_2(
            np.broadcast_to(pps[:, None], up.shape).astype(np.uint32),
            up.astype(np.uint32)).astype(np.int64) >> 16)
        keep = uvalid & ((a >= MAX_PRIMARY_AFFINITY) | (draws < a))
        any_keep = keep.any(axis=1)
        first_keep = np.argmax(keep, axis=1)
        # scalar semantics: first kept position wins; else the first
        # valid position is the fallback
        pos = np.where(any_keep, first_keep, first_valid)
        sel = affected  # affected rows always have a valid fallback
        new_primary = np.take_along_axis(up, pos[:, None], axis=1)[:, 0]
        up_primary = np.where(sel, new_primary, up_primary).astype(np.int32)
        if pool.can_shift_osds():
            # rotate the chosen primary to the front (rows with pos>0)
            rot = sel & (pos > 0)
            if rot.any():
                cols = np.arange(w)[None, :]
                p = pos[:, None]
                src = np.where(cols == 0, p,
                               np.where(cols <= p, cols - 1, cols))
                rotated = np.take_along_axis(up, src, axis=1)
                up = np.where(rot[:, None], rotated, up)
        return up, up_primary

    def pg_to_up_acting_bulk(self, pool_id: int, engine: str = "bulk"
                             ) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
        """Bulk pg_to_up_acting_osds over the whole pool: (up,
        up_primary, acting, acting_primary) arrays.  The acting array
        is wide enough for the longest pg_temp override (the scalar
        path returns oversized temp lists verbatim; nothing is
        truncated), padded with NONE."""
        pool = self.pools[pool_id]
        up, up_primary = self.pg_to_up_bulk(pool_id, engine=engine)
        temps = {}
        for ps in range(pool.pg_num):
            temp_pg, temp_primary = self._get_temp_osds(
                pool, pool.raw_pg_to_pg(ps))
            if temp_pg is not None or temp_primary >= 0:
                temps[ps] = (temp_pg, temp_primary)
        width = max([up.shape[1]] + [len(t[0]) for t in temps.values()
                                     if t[0] is not None])
        acting = np.full((pool.pg_num, width), CRUSH_ITEM_NONE, np.int32)
        acting[:, :up.shape[1]] = up
        acting_primary = up_primary.copy()
        for ps, (temp_pg, temp_primary) in temps.items():
            if temp_pg is not None:
                acting[ps] = list(temp_pg) + \
                    [CRUSH_ITEM_NONE] * (width - len(temp_pg))
            if temp_primary >= 0:
                acting_primary[ps] = temp_primary
            # temp_primary < 0 means _get_temp_osds found no usable
            # primary in the temp list (e.g. all-NONE): keep the
            # up_primary fallback, matching pg_to_up_acting_osds
        return up, up_primary, acting, acting_primary

    # -- distribution scoring (balancer building block) ------------------

    def pg_counts_per_osd(self, pool_id: int, engine: str = "bulk"
                          ) -> np.ndarray:
        """Number of pg replicas mapped to each osd (the balancer's
        objective input)."""
        up, _ = self.pg_to_up_bulk(pool_id, engine=engine)
        flat = up.ravel()
        flat = flat[(flat != CRUSH_ITEM_NONE) & (flat >= 0)]
        return np.bincount(flat, minlength=self.max_osd)
