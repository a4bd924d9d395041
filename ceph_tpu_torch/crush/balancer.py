"""upmap balancer — OSDMap::calc_pg_upmaps analog over the bulk
evaluator; a copy of ``ceph_tpu.crush.balancer``.

Reference: src/osd/OSDMap.cc → OSDMap::calc_pg_upmaps (the mgr
balancer module's upmap mode, src/pybind/mgr/balancer/module.py, calls
this): iteratively move pg replicas from the most-overfull osd to the
most-underfull osd via pg_upmap_items entries, subject to the CRUSH
rule's failure-domain constraint, until per-osd deviation from the
weight-proportional target is within ``max_deviation``.

Bulk-first: the cluster-wide placement scan — the expensive part
upstream (pg_num × do_rule) — is ONE bulk evaluator call per pool
(OSDMap.pg_to_raw_bulk, on the map's device); candidate moves are then
validated against the sparse up-sets on the host.  This is the "balancer-style bulk remap
scoring" consumer the bulk path exists for.

Simplifications vs upstream, by design: candidate selection is
first-fit over the overfull osd's pgs (upstream shuffles); no
stddev-improvement early-exit heuristics.  Multi-pool aggregation
(only_pools semantics) IS implemented — see calc_pg_upmaps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .osdmap import OSDMap
from .types import (
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_TAKE,
    CrushMap,
)


def parent_map(cmap: CrushMap) -> Dict[int, int]:
    """child item -> containing bucket id, one O(buckets) pass."""
    parents: Dict[int, int] = {}
    for bid, b in cmap.buckets.items():
        for item in b.items:
            parents[item] = bid
    return parents


def ancestor_of_type(cmap: CrushMap, item: int, type_id: int,
                     parents: Optional[Dict[int, int]] = None
                     ) -> Optional[int]:
    """Walk up the hierarchy to the ancestor bucket of ``type_id``
    (CrushWrapper::get_parent_of_type).  Pass a precomputed
    ``parent_map(cmap)`` when calling in a loop."""
    if parents is None:
        parents = parent_map(cmap)
    cur: Optional[int] = item
    while cur is not None:
        if cur < 0 and cmap.buckets[cur].type == type_id:
            return cur
        cur = parents.get(cur)
    return None


def rule_failure_domain(cmap: CrushMap, ruleno: int) -> int:
    """The choose type of the rule's (first) choose step — the level
    replicas must not share (0 = osd, i.e. no constraint)."""
    for op, _, arg2 in cmap.rules[ruleno].steps:
        if op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
                  CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP):
            if arg2 != 0:
                return arg2
    return 0


def osd_crush_weights(cmap: CrushMap) -> np.ndarray:
    """Per-osd 16.16 crush weight (leaf weights summed over the tree —
    an osd referenced from several buckets counts once per reference,
    like get_rule_weight_osd_map's flattening)."""
    w = np.zeros(cmap.max_devices, dtype=np.float64)
    seen = set()
    for bid, b in cmap.buckets.items():
        if cmap.shadow_of(bid):
            continue  # shadow trees duplicate the device leaves
        for item, iw in zip(b.items, b.item_weights):
            if item >= 0 and (bid, item) not in seen:
                seen.add((bid, item))
                w[item] += iw
    return w


def rule_weight_osd_map(cmap: CrushMap, ruleno: int) -> np.ndarray:
    """Per-osd weight reachable from the rule's TAKE subtree(s) —
    CrushWrapper::get_rule_weight_osd_map.  An osd outside every TAKE
    subtree gets weight 0: the rule can never place a replica there,
    so the balancer must neither count it toward the target nor pick
    it as a move destination (on a multi-root or device-class map the
    global tree weights would do exactly that)."""
    w = np.zeros(cmap.max_devices, dtype=np.float64)
    for op, arg1, _ in cmap.rules[ruleno].steps:
        if op != CRUSH_RULE_TAKE:
            continue
        if arg1 >= 0:
            w[arg1] += 1.0
            continue
        queue = [arg1]
        while queue:
            b = cmap.buckets[queue.pop()]
            for item, iw in zip(b.items, b.item_weights):
                if item >= 0:
                    w[item] += iw / 0x10000
                else:
                    queue.append(item)
    return w


def calc_pg_upmaps(m: OSDMap, pool_id=None, max_deviation: float = 1.0,
                   max_iterations: int = 100, engine: str = "bulk",
                   on_iteration=None
                   ) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
    """Propose (and apply to ``m``) pg_upmap_items entries flattening
    per-osd replica counts.  Returns the new entries.

    ``pool_id``: a single pool id, a list of ids, or None = every pool
    — multi-pool mode aggregates combined per-osd counts against the
    SUM of per-pool targets, each pool's target spread over the osds
    its rule's TAKE subtree can reach (get_rule_weight_osd_map), which
    is OSDMap::calc_pg_upmaps' only_pools behavior on multi-root /
    device-class maps.  Done when every osd's count is within
    ``max_deviation`` of its target or no further legal move exists.

    ``on_iteration(i, dev)``: observer called at the top of every
    iteration with the per-osd deviation vector (read-only) — the
    cluster balance loop's convergence trajectory hook.

    Scaling: stage-1 CRUSH placement is evaluated ONCE per pool
    (``engine`` selects bulk/host; the bulk engine runs on the map's
    device) and cached; an applied move re-derives only the
    moved pg's row host-side (OSDMap.up_row_from_raw — upmap layers
    apply after stage 1, so the cache never staled) and updates the
    per-osd counts incrementally.  At 10k OSDs this turns the old
    O(pg_num) full re-evaluate + recount per probe into O(width)."""
    if pool_id is None:
        pool_ids = sorted(m.pools)
    elif isinstance(pool_id, int):
        pool_ids = [pool_id]
    else:
        pool_ids = sorted(pool_id)
    # per-pool reachable-osd weights from each pool rule's TAKE
    # subtree (get_rule_weight_osd_map): on multi-root or device-class
    # maps the global tree weights would target — and propose moves
    # onto — osds the pool's rule can never reach (ADVICE r03)
    rule_w: Dict[int, np.ndarray] = {}
    for pid in pool_ids:
        w = rule_weight_osd_map(m.crush, m.pools[pid].crush_rule)
        # out/down osds take no replicas and no target share
        for o in range(m.max_osd):
            if m.is_out(o) or not m.is_up(o):
                w[o] = 0.0
        rule_w[pid] = w
    pool_ids = [pid for pid in pool_ids if rule_w[pid].sum() > 0]
    if not pool_ids:
        return {}

    # osd -> failure-domain ancestor per pool rule, precomputed once
    # (the inner loop otherwise re-walks the hierarchy per candidate)
    parents = parent_map(m.crush)
    fd_types = {pid: rule_failure_domain(m.crush,
                                         m.pools[pid].crush_rule)
                for pid in pool_ids}
    fd_of_by_type: Dict[int, Dict[int, Optional[int]]] = {}
    for fdt in sorted(set(fd_types.values()), key=lambda t: t or 0):
        if fdt:
            fd_of_by_type[fdt] = {
                o: ancestor_of_type(m.crush, o, fdt, parents)
                for o in range(m.max_osd)}

    changes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}

    def row_counts(row):
        return [int(o) for o in row
                if o != CRUSH_ITEM_NONE and int(o) >= 0]

    # evaluate every pool's raw CRUSH placement ONCE (the expensive
    # stage — one bulk device call per pool); the sparse override
    # layers apply after it, so an applied move only re-derives the
    # moved pg's row from the cached raw result
    raws: Dict[int, np.ndarray] = {}
    ppss: Dict[int, np.ndarray] = {}
    ups: Dict[int, np.ndarray] = {}
    counts = np.zeros(m.max_osd, dtype=np.float64)
    placed_by_pool: Dict[int, int] = {}
    for pid in pool_ids:
        raws[pid], ppss[pid] = m.pg_to_raw_bulk(pid, engine=engine)
        up = m.pg_to_up_bulk(pid, engine=engine, raw=raws[pid],
                             pps=ppss[pid])[0]
        ups[pid] = up
        flat = up.ravel()
        placed = flat[(flat != CRUSH_ITEM_NONE) & (flat >= 0)]
        counts += np.bincount(placed, minlength=m.max_osd)
        placed_by_pool[pid] = len(placed)
    # each pool's replicas spread over ITS rule's reachable osds; the
    # aggregate target is the sum of per-pool targets (the only_pools
    # aggregation upstream does per-pool via pgs_by_osd + rule weight
    # maps).  Loop-invariant: moves relocate replicas, never add or
    # drop them.
    target = np.zeros(m.max_osd, dtype=np.float64)
    for pid in pool_ids:
        target += (rule_w[pid] / rule_w[pid].sum()
                   * placed_by_pool[pid])

    def apply_move(pid: int, ps: int) -> None:
        """Incremental refresh: overlay the moved pg's cached raw row
        and swap its count contribution — byte-identical to a full
        re-evaluate (stage 1 is upmap-invariant; the overlay IS the
        bulk path's own sparse-override stage)."""
        pool = m.pools[pid]
        up = ups[pid]
        for o in row_counts(up[ps]):
            counts[o] -= 1
        u, _prim = m.up_row_from_raw(pool, ps, raws[pid][ps],
                                     int(ppss[pid][ps]))
        if len(u) > up.shape[1]:
            wider = np.full((pool.pg_num, len(u)), CRUSH_ITEM_NONE,
                            np.int32)
            wider[:, :up.shape[1]] = up
            ups[pid] = up = wider
        up[ps] = u + [CRUSH_ITEM_NONE] * (up.shape[1] - len(u))
        for o in row_counts(u):
            counts[o] += 1

    for it in range(max_iterations):
        dev = counts - target
        # ignore osds no pool can reach
        dev[target == 0] = 0.0
        if on_iteration is not None:
            on_iteration(it, dev)
        if dev.max() <= max_deviation and dev.min() >= -max_deviation:
            break
        over = int(np.argmax(dev))
        move = None
        for pid in pool_ids:
            if rule_w[pid][over] <= 0:
                continue            # this pool's rule can't reach over
            fdt = fd_types[pid]
            move = _find_move(m, m.pools[pid], ups[pid], over, dev, fdt,
                              fd_of_by_type.get(fdt, {}), rule_w[pid])
            if move is not None:
                ps, under = move
                key = (pid, m.pools[pid].raw_pg_to_pg(ps))
                entry = m.pg_upmap_items.setdefault(key, [])
                entry.append((over, under))
                changes[key] = list(entry)
                apply_move(pid, ps)
                break
        if move is None:
            break
    return changes


def _find_move(m: OSDMap, pool, up: np.ndarray, over: int,
               dev: np.ndarray, fd_type: int,
               fd_of: Dict[int, Optional[int]],
               pool_w: np.ndarray) -> Optional[Tuple[int, int]]:
    """First pg on the overfull osd that can legally shed a replica to
    the most-underfull compatible osd: target reachable by this pool's
    rule, not already in the pg, and in a failure domain distinct from
    the remaining replicas'."""
    order = np.argsort(dev)             # most underfull first
    # only pgs actually holding a replica on the overfull osd
    candidates = np.nonzero((up == over).any(axis=1))[0]
    for ps in candidates:
        ps = int(ps)
        members = [int(o) for o in up[ps] if o != CRUSH_ITEM_NONE]
        key = (pool.pool_id, pool.raw_pg_to_pg(ps))
        if any(f == over or t == over
               for f, t in m.pg_upmap_items.get(key, [])):
            continue                    # don't stack moves on one pg
        others = [o for o in members if o != over]
        other_domains = {fd_of[o] for o in others} if fd_type else set()
        for under in order:
            under = int(under)
            if dev[under] >= -1e-9 or under == over:
                break                   # nothing meaningfully underfull
            if pool_w[under] <= 0:
                continue                # outside this rule's subtree
            if under in members or not m.is_up(under) or m.is_out(under):
                continue
            if fd_type and fd_of[under] in other_domains:
                continue                # would double up a failure domain
            return ps, under
    return None
