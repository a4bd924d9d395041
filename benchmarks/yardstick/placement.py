"""The plain placement reference: a configuration's CRUSH map built from
its description, a pool's CRUSH inputs, and the up set and primary of
one placement group of an erasure-coded pool.

The steps follow Ceph's OSDMap::pg_to_up_acting_osds as the project's
``ceph_tpu/crush/osdmap.py`` transcribes it (pg_pool_t::raw_pg_to_pps
with HASHPSPOOL, crush_do_rule, _raw_to_up_osds keeping positional
holes), for the subset a cluster without upmaps, pg_temp or primary
affinity uses.  Imports only the frozen mapper beside it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .crush import types as ct
from .crush.hash import crush_hash32_2
from .crush.mapper import CrushWork, crush_do_rule

NONE = ct.CRUSH_ITEM_NONE

_STEP_OPS = {
    "take": ct.CRUSH_RULE_TAKE,
    "set_choose_tries": ct.CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": ct.CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "chooseleaf_indep": ct.CRUSH_RULE_CHOOSELEAF_INDEP,
    "chooseleaf_firstn": ct.CRUSH_RULE_CHOOSELEAF_FIRSTN,
    "choose_indep": ct.CRUSH_RULE_CHOOSE_INDEP,
    "choose_firstn": ct.CRUSH_RULE_CHOOSE_FIRSTN,
    "emit": ct.CRUSH_RULE_EMIT,
}
TYPES = {"osd": 0, "host": 1, "root": 2}


def host_ids(cluster: dict) -> list:
    """Bucket ids of the hosts, -1 downwards; the root's follows."""
    return [-(h + 1) for h in range(cluster["hosts"])]


def root_id(cluster: dict) -> int:
    return -(cluster["hosts"] + 1)


def host_devices(cluster: dict, h: int) -> list:
    d = cluster["osds_per_host"]
    return list(range(h * d, (h + 1) * d))


def build_map(cluster: dict) -> ct.CrushMap:
    """root -> host -> osd, every bucket straw2, every OSD of weight
    ``osd_weight`` (16.16), the tunables and the rule as stated."""
    cmap = ct.CrushMap(tunables=ct.Tunables(**cluster["tunables"]))
    cmap.type_names = {v: k for k, v in TYPES.items()}
    alg = ct.BUCKET_ALG_IDS[cluster["bucket_alg"]]
    w = cluster["osd_weight"]
    hosts = host_ids(cluster)
    for h, bid in enumerate(hosts):
        devs = host_devices(cluster, h)
        cmap.buckets[bid] = ct.Bucket(
            id=bid, type=TYPES["host"], alg=alg, weight=w * len(devs),
            items=devs, item_weights=[w] * len(devs))
    hw = [cmap.buckets[b].weight for b in hosts]
    rid = root_id(cluster)
    cmap.buckets[rid] = ct.Bucket(id=rid, type=TYPES["root"], alg=alg,
                                  weight=sum(hw), items=hosts,
                                  item_weights=hw)
    cmap.item_names[rid] = cluster["root"]
    cmap.max_devices = cluster["hosts"] * cluster["osds_per_host"]
    steps = []
    for step in cluster["rule"]["steps"]:
        op, args = _STEP_OPS[step[0]], list(step[1:])
        if step[0] == "take":
            args = [rid]
        args = [TYPES.get(a, a) for a in args] + [0, 0]
        steps.append((op, int(args[0]), int(args[1])))
    cmap.rules[0] = ct.Rule(rule_id=0, type=ct.RULE_TYPE_ERASURE,
                            steps=steps, name=cluster["rule"]["name"])
    return cmap


def stable_mod(x: int, b: int, bmask: int) -> int:
    """include/rados.h -> ceph_stable_mod."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def pg_mask(n: int) -> int:
    return 0 if n <= 1 else (1 << (n - 1).bit_length()) - 1


def pps(pool: dict, ps: int) -> int:
    """pg_pool_t::raw_pg_to_pps with HASHPSPOOL: the CRUSH input of pg
    ``ps``."""
    pgp = pool.get("pgp_num", pool["pg_num"])
    return int(crush_hash32_2(stable_mod(ps, pgp, pg_mask(pgp)),
                              pool["pool_id"] & 0xFFFFFFFF))


class Placement:
    """Up sets of one erasure-coded pool on a configuration's map, for
    given OSD states."""

    def __init__(self, cluster: dict, pool: dict) -> None:
        self.cmap = build_map(cluster)
        self.pool = pool
        self.work = CrushWork(self.cmap)

    def up(self, ps: int, osd_up: Sequence[bool],
           osd_weight: Sequence[int]) -> Tuple[list, int]:
        """(up set with NONE holes kept in place, primary or -1)."""
        size = self.pool["size"]
        raw = crush_do_rule(self.cmap, 0, pps(self.pool, ps), size,
                            weight=list(osd_weight), work=self.work)
        raw = list(raw) + [NONE] * (size - len(raw))
        up = [o if o != NONE and 0 <= o < len(osd_up) and osd_up[o]
              else NONE for o in raw]
        primary = next((o for o in up if o != NONE), -1)
        return up, primary


__all__ = ["NONE", "Placement", "build_map", "host_devices", "host_ids",
           "pps", "root_id"]
