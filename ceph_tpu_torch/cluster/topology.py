"""Synthetic production-shape clusters — the 10k-OSD workload factory;
a copy of ``ceph_tpu/cluster/topology.py`` whose maps carry a device.

Reference: the crushtool ``--build`` convenience (src/crush/CrushTester
setups) and the standard production hierarchy every Ceph deployment
doc draws: root → rack → host → osd, straw2 everywhere, heterogeneous
device capacities (16.16 weights), optional device classes with shadow
trees, one replicated rule over the rack failure domain and one
canonical EC rule (set_chooseleaf_tries 5 / set_choose_tries 100) over
hosts.

A :class:`ClusterSpec` is a pure value: ``build_cluster(spec)``
produces a real :class:`~ceph_tpu_torch.crush.osdmap.OSDMap` (real CrushMap,
real PGPool objects) deterministically from ``spec.seed`` — the same
spec replays the identical cluster (and the reference's) in tests, the
scenarios and the bench's ``--workload cluster`` row.  The map's bulk
CRUSH evaluation runs on ``device``: the card unless the caller asks
for the CPU.  Everything the
bulk evaluator requires holds by construction: regular hierarchy
(uniform level per bucket type), jewel tunables, straw2 buckets.

Scale knobs compose: ``ClusterSpec.sized(10_000)`` picks a
racks × hosts × osds factorization near the requested device count;
pool pg_nums are independent knobs (tests run modest pools, the demo
pushes toward the "millions of PGs" shape).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..crush.builder import CrushBuilder
from ..crush.osdmap import OSDMap, PGPool
from ..crush.types import (
    step_chooseleaf_firstn,
    step_chooseleaf_indep,
    step_emit,
    step_take,
)

# bucket type ids (type 0 = osd is implicit)
TYPE_HOST = 1
TYPE_RACK = 2
TYPE_ROOT = 3

REPLICATED_POOL = 1
EC_POOL = 2


@dataclass(frozen=True)
class ClusterSpec:
    """One seeded synthetic cluster, fully determined by its fields."""

    seed: int = 0
    racks: int = 8
    hosts_per_rack: int = 4
    osds_per_host: int = 4
    # per-HOST capacity tiers (real clusters are host-homogeneous):
    # each host draws one tier, all its osds share that 16.16 weight
    weight_tiers: Tuple[float, ...] = (1.0, 2.0, 4.0)
    # device classes drawn per host (empty = classless map, no shadow
    # trees); the EC rule scopes to the FIRST class when present
    device_classes: Tuple[str, ...] = ("hdd", "ssd")
    replicated_size: int = 3
    replicated_pg_num: int = 256
    ec_k: int = 4
    ec_m: int = 2
    ec_pg_num: int = 64            # 0 = no EC pool

    @property
    def n_hosts(self) -> int:
        return self.racks * self.hosts_per_rack

    @property
    def n_osds(self) -> int:
        return self.n_hosts * self.osds_per_host

    @classmethod
    def sized(cls, n_osds: int, *, seed: int = 0,
              osds_per_host: int = 20, racks: int = 20,
              **kw) -> "ClusterSpec":
        """A spec whose device count is >= ``n_osds`` with BALANCED
        bucket widths (10_000 → 20 racks × 25 hosts × 20 osds): the
        bulk evaluator's straw2 draw scans every slot of the widest
        bucket, so a near-cube factorization keeps its grids far
        narrower than a flat one's (a 157-host rack pads every bucket
        row to 157).  Small clusters shrink hosts-per-host and racks toward
        the cube too, keeping failure domains plentiful (>= 4 racks,
        enough hosts for the default EC width)."""
        osds_per_host = max(2, min(osds_per_host,
                                   round(n_osds ** (1 / 3))))
        racks = max(4, min(racks, round(
            (n_osds / osds_per_host) ** 0.5)))
        hosts_per_rack = max(1, -(-n_osds // (racks * osds_per_host)))
        return cls(seed=seed, racks=racks,
                   hosts_per_rack=hosts_per_rack,
                   osds_per_host=osds_per_host, **kw)


def build_cluster(spec: ClusterSpec, device=None) -> OSDMap:
    """Materialize the spec: root→rack→host→osd straw2 tree, seeded
    host capacity tiers and device classes, a replicated pool (rule 0,
    chooseleaf firstn over racks) and — when ``ec_pg_num`` > 0 — an EC
    pool (rule 1, the canonical EC scaffold, chooseleaf indep over
    hosts, class-scoped to the first device class when classes
    exist).

    ``device``: where the map's bulk path runs (default: the card;
    :class:`~ceph_tpu_torch.utils.errors.NoDeviceError` without one —
    only an explicit ``"cpu"`` runs on the CPU)."""
    from ..ops.fallback import resolve_device

    resolve_device(device)
    if spec.replicated_size > spec.racks:
        raise ValueError(
            f"replicated_size {spec.replicated_size} exceeds "
            f"{spec.racks} racks (the failure domain)")
    if spec.ec_pg_num and spec.ec_k + spec.ec_m > spec.n_hosts:
        raise ValueError(
            f"ec k+m {spec.ec_k + spec.ec_m} exceeds {spec.n_hosts} "
            f"hosts (the EC failure domain)")
    rng = np.random.default_rng(spec.seed)
    b = CrushBuilder()
    b.add_type(TYPE_HOST, "host")
    b.add_type(TYPE_RACK, "rack")
    b.add_type(TYPE_ROOT, "root")
    tiers = np.asarray(spec.weight_tiers, dtype=np.float64)
    classes = tuple(spec.device_classes)
    class_hosts = {c: 0 for c in classes}
    rack_ids = []
    osd = 0
    for r in range(spec.racks):
        host_ids = []
        for h in range(spec.hosts_per_rack):
            w = int(round(float(tiers[int(rng.integers(0, len(tiers)))])
                          * 0x10000))
            cls = (classes[int(rng.integers(0, len(classes)))]
                   if classes else None)
            devs = list(range(osd, osd + spec.osds_per_host))
            osd += spec.osds_per_host
            hid = b.add_bucket("straw2", "host", devs,
                               [w] * len(devs),
                               name=f"rack{r}-host{h}")
            if cls:
                class_hosts[cls] += 1
                for d in devs:
                    b.set_item_class(d, cls)
            host_ids.append(hid)
        rack_ids.append(b.add_bucket("straw2", "rack", host_ids,
                                     name=f"rack{r}"))
    root = b.add_bucket("straw2", "root", rack_ids, name="root")
    if classes:
        b.populate_classes()

    b.add_rule(0, [step_take(root),
                   step_chooseleaf_firstn(spec.replicated_size,
                                          TYPE_RACK),
                   step_emit()], name="replicated_rack")
    m = OSDMap(crush=b.map, device=device)
    m.pools[REPLICATED_POOL] = PGPool(
        pool_id=REPLICATED_POOL, pg_num=spec.replicated_pg_num,
        size=spec.replicated_size, crush_rule=0)
    if spec.ec_pg_num:
        n = spec.ec_k + spec.ec_m
        # class-scope the EC rule to the first device class only when
        # the seeded draw left it enough hosts to place k+m shards —
        # a tiny spec whose class died out falls back to the full tree
        # (deterministic per seed either way)
        ec_class = (classes[0] if classes
                    and class_hosts.get(classes[0], 0) >= n else "")
        b.add_erasure_rule(
            "root", [step_chooseleaf_indep(n, TYPE_HOST)],
            rule_id=1, name="ec_host", device_class=ec_class)
        m.pools[EC_POOL] = PGPool(
            pool_id=EC_POOL, pg_num=spec.ec_pg_num, size=n,
            crush_rule=1, erasure=True)
    return m


def topology_summary(spec: ClusterSpec, m: Optional[OSDMap] = None
                     ) -> Dict[str, object]:
    """The bench-facing description of a built cluster."""
    if m is None:
        m = build_cluster(spec)
    total_pgs = sum(p.pg_num for p in m.pools.values())
    total_replicas = sum(p.pg_num * p.size for p in m.pools.values())
    return {
        "seed": spec.seed,
        "racks": spec.racks,
        "hosts": spec.n_hosts,
        "osds": spec.n_osds,
        "device_classes": list(spec.device_classes),
        "pools": {pid: {"pg_num": p.pg_num, "size": p.size,
                        "erasure": p.erasure,
                        "crush_rule": p.crush_rule}
                  for pid, p in sorted(m.pools.items())},
        "total_pgs": total_pgs,
        "total_replicas": total_replicas,
        "buckets": len(m.crush.buckets),
    }


__all__ = ["EC_POOL", "REPLICATED_POOL", "ClusterSpec", "build_cluster",
           "topology_summary"]
