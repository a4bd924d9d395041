"""Operator-lifecycle demo: the control-plane surfaces working together
— the flows a mon/mgr drives in Ceph, math-only.  The counterpart of the
reference's ``examples/cluster_lifecycle_demo.py``:

    python -m ceph_tpu_torch.tools.cluster_lifecycle_demo [--device cpu]

1. erasure-code-profile set (validated by plugin instantiation)
2. pool create ... erasure <profile>: plugin emits its CRUSH rule,
   pool sized k+m with the EC min_size formula
3. map changes arrive as EPOCH-ORDERED INCREMENTALS (mark down,
   reweight) — a resuming observer catches up from a backlog and
   converges on identical placements
4. the upmap balancer flattens per-osd load; its pg-upmap-items are
   applied as one more incremental
5. degraded object: min-read repair through the pool's plugin

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): where the profile store's codes and the maps' bulk paths run
(``host``: codes pinned to the numpy region ops).  Placement runs on
the host mapper (``engine="host"``), as in the reference.
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

from ..crush import CrushBuilder
from ..crush.balancer import calc_pg_upmaps
from ..crush.inc_binary import decode_incremental, encode_incremental
from ..crush.incremental import Incremental, apply_incremental, catch_up
from ..crush.osdmap import OSDMap
from ..crush.poolops import create_erasure_pool
from ..crush.types import CRUSH_ITEM_NONE
from ..utils.config import ErasureCodeProfileStore
from . import _demo


def build_cluster():
    b = CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "root")
    hosts = [b.add_bucket("straw2", "host",
                          list(range(h * 2, h * 2 + 2)), name=f"host{h}")
             for h in range(10)]
    b.add_bucket("straw2", "root", hosts, name="default")
    return b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES)
    a = ap.parse_args(argv)
    where = _demo.map_device(a.device)

    print("== 1. profile store (mon: erasure-code-profile set) ==")
    store = ErasureCodeProfileStore(device=where)
    store.set("shec-6-3", {"plugin": "shec", "k": "6", "m": "3",
                           "c": "2", "crush-failure-domain": "host",
                           "crush-root": "default"})
    print("   profiles:", store.ls())

    print("== 2. pool create ... erasure shec-6-3 ==")
    b = build_cluster()
    m = OSDMap(crush=b.map, device=where)
    pool = create_erasure_pool(m, store, "shec-6-3", pool_id=1,
                               pg_num=64)
    print(f"   pool 1: size={pool.size} min_size={pool.min_size} "
          f"rule={pool.crush_rule} (plugin-generated)")

    print("== 3. epoch-ordered incrementals + observer catch-up ==")
    observer = OSDMap(crush=b.map, device=where)
    observer.pools[1] = pool
    backlog = [
        Incremental(epoch=1, new_state={7: 0}),          # legacy: down
        Incremental(epoch=2, new_weight={7: 0}),         # ...and out
        Incremental(epoch=3, new_weight={12: 0x8000}),   # reweight 0.5
    ]
    for inc in backlog:
        apply_incremental(m, inc)
    # the observer catches up from DISK: each delta round-trips through
    # the incremental wire form (OSDMap::Incremental::encode/decode
    # analog) before applying — the full "resume" story
    with tempfile.TemporaryDirectory() as d:
        for inc in backlog:
            Path(d, f"inc.{inc.epoch}").write_bytes(
                encode_incremental(inc))
        from_disk = [decode_incremental(Path(d, f"inc.{e}").read_bytes())
                     for e in (3, 1, 2)]                    # disordered
    catch_up(observer, from_disk)
    up_m, _ = m.pg_to_up_bulk(1, engine="host")
    up_o, _ = observer.pg_to_up_bulk(1, engine="host")
    assert np.array_equal(up_m, up_o) and m.epoch == observer.epoch == 3
    degraded = int((up_m == CRUSH_ITEM_NONE).sum())
    print(f"   epoch {m.epoch}: observer converged from on-disk deltas; "
          f"osd.7 out, {degraded} unfilled slots cluster-wide")

    print("== 4. balancer -> pg-upmap-items as an incremental ==")
    counts = m.pg_counts_per_osd(1, engine="host")
    spread0 = int(counts.max() - counts[counts > 0].min())
    staging = OSDMap(crush=b.map, device=where)
    staging.pools[1] = pool
    staging.osd_weight = list(m.osd_weight)
    staging.osd_up = list(m.osd_up)
    changes = calc_pg_upmaps(staging, 1, max_deviation=1.0,
                             engine="host")
    apply_incremental(m, Incremental(
        epoch=4, new_pg_upmap_items={
            pg: items for pg, items in changes.items()}))
    counts = m.pg_counts_per_osd(1, engine="host")
    spread1 = int(counts.max() - counts[counts > 0].min())
    print(f"   {len(changes)} pg-upmap-items applied at epoch 4; "
          f"per-osd spread {spread0} -> {spread1}")

    print("== 5. degraded repair through the pool's plugin ==")
    ec = store.instantiate("shec-6-3")
    if a.device == "host":
        ec.min_xla_bytes = float("inf")
    obj = bytes(np.random.default_rng(0).integers(
        0, 256, 100_000, dtype=np.uint8))
    enc = ec.encode(set(range(pool.size)), obj)
    up, _, _, _ = m.pg_to_up_acting_osds(1, 5)
    shard = next(i for i, o in enumerate(up) if o != CRUSH_ITEM_NONE)
    avail = {i: enc[i] for i in range(pool.size) if i != shard}
    reads = ec.minimum_to_decode({shard}, set(avail))
    dec = ec.decode({shard}, {i: avail[i] for i in reads},
                    len(enc[0]))
    assert dec[shard] == enc[shard]
    print(f"   pg 1.5 up={up}; lost shard {shard}, repaired reading "
          f"{len(reads)}/{pool.size - 1} survivors (shec min-read)")
    print("lifecycle demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
