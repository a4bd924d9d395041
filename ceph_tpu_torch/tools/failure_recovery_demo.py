"""End-to-end demo: an in-process EC 'cluster' built from the framework's
two halves — CRUSH/OSDMap placement above, erasure coding below.  The
counterpart of the reference's ``examples/failure_recovery_demo.py``:

    python -m ceph_tpu_torch.tools.failure_recovery_demo [--device cpu]

1. build a CRUSH map (6 hosts x 2 osds) and an EC pool (k=4, m=2)
2. place a pg, encode an object into shards, record crc32c hashes
3. kill the OSD holding shard 1 (down + out)
4. re-place: CRUSH backfills the failure domain
5. recover: minimum_to_decode -> batched reconstruct -> hash gate
6. client read: reconstructing range reads while degraded

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): where the code and the map's bulk path run (``host``: a code
pinned to the numpy region ops).  The reference runs this at import;
here it is ``main(argv)``.
"""

import argparse

import numpy as np

from ..codes.stripe import (HashInfo, StripeInfo, ceph_crc32c, decode,
                            encode, read)
from ..crush import (CrushBuilder, step_chooseleaf_indep, step_emit,
                     step_take)
from ..crush.osdmap import OSDMap, PGPool
from ..crush.types import CRUSH_ITEM_NONE
from . import _demo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES)
    a = ap.parse_args(argv)

    K, M = 4, 2

    # 1. cluster: CRUSH hierarchy + EC pool -------------------------------
    b = CrushBuilder()
    root = b.build_two_level(6, 2)
    b.add_rule(0, [step_take(root), step_chooseleaf_indep(K + M,
                                                          b.type_id("host")),
                   step_emit()])
    osdmap = OSDMap(crush=b.map, device=_demo.map_device(a.device))
    osdmap.pools[1] = PGPool(pool_id=1, pg_num=32, size=K + M, erasure=True)
    print(f"cluster: 6 hosts x 2 osds, EC pool k={K} m={M}, 32 pgs")

    # 2. write an object --------------------------------------------------
    ec = _demo.instance("jerasure", {"technique": "reed_sol_van",
                                     "k": str(K), "m": str(M)}, a.device)
    width = K * ec.get_chunk_size(K * 4096)
    sinfo = StripeInfo(K, width)
    obj = np.random.default_rng(0).integers(
        0, 256, size=width * 16, dtype=np.uint8).tobytes()

    ps = 7
    up, up_primary, acting, _ = osdmap.pg_to_up_acting_osds(1, ps)
    shards = encode(sinfo, ec, obj)
    hinfo = HashInfo(K + M)
    hinfo.append(0, shards)
    stored = {acting[i]: shards[i] for i in range(K + M)}
    print(f"pg 1.{ps} -> osds {acting} (primary osd.{up_primary}); "
          f"{len(obj)} bytes as {K + M} shards of {len(shards[0])}")

    # 3. failure ----------------------------------------------------------
    dead = acting[1]
    osdmap.mark_down(dead)
    osdmap.mark_out(dead)
    print(f"osd.{dead} (shard 1) dies and is marked out")

    # 4. re-placement -----------------------------------------------------
    _, _, acting2, _ = osdmap.pg_to_up_acting_osds(1, ps)
    print(f"CRUSH re-places pg 1.{ps} -> {acting2}")
    assert dead not in [o for o in acting2 if o != CRUSH_ITEM_NONE]

    # 5. recovery ---------------------------------------------------------
    lost = 1
    available = {i for i in range(K + M) if i != lost}
    plan = ec.minimum_to_decode({lost}, available)
    reads = {s: stored[acting[s]] for s in plan}
    recovered = decode(sinfo, ec, reads, {lost})[lost]
    assert ceph_crc32c(0xFFFFFFFF, recovered) == hinfo.get_chunk_hash(lost)
    # marking the dead osd out reweights CRUSH, so OTHER slots may have
    # moved too: backfill every displaced shard from its live old home
    # (upstream's recovery-vs-backfill distinction), reading a snapshot so
    # new homes can alias other slots' old homes
    old_stored = dict(stored)
    stored[acting2[lost]] = recovered
    for i in range(K + M):
        if i != lost and acting2[i] != acting[i]:
            stored[acting2[i]] = old_stored[acting[i]]
    print(f"shard {lost} rebuilt from {sorted(plan)} "
          f"({len(recovered)} bytes), crc32c verified, "
          f"backfilled to osd.{acting2[lost]}")
    # the cluster-state model is now consistent with the new acting set
    for i in range(K + M):
        if acting2[i] != CRUSH_ITEM_NONE:
            assert stored[acting2[i]] == shards[i], f"slot {i}"

    # 6. degraded client read --------------------------------------------
    survivors = {s: shards[s] for s in range(K + M) if s != lost}
    span = read(sinfo, ec, survivors, 5000, 30000)
    assert span == obj[5000:35000]
    print("degraded range read [5000, 35000) byte-exact "
          "(reconstructing read, no shard 1)")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
