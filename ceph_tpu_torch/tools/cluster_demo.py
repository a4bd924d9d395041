"""cluster_demo — seeded storm → balance → rateless-recover scenario
over a synthetic production-shape cluster (``ceph_tpu_torch/cluster/``):
the counterpart of the reference's ``tools/cluster_demo.py``.

One seed drives the whole story end to end: build a ClusterSpec cluster
(root→rack→host→osd straw2, capacity tiers, device classes, replicated
+ EC pools), fire a MapChurn storm through the incremental path
measuring full-cluster remaps per epoch on the bulk evaluator (pinned
equivalent to a rebuilt map and a catch_up replay), close the balancer
loop to max deviation <= 1 (optionally byte-compared against the host
loop), then heal a set of chaos-damaged objects with the rateless
first-k plan under an injected straggler and prove zero data loss.

    python -m ceph_tpu_torch.tools.cluster_demo --osds 400 --events 20
    python -m ceph_tpu_torch.tools.cluster_demo --osds 10000 --pgs 2048 \
        --events 60
    python -m ceph_tpu_torch.tools.cluster_demo --erasures 3   # rc 2
    python -m ceph_tpu_torch.tools.cluster_demo --osds 200 \
        --verify-host-loop

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card) replaces the reference's ``--device host|jax``: ``cuda`` and
``cpu`` put the map's bulk path, the code and the heal's fused repairs
on that device; ``host`` is the reference's ``host`` (the bulk path on
the CPU, a code pinned to the numpy region ops, a host heal).

Exit codes: 0 = storm equivalence held, balancer converged, recovery
healed byte-identical; 2 = unrecoverable objects reported (structured
report still printed); 3 = a correctness gate failed (must never
happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..chaos import MapChurn, ShardErasure, Straggler, inject
from ..cluster import (
    ClusterSpec,
    balance_cluster,
    build_cluster,
    rateless_recover,
    run_churn_storm,
    topology_summary,
    verify_storm_equivalence,
)
from ..cluster.topology import EC_POOL
from ..codes.stripe import HashInfo, StripeInfo, encode
from ..recovery import healed
from ..recovery.throttle import OsdRecoveryThrottle
from . import _demo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cluster_demo",
        description="seeded storm -> balance -> rateless-recover "
                    "scenario over a synthetic cluster")
    ap.add_argument("--osds", type=int, default=400)
    ap.add_argument("--pgs", type=int, default=512,
                    help="replicated pool pg_num (EC pool rides 1/8)")
    ap.add_argument("--events", type=int, default=20,
                    help="MapChurn storm epoch budget")
    ap.add_argument("--max-down", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--engine", default="bulk",
                    choices=["bulk", "host", "sharded"])
    ap.add_argument("--measure-every", type=int, default=1,
                    help="storm remap measurement stride")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--size", type=int, default=4096,
                    help="object stripe width hint (bytes)")
    ap.add_argument("--erasures", type=int, default=1,
                    help="shards erased per object (> m: rc 2)")
    ap.add_argument("--redundancy", type=int, default=2,
                    help="rateless over-planning factor r")
    ap.add_argument("--slow-shard", type=float, default=10.0,
                    help="injected straggler slowdown on shard 0")
    ap.add_argument("--max-deviation", type=float, default=1.0)
    ap.add_argument("--verify-host-loop", action="store_true",
                    help="re-run the balancer loop on the host "
                         "engine and require byte-identical "
                         "proposals (small clusters; the device-loop "
                         "identity gate)")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="where the bulk path, the code and the heal "
                         "run: cuda (default), cpu, or host (numpy "
                         "region ops and a host heal)")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)

    spec = ClusterSpec.sized(a.osds, seed=a.seed,
                             replicated_pg_num=a.pgs,
                             ec_pg_num=max(32, a.pgs // 8),
                             ec_k=a.k, ec_m=a.m)
    where = _demo.map_device(a.device)
    m = build_cluster(spec, device=where)
    out = {"spec": topology_summary(spec, m)}

    # --- storm ----------------------------------------------------------
    churn = MapChurn(seed=a.seed + 1, max_down=a.max_down,
                     fire_every=1, max_events=a.events)
    storm = run_churn_storm(m, churn=churn, events=a.events,
                            engine=a.engine,
                            measure_every=a.measure_every)
    out["storm"] = storm.to_dict()
    try:
        verify_storm_equivalence(m, churn,
                                 lambda: build_cluster(spec,
                                                       device=where),
                                 engine=a.engine, scalar_samples=8)
        out["storm"]["equivalence"] = "ok"
    except AssertionError as e:
        out["storm"]["equivalence"] = str(e)
        print(json.dumps(out, indent=None if a.json_out else 1))
        print("FAIL: storm incremental/rebuild/catch_up divergence",
              file=sys.stderr)
        return 3

    # --- balance --------------------------------------------------------
    if a.verify_host_loop:
        m_host = build_cluster(spec, device=where)
        host_churn = MapChurn(seed=a.seed + 1, max_down=a.max_down,
                              fire_every=1, max_events=a.events)
        run_churn_storm(m_host, churn=host_churn, events=a.events,
                        engine="host",
                        measure_every=a.measure_every)
    bal = balance_cluster(m, max_deviation=a.max_deviation,
                          engine=a.engine)
    out["balance"] = bal.to_dict()
    if a.verify_host_loop:
        bal_host = balance_cluster(m_host,
                                   max_deviation=a.max_deviation,
                                   engine="host")
        identical = (bal.changes == bal_host.changes
                     and m.pg_upmap_items == m_host.pg_upmap_items)
        out["balance"]["host_loop_identical"] = identical
        if not identical:
            print(json.dumps(out, indent=None if a.json_out else 1))
            print("FAIL: device-loop proposals != host loop",
                  file=sys.stderr)
            return 3
    if not bal.converged:
        print(json.dumps(out, indent=None if a.json_out else 1))
        print(f"FAIL: balancer did not converge "
              f"(max dev {bal.max_dev_final})", file=sys.stderr)
        return 3

    # --- rateless recovery ----------------------------------------------
    ec = _demo.instance("jerasure", {"technique": "reed_sol_van",
                                     "k": str(a.k), "m": str(a.m)},
                        a.device)
    n = ec.get_chunk_count()
    chunk = ec.get_chunk_size(a.size)
    sinfo = StripeInfo(a.k, a.k * chunk)
    rng = np.random.default_rng(a.seed + 2)
    objects, stores, hinfos = [], [], []
    for i in range(a.objects):
        obj = rng.integers(0, 256, size=a.k * chunk,
                           dtype=np.uint8).tobytes()
        shards = encode(sinfo, ec, obj)
        hinfo = HashInfo(n)
        hinfo.append(0, shards)
        victims = [int(v) for v in
                   np.random.default_rng((a.seed, i)).choice(
                       n, size=min(a.erasures, n - 1), replace=False)]
        st, _ = inject(shards, [ShardErasure(shards=victims)],
                       seed=a.seed + i, chunk_size=chunk)
        objects.append(shards)
        stores.append(st)
        hinfos.append(hinfo)
    throttle = OsdRecoveryThrottle()
    rec, rr = rateless_recover(
        sinfo, ec, m, EC_POOL, 5, stores, hinfos,
        redundancy=a.redundancy,
        straggler=Straggler(seed=a.seed + 3,
                            slow={0: a.slow_shard}),
        throttle=throttle, seed=a.seed + 4,
        device=a.device != "host")
    out["rateless"] = rr.to_dict()
    out["healed"] = healed(stores, objects) if not rec.unrecoverable \
        else False

    print(json.dumps(out, indent=None if a.json_out else 1))
    if rec.unrecoverable:
        print(f"unrecoverable objects: {rec.unrecoverable}",
              file=sys.stderr)
        return 2
    if not rec.converged or not out["healed"]:
        print("FAIL: recovery did not heal byte-identical",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
