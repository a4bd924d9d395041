"""scrub_demo — inject faults into a synthetic cluster, then print the
scrub → repair → remap report: the counterpart of the reference's
``tools/scrub_demo.py``.

The whole robustness loop on one synthetic pg: build a two-level CRUSH
cluster, place a pg, encode an object across its acting set, damage it
with the seeded chaos injectors, deep-scrub, repair, and feed the
confirmed-bad OSDs back into the OSDMap so CRUSH remaps.  Every run
replays byte-identically from --seed.

    python -m ceph_tpu_torch.tools.scrub_demo --erasures 1 --corruptions 1
    python -m ceph_tpu_torch.tools.scrub_demo --k 4 --m 2 --truncate \
        --zero-stripe --json
    python -m ceph_tpu_torch.tools.scrub_demo --erasures 3   # > m: rc 2

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): where the code runs (``host``: a CPU instance pinned to the
numpy region ops).  The demo's 4 KiB stripes are below the plugins'
host rule, so a card instance may serve them from the host.

Exit codes: 0 = scrub+repair+remap clean; 2 = unrecoverable (the
structured report is still printed); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..chaos import (
    BitFlip,
    ShardErasure,
    TransientErrors,
    Truncate,
    ZeroStripe,
    inject,
)
from ..codes.stripe import HashInfo, StripeInfo, encode
from ..crush import (
    CrushBuilder,
    step_chooseleaf_indep,
    step_emit,
    step_take,
)
from ..crush.osdmap import OSDMap, PGPool
from ..scrub import (
    UnrecoverableError,
    apply_osd_feedback,
    deep_scrub,
    repair,
)
from ..utils.retry import FakeClock, RetryPolicy
from . import _demo


def build_cluster(n_hosts: int, devs: int, size: int,
                  device: str = "cuda") -> OSDMap:
    b = CrushBuilder()
    root = b.build_two_level(n_hosts, devs)
    b.add_rule(0, [step_take(root),
                   step_chooseleaf_indep(size, b.type_id("host")),
                   step_emit()])
    osdmap = OSDMap(crush=b.map, device=_demo.map_device(device))
    osdmap.pools[1] = PGPool(pool_id=1, pg_num=16, size=size,
                             erasure=True)
    return osdmap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="scrub_demo",
        description="inject faults, scrub, repair, remap — one pg")
    ap.add_argument("--plugin", default="jerasure")
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    help="extra profile parameter name=value")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--size", type=int, default=4096,
                    help="stripe width hint (bytes)")
    ap.add_argument("--stripes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ps", type=int, default=9, help="pg seed to place")
    ap.add_argument("--erasures", type=int, default=1)
    ap.add_argument("--corruptions", type=int, default=1)
    ap.add_argument("--truncate", action="store_true",
                    help="also truncate one random shard")
    ap.add_argument("--zero-stripe", action="store_true",
                    help="also zero one whole stripe across shards")
    ap.add_argument("--transient", type=int, default=0,
                    help="arm N transient read errors on one shard")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: numpy region ops; cuda: the card "
                         "(default); cpu: CPU tensors")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)

    profile = {"k": str(a.k), "m": str(a.m)}
    for p in a.parameter:
        name, _, value = p.partition("=")
        profile[name] = value
    try:
        ec = _demo.instance(a.plugin, profile, a.device)
    except (ValueError, IOError) as e:
        print(f"scrub_demo: bad profile: {e}", file=sys.stderr)
        return 1
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(a.size)
    sinfo = StripeInfo(k, width)

    # -- place + write ---------------------------------------------------
    osdmap = build_cluster(n_hosts=n + 2, devs=2, size=n,
                           device=a.device)
    up, _, acting, _ = osdmap.pg_to_up_acting_osds(1, a.ps)
    rng = np.random.default_rng(a.seed)
    obj = rng.integers(0, 256, size=width * a.stripes,
                       dtype=np.uint8).tobytes()
    shards = encode(sinfo, ec, obj)
    hinfo = HashInfo(n)
    hinfo.append(0, shards)

    # -- damage ----------------------------------------------------------
    injectors = []
    if a.erasures:
        injectors.append(ShardErasure(n=a.erasures))
    if a.corruptions:
        injectors.append(BitFlip(n=a.corruptions, flips=1))
    if a.truncate:
        injectors.append(Truncate())
    if a.zero_stripe:
        injectors.append(ZeroStripe())
    if a.transient:
        injectors.append(TransientErrors(n=1, count=a.transient))
    store, faults = inject(shards, injectors, seed=a.seed,
                           chunk_size=sinfo.chunk_size)

    # -- scrub → repair → remap -----------------------------------------
    clock = FakeClock()
    policy = RetryPolicy(attempts=max(3, a.transient + 1))
    report = deep_scrub(sinfo, ec, store, hinfo, retry_policy=policy,
                        clock=clock)
    out = {
        "plugin": a.plugin, "profile": profile, "seed": a.seed,
        "acting": [int(o) for o in acting],
        "faults": [{"kind": f.kind, "shard": f.shard,
                    "offset": f.offset, "detail": f.detail}
                   for f in faults],
        "scrub": {"clean": report.clean, "missing": report.missing,
                  "corrupt": report.corrupt,
                  "retried_shards": list(report.retried_shards)},
    }
    rc = 0
    try:
        rep = repair(sinfo, ec, store, hinfo, report,
                     retry_policy=policy, clock=clock)
        out["repair"] = {
            "repaired_shards": sorted(rep.repaired),
            "reencode_verified": rep.reencode_verified,
            "crc_verified": rep.crc_verified,
            "healed": store.snapshot() == shards,
        }
        if report.bad:
            remap = apply_osd_feedback(osdmap, 1, a.ps, acting,
                                       report.bad)
            out["remap"] = {
                "marked_osds": list(remap.marked_osds),
                "old_acting": list(remap.old_acting),
                "new_acting": list(remap.new_acting),
                "moved": {str(s): list(v)
                          for s, v in remap.moved.items()},
            }
    except UnrecoverableError as e:
        out["unrecoverable"] = {
            "shards": list(e.shards),
            "extents": [list(x) for x in e.extents],
            "message": str(e),
        }
        rc = 2

    if a.json_out:
        print(json.dumps(out, indent=1))
        return rc

    print(f"pg 1.{a.ps} acting {out['acting']}  "
          f"({a.plugin} k={k} m={n - k}, {a.stripes} stripes of "
          f"{width} B)")
    print("injected faults:")
    for f in out["faults"]:
        where = f" @+{f['offset']}" if f["offset"] >= 0 else ""
        print(f"  - {f['kind']:<11} shard {f['shard']}{where}  "
              f"{f['detail']}")
    s = out["scrub"]
    print(f"deep scrub: clean={s['clean']} missing={s['missing']} "
          f"corrupt={s['corrupt']}"
          + (f" (retried {s['retried_shards']})"
             if s["retried_shards"] else ""))
    if "unrecoverable" in out:
        u = out["unrecoverable"]
        print(f"UNRECOVERABLE: shards {u['shards']} — "
              f"{len(u['extents'])} lost extents")
        for off, ln in u["extents"][:8]:
            print(f"  lost [{off}, +{ln})")
        return rc
    r = out["repair"]
    print(f"repair: rebuilt {r['repaired_shards']}  "
          f"re-encode verified={r['reencode_verified']} "
          f"crc verified={r['crc_verified']} "
          f"byte-identical={r['healed']}")
    if "remap" in out:
        m = out["remap"]
        print(f"remap: marked osds {m['marked_osds']} down+out; "
              f"acting {m['old_acting']} -> {m['new_acting']}")
        for slot, (old, new) in sorted(out["remap"]["moved"].items()):
            print(f"  shard {slot}: osd.{old} -> osd.{new}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
