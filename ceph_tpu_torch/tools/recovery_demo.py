"""recovery_demo — seeded churn + crash scenario through the recovery
orchestrator, printing the recovery report: the counterpart of the
reference's ``tools/recovery_demo.py``.

The full durability loop on one synthetic pg: build a CRUSH cluster,
place a pg, encode --objects objects across its acting set, damage them
with the seeded chaos injectors, then drive the epoch-aware
orchestrator to convergence while a seeded MapChurn advances the map
between pipeline stages, a CrashPoint kills the "daemon" at a named
crash site (the harness resumes it against the surviving journal +
stores + map), and a TornWrite tears a recovery write-back.  Every run
replays byte-identically from --seed.

    python -m ceph_tpu_torch.tools.recovery_demo --erasures 1 \
        --corruptions 1 --churn 3 --crash-site writeback.after_write --torn
    python -m ceph_tpu_torch.tools.recovery_demo --erasures 3   # rc 2
    python -m ceph_tpu_torch.tools.recovery_demo --list-sites

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): where the code and the fused repairs run (``host``: a CPU
instance pinned to the numpy region ops, host repairs).

Exit codes: 0 = converged with zero data loss; 2 = unrecoverable
objects reported (structured report still printed); 3 = converged but
NOT byte-identical (must never happen); 1 = usage/config error.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..chaos import (
    CRASH_SITES,
    BitFlip,
    CrashPoint,
    MapChurn,
    ShardErasure,
    TornWrite,
    TransientErrors,
)
from ..codes.stripe import StripeInfo
from ..scenario.runner import stage_damaged_objects
from ..crush import (
    CrushBuilder,
    step_chooseleaf_indep,
    step_emit,
    step_take,
)
from ..crush.osdmap import OSDMap, PGPool
from ..recovery import healed, recover_to_completion
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
        prog="recovery_demo",
        description="seeded churn+crash recovery scenario — one pg")
    ap.add_argument("--plugin", default="jerasure")
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    help="extra profile parameter name=value")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--size", type=int, default=4096,
                    help="stripe width hint (bytes)")
    ap.add_argument("--stripes", type=int, default=4)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ps", type=int, default=9, help="pg seed to place")
    ap.add_argument("--erasures", type=int, default=1,
                    help="shards erased per object")
    ap.add_argument("--corruptions", type=int, default=1,
                    help="shards bit-flipped per object")
    ap.add_argument("--transient", type=int, default=0,
                    help="arm N transient read errors per object")
    ap.add_argument("--churn", type=int, default=4,
                    help="max MapChurn events (0 disables)")
    ap.add_argument("--max-down", type=int, default=1,
                    help="churn's concurrent down-OSD bound")
    ap.add_argument("--crash-site", default=None, choices=CRASH_SITES,
                    help="inject one crash at this site (resumed)")
    ap.add_argument("--crash-hit", type=int, default=1,
                    help="crash on the Nth visit to the site")
    ap.add_argument("--torn", action="store_true",
                    help="tear the first recovery write of one shard")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-op recovery deadline (FakeClock seconds)")
    ap.add_argument("--list-sites", action="store_true",
                    help="print the crash-site catalogue and exit")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: numpy region ops and host repairs; "
                         "cuda: the card (default); cpu: CPU tensors")
    ap.add_argument("--json", action="store_true", dest="json_out")
    a = ap.parse_args(argv)

    if a.list_sites:
        for s in CRASH_SITES:
            print(s)
        return 0

    profile = {"k": str(a.k), "m": str(a.m)}
    for p in a.parameter:
        name, _, value = p.partition("=")
        profile[name] = value
    try:
        ec = _demo.instance(a.plugin, profile, a.device)
    except (ValueError, IOError) as e:
        print(f"recovery_demo: bad profile: {e}", file=sys.stderr)
        return 1
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(a.size)
    sinfo = StripeInfo(k, width)

    # -- place + write (staging via the shared scenario runner) ----------
    osdmap = build_cluster(n_hosts=n + 3, devs=2, size=n,
                           device=a.device)
    _, _, acting, _ = osdmap.pg_to_up_acting_osds(1, a.ps)

    def injectors_for(i: int) -> list:
        injectors = []
        if a.erasures:
            injectors.append(ShardErasure(n=a.erasures))
        if a.corruptions:
            injectors.append(BitFlip(n=a.corruptions, flips=1))
        if a.transient:
            injectors.append(TransientErrors(n=1, count=a.transient))
        if a.torn and i == 0 and a.erasures:
            # tear the recovery write-back of the first erased shard
            injectors.append(TornWrite(n=1, keep=width // (2 * k)))
        return injectors

    originals, stores, hinfos, all_faults = stage_damaged_objects(
        sinfo, ec, a.objects, seed=a.seed, stripes=a.stripes,
        injectors_for=injectors_for)

    churn = (MapChurn(seed=a.seed, max_down=a.max_down, p_fire=0.6,
                      max_events=a.churn) if a.churn else None)
    crashpoint = (CrashPoint(site=a.crash_site, at_hit=a.crash_hit)
                  if a.crash_site else None)
    clock = FakeClock()
    policy = RetryPolicy(attempts=max(3, a.transient + 1))

    report = recover_to_completion(
        sinfo, ec, osdmap, 1, a.ps, stores, hinfos,
        crashpoint=crashpoint, churn=churn, clock=clock,
        retry_policy=policy, op_deadline=a.deadline, round_delay=0.5,
        device=False if a.device == "host" else None)

    byte_identical = healed(
        [stores[i] for i in range(a.objects)
         if i not in report.unrecoverable],
        [originals[i] for i in range(a.objects)
         if i not in report.unrecoverable])

    out = {
        "plugin": a.plugin, "profile": profile, "seed": a.seed,
        "acting": [int(o) for o in acting],
        "objects": a.objects,
        "faults": [[{"kind": f.kind, "shard": f.shard,
                     "detail": f.detail} for f in faults]
                   for faults in all_faults],
        "churn_events": list(churn.events) if churn else [],
        "report": report.to_dict(),
        "byte_identical": byte_identical,
    }
    rc = 0
    if report.unrecoverable:
        rc = 2
    elif not byte_identical or not report.converged:
        rc = 3

    if a.json_out:
        print(json.dumps(out, indent=1))
        return rc

    print(f"pg 1.{a.ps} acting {out['acting']}  ({a.plugin} k={k} "
          f"m={n - k}, {a.objects} objects x {a.stripes} stripes)")
    for i, faults in enumerate(all_faults):
        for f in faults:
            print(f"  obj {i}: {f.kind:<11} shard {f.shard}  {f.detail}")
    if churn:
        for ev in churn.events:
            print(f"  churn e{ev['epoch']}: {ev['kind']} {ev['detail']} "
                  f"(at {ev['stage']})")
    r = out["report"]
    print(f"recovery: epochs {r['epoch_start']}->{r['epoch_end']}, "
          f"{r['rounds']} rounds, {r['crashes']} crashes survived")
    print(f"  ops: planned={r['ops_planned']} "
          f"completed={r['ops_completed']} replans={r['replans']} "
          f"regroups={r['regroups']}")
    print(f"  deferrals: fence={r['fence_deferrals']} "
          f"throttle={r['throttle_deferrals']} "
          f"decode={r['decode_deferrals']}; "
          f"torn rewrites={r['torn_rewrites']}")
    print(f"  journal: replays={r['journal']['replays']} "
          f"completed={r['journal']['completed']} "
          f"rolled_back={r['journal']['rolled_back']} "
          f"deleted={r['journal']['shards_deleted']}")
    print(f"  writes landed: {r['writes']}")
    if report.unrecoverable:
        print(f"UNRECOVERABLE objects: {r['unrecoverable']}")
    if report.expired:
        print(f"expired (deadline) objects: {r['expired']}")
    print(f"converged={r['converged']} byte_identical={byte_identical}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
