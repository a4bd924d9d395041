"""osdmaptool-equivalent CLI — src/tools/osdmaptool.cc; the port of
``ceph_tpu.bench.osdmaptool``.

Supported surface (the modes that exercise placement math; epoch/
incremental surgery needs a mon and is out of scope, SURVEY.md §7):

  python -m ceph_tpu_torch.bench.osdmaptool MAP --test-map-pgs [--pool ID]
      per-pool pg→OSD sweep through the full OSDMap pipeline (pps,
      upmap, affinity, temp) on the bulk evaluator; prints the
      per-osd count histogram + avg/min/max like the reference.
  python -m ceph_tpu_torch.bench.osdmaptool MAP --upmap OUT [--pool ID]
      [--upmap-deviation D] [--upmap-max N]
      balancer run (OSDMap::calc_pg_upmaps); writes `ceph osd
      pg-upmap-items ...` command lines to OUT, the reference's
      output format for feeding back to a cluster.
  python -m ceph_tpu_torch.bench.osdmaptool --createsimple N -o MAP
      build a fresh map with N osds (one host each), a replicated
      pool, and jewel tunables (osdmaptool --createsimple analog).
  python -m ceph_tpu_torch.bench.osdmaptool MAP --print
      map summary: epoch, pools, per-osd up/in/weight lines
      (osdmaptool --print; combinable with the modes above).
  python -m ceph_tpu_torch.bench.osdmaptool MAP --create-ec-pool NAME
      --ec-profile K=V ... [--pool-id N] [--pg-num M] [-o OUT]
      validate an EC profile, let the plugin emit its CRUSH rule, and
      add the pool (mon prepare_new_pool analog).

``--engine bulk`` (the default) runs placement on ``--device``: the card
by default (NoDeviceError without one), ``cpu`` on the CPU;
``--create-ec-pool`` makes the code on that device too.

MAP is a JSON document:
  {"crush": <crush map in this framework's JSON interchange form, or
             a path to a text/binary/JSON crushmap file>,
   "pools": [{"pool_id": 1, "pg_num": 256, "size": 3,
              "crush_rule": 0, "erasure": false}, ...],
   "osd_weight": {"3": 0.5}, "osd_down": [7], "osd_out": [7],
   "primary_affinity": {"2": 0.5},
   "pg_upmap_items": {"1.5": [[3, 9]]}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import numpy as np

from ..crush.balancer import calc_pg_upmaps
from ..crush.osdmap import IN_WEIGHT, MAX_PRIMARY_AFFINITY, OSDMap, PGPool
from ..crush.types import CRUSH_ITEM_NONE
from .crushtool import read_map


def load_osdmap(path: str) -> OSDMap:
    spec = json.load(open(path))
    crush_spec = spec["crush"]
    if isinstance(crush_spec, str):
        cmap = read_map(crush_spec)
    else:
        from ..crush.compiler import compile_map
        cmap = compile_map(json.dumps(crush_spec))
    m = OSDMap(crush=cmap)
    import dataclasses
    known = {f.name for f in dataclasses.fields(PGPool)}
    for p in spec.get("pools", []):
        unknown = set(p) - known
        if unknown:
            raise SystemExit(
                f"osdmaptool: {path}: unknown pool field(s) "
                f"{sorted(unknown)} (known: {sorted(known)})")
        missing = {"pool_id", "pg_num"} - set(p)
        if missing:
            raise SystemExit(
                f"osdmaptool: {path}: pool entry missing required "
                f"field(s) {sorted(missing)}")
        pool = PGPool(**p)
        m.pools[pool.pool_id] = pool
    for osd, w in spec.get("osd_weight", {}).items():
        m.osd_weight[int(osd)] = int(float(w) * IN_WEIGHT)
    for osd in spec.get("osd_down", []):
        m.mark_down(int(osd))
    for osd in spec.get("osd_out", []):
        m.osd_weight[int(osd)] = 0
    for osd, a in spec.get("primary_affinity", {}).items():
        m.set_primary_affinity(int(osd), int(float(a) * MAX_PRIMARY_AFFINITY))
    for pgid, items in spec.get("pg_upmap_items", {}).items():
        pool_id, seed = pgid.split(".")
        m.pg_upmap_items[(int(pool_id), int(seed))] = [
            (int(f), int(t)) for f, t in items]
    return m


def dump_osdmap(m: OSDMap, pools) -> Dict:
    """Inverse of load_osdmap: includes the override layers
    (osd_weight/down/out, primary affinity, upmap items) so editing a
    dumped map round-trips instead of silently dropping state."""
    from ..crush.compiler import decompile
    out = {
        "crush": json.loads(decompile(m.crush)),
        "pools": [{"pool_id": p.pool_id, "pg_num": p.pg_num,
                   "pgp_num": p.pgp_num, "size": p.size,
                   "min_size": p.min_size, "crush_rule": p.crush_rule,
                   "erasure": p.erasure, "hashpspool": p.hashpspool}
                  for p in pools],
    }
    reweights = {str(o): m.osd_weight[o] / IN_WEIGHT
                 for o in range(m.max_osd)
                 if m.osd_weight[o] not in (0, IN_WEIGHT)}
    if reweights:
        out["osd_weight"] = reweights
    down = [o for o in range(m.max_osd) if not m.osd_up[o]]
    if down:
        out["osd_down"] = down
    outs = [o for o in range(m.max_osd)
            if m.osd_exists[o] and m.osd_weight[o] == 0]
    if outs:
        out["osd_out"] = outs
    if m.osd_primary_affinity is not None:
        aff = {str(o): m.osd_primary_affinity[o] / MAX_PRIMARY_AFFINITY
               for o in range(m.max_osd)
               if m.osd_primary_affinity[o] != MAX_PRIMARY_AFFINITY}
        if aff:
            out["primary_affinity"] = aff
    if m.pg_upmap_items:
        out["pg_upmap_items"] = {
            f"{pid}.{seed}": [[f, t] for f, t in items]
            for (pid, seed), items in sorted(m.pg_upmap_items.items())}
    return out


def print_map(m: OSDMap) -> int:
    """osdmaptool --print: epoch, pools, per-osd state lines."""
    print(f"epoch {m.epoch}")
    print(f"max_osd {m.max_osd}")
    for pid in sorted(m.pools):
        p = m.pools[pid]
        kind = "erasure" if p.erasure else "replicated"
        print(f"pool {pid} '{kind}' size {p.size} min_size {p.min_size} "
              f"crush_rule {p.crush_rule} pg_num {p.pg_num} "
              f"pgp_num {p.pgp_num}")
    for osd in range(m.max_osd):
        if not m.osd_exists[osd]:
            continue
        state = "up" if m.osd_up[osd] else "down"
        inout = "out" if m.osd_weight[osd] == 0 else "in"
        w = m.osd_weight[osd] / IN_WEIGHT
        print(f"osd.{osd} {state} {inout} weight {w:g}")
    n_over = (len(m.pg_upmap) + len(m.pg_upmap_items)
              + len(m.pg_temp) + len(m.primary_temp))
    if n_over:
        print(f"{len(m.pg_upmap)} pg_upmap, {len(m.pg_upmap_items)} "
              f"pg_upmap_items, {len(m.pg_temp)} pg_temp, "
              f"{len(m.primary_temp)} primary_temp")
    return 0


def test_map_pgs(m: OSDMap, pool_ids, engine: str) -> int:
    total = np.zeros(m.max_osd, dtype=np.int64)
    first = np.zeros(m.max_osd, dtype=np.int64)
    prim = np.zeros(m.max_osd, dtype=np.int64)
    n_pgs = 0
    begin = time.perf_counter()
    for pid in pool_ids:
        pool = m.pools[pid]
        up, _, acting, actp = m.pg_to_up_acting_bulk(pid, engine=engine)
        n_pgs += pool.pg_num
        flat = acting.ravel()
        flat = flat[(flat != CRUSH_ITEM_NONE) & (flat >= 0)]
        total += np.bincount(flat, minlength=m.max_osd)
        f0 = up[:, 0]
        f0 = f0[(f0 != CRUSH_ITEM_NONE) & (f0 >= 0)]
        first += np.bincount(f0, minlength=m.max_osd)
        ap = actp[(actp >= 0) & (actp < m.max_osd)]
        prim += np.bincount(ap, minlength=m.max_osd)
    elapsed = time.perf_counter() - begin
    # osdmaptool --test-map-pgs output shape: header, per-osd rows
    # (count / first-in-up / primary / crush weight / reweight),
    # summary.  The summary spans every existing IN osd (crush weight
    # > 0 and not marked out) — an in-but-empty osd counts as 0, so
    # min CAN be 0: that imbalance is exactly what the sweep surfaces
    # (summarizing only nonzero counts masked it).
    from ..crush.balancer import osd_crush_weights
    crush_w = osd_crush_weights(m.crush)
    in_mask = np.array([crush_w[o] > 0 and not m.is_out(o)
                        for o in range(m.max_osd)])
    print("#osd\tcount\tfirst\tprimary\tc wt\twt")
    for osd in range(m.max_osd):
        print(f"osd.{osd}\t{total[osd]}\t{first[osd]}\t{prim[osd]}"
              f"\t{crush_w[osd] / 0x10000:.5g}"
              f"\t{m.osd_weight[osd] / IN_WEIGHT:.5g}")
    in_osds = total[in_mask] if in_mask.any() else total[total > 0]
    avg = in_osds.mean() if in_osds.size else 0.0
    print(f" avg {avg:.2f} stddev {in_osds.std() if in_osds.size else 0:.2f}"
          f" min {in_osds.min() if in_osds.size else 0}"
          f" max {in_osds.max() if in_osds.size else 0}")
    print(f"mapped {n_pgs} pgs in {elapsed:.3f}s "
          f"({n_pgs / elapsed:.0f} pgs/s, engine={engine})")
    return 0


def upmap(m: OSDMap, pool_ids, out_path: str, deviation: float,
          max_entries: int, engine: str) -> int:
    # one aggregate run over the pool set (OSDMap::calc_pg_upmaps
    # only_pools semantics: combined per-osd counts vs the sum of
    # per-pool rule-subtree targets)
    changes = calc_pg_upmaps(m, pool_ids, max_deviation=deviation,
                             max_iterations=max_entries, engine=engine)
    lines = []
    for (pool_id, seed), items in sorted(changes.items()):
        flat = " ".join(f"{f} {t}" for f, t in items)
        lines.append(
            f"ceph osd pg-upmap-items {pool_id}.{seed} {flat}")
    out = open(out_path, "w") if out_path != "-" else sys.stdout
    try:
        for ln in lines:
            print(ln, file=out)
        out.flush()
        if out is not sys.stdout:
            out.close()
            print(f"wrote {len(lines)} pg-upmap-items commands "
                  f"to {out_path}")
            sys.stdout.flush()
    except BrokenPipeError:
        # stdout piped into head & co.: not an error.  Redirect the fd
        # at devnull so the interpreter's exit-time flush can't raise
        # again (the python docs' SIGPIPE pattern).
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
    return 0


def createsimple(n: int, out_path: str, pg_num: int) -> int:
    from ..crush.builder import CrushBuilder
    from ..crush.types import (step_chooseleaf_firstn, step_emit,
                               step_take)
    b = CrushBuilder()
    root = b.build_two_level(n, 1)
    b.add_rule(0, [step_take(root),
                   step_chooseleaf_firstn(0, b.type_id("host")),
                   step_emit()], name="replicated_rule")
    m = OSDMap(crush=b.map)
    pool = PGPool(pool_id=1, pg_num=pg_num, size=3)
    m.pools[1] = pool
    json.dump(dump_osdmap(m, [pool]), open(out_path, "w"), indent=1)
    print(f"osdmaptool: wrote {n}-osd map with pool 1 "
          f"(pg_num={pg_num}) to {out_path}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool",
                                description=__doc__.split("\n")[0])
    p.add_argument("mapfn", nargs="?", help="OSDMap JSON file")
    p.add_argument("--print", action="store_true", dest="print_map",
                   help="print a map summary (osdmaptool --print)")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--upmap", metavar="OUT",
                   help="write pg-upmap-items commands ('-' = stdout)")
    p.add_argument("--upmap-deviation", type=float, default=1.0)
    p.add_argument("--upmap-max", type=int, default=100)
    p.add_argument("--pool", type=int, action="append",
                   help="restrict to pool id (repeatable)")
    p.add_argument("--engine", choices=("host", "bulk"), default="bulk")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --engine bulk and the EC plugin of "
                        "--create-ec-pool run (default: the card)")
    p.add_argument("--createsimple", type=int, metavar="N")
    p.add_argument("--pg-num", type=int, default=128,
                   help="pg_num for --createsimple / --create-ec-pool")
    p.add_argument("--create-ec-pool", metavar="NAME",
                   help="create an erasure pool from an EC profile "
                        "(mon analog: profile -> plugin rule -> pool); "
                        "writes the updated map to -o (or in place)")
    p.add_argument("--ec-profile", action="append", default=[],
                   metavar="K=V",
                   help="EC profile entry for --create-ec-pool "
                        "(repeatable; e.g. plugin=jerasure k=4 m=2 "
                        "crush-failure-domain=host crush-root=default)")
    p.add_argument("--pool-id", type=int, default=None,
                   help="pool id for --create-ec-pool (default: next)")
    p.add_argument("-o", "--outfn",
                   help="output map for --createsimple/--create-ec-pool")
    a = p.parse_args(argv)

    if a.createsimple:
        if not a.outfn:
            p.error("--createsimple requires -o")
        return createsimple(a.createsimple, a.outfn, a.pg_num)
    if not a.mapfn:
        p.error("an OSDMap JSON file is required")
    m = load_osdmap(a.mapfn)
    m.device = a.device
    if a.print_map and a.create_ec_pool:
        # --print composes with every mode; the pool-create branch
        # returns early, so summarize the BEFORE state here
        print_map(m)
    if a.create_ec_pool:
        from ..crush.poolops import create_erasure_pool
        from ..utils.config import ErasureCodeProfileStore
        profile = {}
        for kv in a.ec_profile:
            if "=" not in kv:
                p.error(f"--ec-profile {kv!r} is not K=V")
            k, _, v = kv.partition("=")
            profile[k] = v
        store = ErasureCodeProfileStore(device=a.device)
        try:
            store.set(a.create_ec_pool, profile)
            pool_id = (a.pool_id if a.pool_id is not None
                       else max(m.pools, default=0) + 1)
            pool = create_erasure_pool(m, store, a.create_ec_pool,
                                       pool_id=pool_id, pg_num=a.pg_num)
        except (ValueError, KeyError, OSError) as e:
            # OSError: the registry's dlopen-analog load of an unknown
            # plugin module
            raise SystemExit(f"osdmaptool: --create-ec-pool: {e}")
        out_fn = a.outfn or a.mapfn
        json.dump(dump_osdmap(m, list(m.pools.values())),
                  open(out_fn, "w"), indent=1)
        print(f"osdmaptool: created erasure pool {pool.pool_id} "
              f"(size={pool.size} min_size={pool.min_size} "
              f"rule={pool.crush_rule}) in {out_fn}")
        return 0
    if a.print_map:
        # the reference performs --print ALONGSIDE other modes
        print_map(m)
        if not (a.test_map_pgs or a.upmap):
            return 0
    pool_ids = a.pool or sorted(m.pools)
    for pid in pool_ids:
        if pid not in m.pools:
            p.error(f"pool {pid} not in map")
    if a.test_map_pgs:
        return test_map_pgs(m, pool_ids, a.engine)
    if a.upmap:
        return upmap(m, pool_ids, a.upmap, a.upmap_deviation,
                     a.upmap_max, a.engine)
    p.error("nothing to do (--print / --test-map-pgs / --upmap / "
            "--createsimple / --create-ec-pool)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
