"""Map churn: one OSD event per epoch, each applied through the
program's ``apply_incremental`` and followed by ``OSDMap.pg_to_up_bulk``
over every placement group of the erasure-coded pool, one epoch in
flight.  The window runs whole epochs: it closes when the epoch under
way at ``--seconds`` completes.

Set-up builds the configuration's cluster (root -> hosts -> OSDs, straw2)
with the program's ``CrushBuilder``, the pool's rule with the codec's
``create_rule``, and runs ``warm_epochs`` of the seeded events
(``churn.events``) so that every path the window takes has run once.
After the window, ``sample_epochs`` epochs drawn from the seed are
compared with the plain reference (``placement``, the frozen mapper):
``sample_pgs`` placement groups drawn uniformly and as many drawn from
those whose up set held the epoch's OSD before or after it, each up set
and primary exactly; and every placement group's up set is checked to
hold no OSD that the reference's own states have down.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import churn, faults, placement
from ..record import Check, Run
from ..trace import Tracer


def build(config: dict, device: torch.device):
    """(the program's OSDMap, pool id) for the configuration."""
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.crush.osdmap import OSDMap, PGPool
    from ceph_tpu_torch.crush.types import Tunables
    cluster, profile = config["cluster"], config["profile"]
    b = CrushBuilder(tunables=Tunables(**cluster["tunables"]))
    b.add_type(placement.TYPES["host"], "host")
    b.add_type(placement.TYPES["root"], "root")
    w = cluster["osd_weight"]
    hosts = [b.add_bucket(cluster["bucket_alg"], "host", devs,
                          weights=[w] * len(devs), bucket_id=bid,
                          name=f"host{h}")
             for h, bid in enumerate(placement.host_ids(cluster))
             for devs in [placement.host_devices(cluster, h)]]
    b.add_bucket(cluster["bucket_alg"], "root", hosts,
                 bucket_id=placement.root_id(cluster), name=cluster["root"])
    args = {k: v for k, v in profile.items() if k != "plugin"}
    args.update({"crush-root": cluster["root"],
                 "crush-failure-domain": cluster["failure_domain"]})
    code = ErasureCodePluginRegistry.instance().factory(
        profile["plugin"], args, device=device)
    rule = code.create_rule(b, name=cluster["rule"]["name"])
    pool = cluster["pool"]
    k = int(profile["k"])
    osdmap = OSDMap(crush=b.map, pools={pool["pool_id"]: PGPool(
        pool["pool_id"], pool["pg_num"], size=pool["size"], min_size=k + 1,
        crush_rule=rule, erasure=True)},
        device=None if device.type == "cuda" else "cpu")
    return osdmap, pool["pool_id"]


def incremental(ev: churn.Event, epoch: int):
    from ceph_tpu_torch.crush.incremental import CEPH_OSD_UP, Incremental
    inc = Incremental(epoch=epoch, new_weight={ev.osd: ev.weight})
    if ev.op in ("down_out", "revive"):
        inc.new_state = {ev.osd: CEPH_OSD_UP}   # xor: up <-> down
    return inc


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, inject=None) -> Run:
    from ceph_tpu_torch.crush.incremental import apply_incremental
    config, traffic = cell.config, cell.traffic
    cluster = config["cluster"]
    n_osds = cluster["hosts"] * cluster["osds_per_host"]
    t_stage = time.perf_counter()
    osdmap, pid = build(config, device)
    t_warm = time.perf_counter()

    def evaluate(m):
        return m.pg_to_up_bulk(pid)

    apply, evaluate, stale = faults.remap_steps(
        inject, apply_incremental, evaluate, placement.NONE)
    events = churn.events(seed, n_osds, traffic)
    history = []      # every event, set-up's first
    results = []      # (up, primary) after each event

    def epoch(spans=None):
        ev = next(events)
        history.append(ev)
        inc = incremental(ev, osdmap.epoch + 1)
        a = time.perf_counter()
        if stale:
            got = evaluate(osdmap)
            t = time.perf_counter()
            apply(osdmap, inc)
        else:
            apply(osdmap, inc)
            t = time.perf_counter()
            got = evaluate(osdmap)
        d = time.perf_counter()
        results.append(got)
        if spans is not None:
            spans["incremental"].append((a, t) if not stale else (t, d))
            spans["pg_to_up_bulk"].append((t, d) if not stale else (a, t))
        return a, d

    for _ in range(traffic["warm_epochs"]):
        epoch()
    # the peak is the window's own: the map, its tables and one epoch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    warm = len(history)
    issued, done = [], []
    spans = {"incremental": [], "pg_to_up_bulk": []}

    def window():
        """Whole epochs: the window closes when the epoch under way at
        ``seconds`` completes, so it holds all the work of its time."""
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            a, d = epoch(spans)
            issued.append(a)
            done.append(d)
        return t0, done[-1]

    gc.collect()
    gc.freeze()
    tracer = None
    if trace:
        with Tracer(device) as tracer:
            t0, t1 = window()
    else:
        t0, t1 = window()
    run = Run(op="remap", setup_s=t0 - t_start, t0=t0, t1=t1,
              work=float(cluster["pool"]["pg_num"]),
              issued=np.array(issued), done=np.array(done), spans=spans)
    if tracer is not None:
        run.trace = tracer.reduce(spans)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    run.setup_parts = {"before": t_stage - t_start,
                       "stage": t_warm - t_stage, "warm": t0 - t_warm}
    del osdmap
    t_check = time.perf_counter()
    check(run, cell, seed, history, results, warm)
    run.check_s = time.perf_counter() - t_check
    return run


def check(run: Run, cell, seed: int, history: list, results: list,
          warm: int) -> None:
    """Compare sampled epochs of the window with the plain reference."""
    cluster, traffic = cell.config["cluster"], cell.traffic
    n_osds = cluster["hosts"] * cluster["osds_per_host"]
    ref = placement.Placement(cluster, cluster["pool"])
    rng = np.random.default_rng([seed, 0xC5])
    n = len(history) - warm
    picks = sorted(set(rng.choice(n, min(traffic["sample_epochs"], n),
                                  replace=False).tolist()) | {n - 1})
    states = churn.OsdStates(n_osds)
    upsets = primaries = down_entries = compared = 0
    g = 0
    for j in picks:
        while g <= warm + j:
            states.apply(history[g])
            g += 1
        ev = history[warm + j]
        up, primary = results[warm + j]
        prev_up = results[warm + j - 1][0]
        down_entries += int(np.isin(up, states.down()).sum())
        pg_num = len(up)
        pgs = set(rng.choice(pg_num, traffic["sample_pgs"],
                             replace=False).tolist())
        touched = np.flatnonzero((up == ev.osd).any(axis=1)
                                 | (prev_up == ev.osd).any(axis=1))
        if touched.size:
            pgs |= set(rng.choice(touched, min(traffic["sample_pgs"],
                                               touched.size),
                                  replace=False).tolist())
        for ps in sorted(pgs):
            want_up, want_primary = ref.up(ps, states.up, states.weight)
            upsets += list(up[ps]) != want_up
            primaries += int(primary[ps]) != want_primary
            compared += 1
    run.checks = [Check("mismatched_up_sets", upsets, 0),
                  Check("mismatched_primaries", primaries, 0),
                  Check("down_osds_in_up_sets", down_entries, 0)]
    run.sampled = compared
    run.failed = upsets + primaries


__all__ = ["build", "check", "incremental", "run"]
