"""The port's recovery orchestrator (``ceph_tpu_torch.recovery``) against
the reference's on the same seeded placement groups: the cases and the
seeded torture slice of ``tests/test_recovery_churn.py`` (epoch fence,
regroups, every crash site, torn writes, the intent journal, the
throttle, deadlines, MapChurn) and ``tests/test_recovery_flow.py`` (the
OSD-failure flow across CRUSH and the code).  Every run must lose no
data and heal byte for byte, and its ``RecoveryReport.to_dict()``, its
write log and its journal must be the reference's, letter for letter.
The orchestrator runs on a FakeClock, on both repair branches: the host
path (``device=False``) and the fused call on the code's device (here
the CPU's plain torch tier) against the reference's device path.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

K, M = 4, 2
N = K + M
POOL, PS = 1, 9
NONE = 0x7FFFFFFF


def world(name: str) -> SimpleNamespace:
    mods = {"chaos": "chaos", "store": "chaos.store", "stripe": "codes.stripe",
            "registry": "codes.registry", "crush": "crush",
            "osdmap": "crush.osdmap", "inc": "crush.incremental",
            "recovery": "recovery", "retry": "utils.retry",
            "errors": "utils.errors"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, bytearray):
        return bytes(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def both(fn):
    """``fn(W)`` on both packages; plain results equal; the port's."""
    got, want = plain(fn(PORT)), plain(fn(REF))
    assert got == want
    return got


def code(W):
    kw = {"device": "cpu"} if W is PORT else {}
    return W.registry.ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": str(K),
                     "m": str(M)}, **kw)


def build_cluster(W, n_hosts=N + 3, devs=2, size=N, pool=POOL, pg_num=16):
    C = W.crush
    b = C.CrushBuilder()
    root = b.build_two_level(n_hosts, devs)
    b.add_rule(0, [C.step_take(root),
                   C.step_chooseleaf_indep(size, b.type_id("host")),
                   C.step_emit()])
    m = W.osdmap.OSDMap(crush=b.map)
    if W is PORT:
        m.device = "cpu"
    m.pools[pool] = W.osdmap.PGPool(pool_id=pool, pg_num=pg_num, size=size,
                                    erasure=True)
    return m


def make_pg(W, n_objects=3, stripes=2, size=1024, seed=7, faults=None):
    ec = code(W)
    width = K * ec.get_chunk_size(K * size)
    sinfo = W.stripe.StripeInfo(K, width)
    osdmap = build_cluster(W)
    rng = np.random.default_rng(seed)
    faults = faults or [([0], []), ([3], [1]), ([], [4])][:n_objects]
    originals, stores, hinfos = [], [], []
    for i in range(n_objects):
        obj = rng.integers(0, 256, size=width * stripes,
                           dtype=np.uint8).tobytes()
        shards = W.stripe.encode(sinfo, ec, obj)
        hinfo = W.stripe.HashInfo(N)
        hinfo.append(0, shards)
        erased, flipped = faults[i % len(faults)]
        inj = []
        if erased:
            inj.append(W.chaos.ShardErasure(shards=list(erased)))
        if flipped:
            inj.append(W.chaos.BitFlip(shards=list(flipped), flips=1))
        store, _ = W.chaos.inject(shards, inj, seed=seed + i,
                                  chunk_size=sinfo.chunk_size)
        originals.append(shards)
        stores.append(store)
        hinfos.append(hinfo)
    return SimpleNamespace(sinfo=sinfo, ec=ec, osdmap=osdmap,
                           originals=originals, stores=stores,
                           hinfos=hinfos)


def recover(W, pg, **kw):
    kw.setdefault("device", False)
    kw.setdefault("clock", W.retry.FakeClock())
    return W.recovery.recover_to_completion(
        pg.sinfo, pg.ec, pg.osdmap, POOL, PS, pg.stores, pg.hinfos, **kw)


def summary(W, pg, rep, journal=None):
    """What a run must match letter for letter, and its heal."""
    return {"report": rep.to_dict(), "writes": plain(rep.writes),
            "journal": plain(rep.journal),
            "pending": None if journal is None else len(journal.pending()),
            "epoch": W.inc.get_epoch(pg.osdmap),
            "healed": W.recovery.healed(pg.stores, pg.originals),
            "stores": [s.snapshot() for s in pg.stores]}


# -- convergence and idempotency ---------------------------------------------

@pytest.mark.parametrize("device", [False, None], ids=["host", "device"])
def test_recovery_converges_byte_identical(device):
    def run(W):
        pg = make_pg(W)
        rep = recover(W, pg, device=device)
        first = summary(W, pg, rep)
        rep2 = recover(W, pg, device=device)
        return first, summary(W, pg, rep2)

    first, again = both(run)
    r = first["report"]
    assert r["converged"] and not r["unrecoverable"] and first["healed"]
    assert r["ops_completed"] == 3 and r["writes"] >= 3
    if device is None:
        assert r["device_calls"] == r["pattern_batches"] > 0
    assert again["report"]["ops_planned"] == 0 and again["healed"]
    assert again["report"]["rounds"] == 0 and not again["writes"]


# -- the epoch fence -------------------------------------------------------------

class OutBetweenDecodeAndWriteback:
    """Marks one acting OSD down+out the first time the orchestrator
    reaches write-back: the window the fence must cover."""

    def __init__(self, W, slot):
        self.W, self.slot, self.victim = W, slot, None

    def step(self, osdmap, stage):
        if stage != "writeback" or self.victim is not None:
            return
        _, _, acting, _ = osdmap.pg_to_up_acting_osds(POOL, PS)
        self.victim = int(acting[self.slot])
        I = self.W.inc
        I.apply_incremental(osdmap, I.Incremental(
            epoch=I.get_epoch(osdmap) + 1,
            new_state={self.victim: I.CEPH_OSD_UP},
            new_weight={self.victim: 0}))


def test_epoch_fence_replans_to_new_placement():
    def run(W):
        pg = make_pg(W, faults=[([0], [])])
        churn = OutBetweenDecodeAndWriteback(W, slot=0)
        rep = recover(W, pg, churn=churn)
        down_epoch = W.inc.get_epoch(pg.osdmap)
        late = [w for w in rep.writes if w.epoch >= down_epoch]
        assert late and all(w.osd != churn.victim for w in late)
        return summary(W, pg, rep), churn.victim

    s, victim = both(run)
    assert s["healed"] and s["report"]["replans"] >= 1
    assert victim is not None


@pytest.mark.parametrize("device", [False, None], ids=["host", "device"])
def test_regroup_on_dispatch_churn(device):
    def run(W):
        pg = make_pg(W, n_objects=4, faults=[([0], []), ([3], []),
                                             ([0], []), ([3], [])])
        churn = W.chaos.MapChurn(seed=3, max_events=1, fire_every=1,
                                 stages=("dispatch",))
        rep = recover(W, pg, churn=churn, device=device)
        return summary(W, pg, rep), churn.events

    s, events = both(run)
    assert len(events) == 1 and s["report"]["regroups"] >= 1
    assert s["report"]["converged"] and s["healed"]


# -- crash sites and journal replay -------------------------------------------

@pytest.mark.parametrize("site", PORT.chaos.CRASH_SITES)
def test_crash_at_every_site_resumes_idempotently(site):
    def run(W):
        pg = make_pg(W)
        journal = W.recovery.IntentJournal()
        rep = recover(W, pg, journal=journal,
                      crashpoint=W.chaos.CrashPoint(site=site))
        first = summary(W, pg, rep, journal)
        rep2 = recover(W, pg, journal=journal)
        return first, summary(W, pg, rep2, journal)

    first, again = both(run)
    assert first["report"]["crashes"] == 1 and first["healed"]
    assert first["report"]["converged"] and first["pending"] == 0
    assert again["report"]["ops_planned"] == 0 and not again["writes"]


def test_crash_after_commit_replay_keeps_writes():
    def run(W):
        pg = make_pg(W, n_objects=1, faults=[([2], [])])
        rep = recover(W, pg, crashpoint=W.chaos.CrashPoint(
            site="writeback.after_commit"))
        return summary(W, pg, rep)

    s = both(run)
    assert s["healed"] and s["report"]["journal"]["completed"] >= 1
    assert s["report"]["journal"]["shards_deleted"] == 0


@pytest.mark.parametrize("crash", [False, True])
def test_torn_write_caught_and_rewritten(crash):
    """A torn write-back is caught live (and rewritten), or, under a
    crash mid-write-back, rolled back by the journal's full-payload CRC
    at replay and repaired again."""
    def run(W):
        pg = make_pg(W, n_objects=1, faults=[([1], [])])
        W.chaos.TornWrite(shards=[1], keep=7 if crash else 5).apply(
            pg.stores[0], np.random.default_rng(0))
        kw = ({"crashpoint": W.chaos.CrashPoint(
            site="writeback.after_write")} if crash else {})
        return summary(W, pg, recover(W, pg, **kw))

    s = both(run)
    r = s["report"]
    assert s["healed"] and r["converged"]
    if crash:
        assert r["crashes"] == 1 and r["journal"]["rolled_back"] >= 1
    else:
        assert r["torn_rewrites"] >= 1


def test_journal_replay_is_idempotent():
    def run(W):
        store = W.store.ShardStore({0: b"full-payload", 1: b"torn"},
                                   chunk_size=16)
        j = W.recovery.IntentJournal()
        j.begin(j.allocate_op_id(), 0, 5,
                {0: b"full-payload", 1: b"torn-but-intended-longer"},
                {0: 10, 1: 11})
        s1 = j.replay([store])
        snap = store.snapshot()
        s2 = j.replay([store])
        return plain(s1), plain(s2), snap, store.snapshot(), \
            len(j.pending()), W.recovery.payload_digest(b"0123456789abcdef")

    s1, s2, snap, after, pending, digest = both(run)
    assert s1[1]["replayed"] == 1 and s1[1]["rolled_back"] == 1
    assert s2[1]["replayed"] == 0 and snap == after and pending == 0
    assert digest[1] == 16


# -- throttle and deadlines ---------------------------------------------------

def test_throttle_bounds_per_osd_admissions():
    def run(W):
        pg = make_pg(W, n_objects=5, faults=[([0], [])] * 5)
        throttle = W.recovery.OsdRecoveryThrottle(max_inflight=2)
        rep = recover(W, pg, throttle=throttle)
        return summary(W, pg, rep), throttle.peak

    s, peak = both(run)
    assert s["healed"] and peak <= 2
    assert s["report"]["throttle_deferrals"] >= 1 and s["report"]["rounds"] >= 3


def test_throttle_limits_equal_reference():
    """Weighted limits, the floor of one slot, all-or-nothing admission,
    live re-clamps and the scale lever answer as the reference's do."""
    def run(W):
        T = W.recovery.OsdRecoveryThrottle
        t = T(max_inflight=4)
        out = []
        t.set_osd_weights({0: 0.1, 1: 0.5, 2: 1.0, 3: 2.0})
        out.append([t.limit_for(o) for o in (0, 1, 2, 3, 9)])
        out.append([t.admit([0, 9]), t.admit([0, 8]), t.admit([8])])
        t.reset_round()
        out.append(t.admit([0, 8]))
        t = T(max_inflight=4)
        out.append([t.admit([0]) for _ in range(5)])
        t.set_osd_weights({0: 0.25})
        for _ in range(4):
            out.append((t.admit([0]), dict(t.inflight)))
            t.release([0])
        t.set_osd_weights({})
        t.set_scale(0.5)
        out.append([t.limit_for(0), t.admit([0]), t.admit([0]),
                    t.admit([0])])
        t.set_scale(0.05)
        out.append(t.limit_for(0))
        t.set_scale(7.5)
        out.append((t.limit_for(7), t.peak))
        t0 = T(max_inflight=0)
        t0.set_osd_weights({0: 0.5})
        out.append([t0.admit([0]), t0.admit([5])])
        return out

    out = both(run)
    assert out[0] == [1, 2, 4, 4, 4] and out[1] == [True, False, True]


def test_throttle_weighted_recovery_still_heals():
    def run(W):
        pg = make_pg(W, n_objects=4, faults=[([0], [])] * 4)
        throttle = W.recovery.OsdRecoveryThrottle(max_inflight=2)
        throttle.set_osd_weights({o: 0.01 for o in range(pg.osdmap.max_osd)})
        rep = recover(W, pg, throttle=throttle)
        return summary(W, pg, rep), throttle.peak

    s, peak = both(run)
    assert s["healed"] and peak <= 1


def test_deadline_expired_op_reported_not_retried():
    def run(W):
        pg = make_pg(W, n_objects=2, faults=[([0], [])])
        rep = recover(W, pg, throttle=W.recovery.OsdRecoveryThrottle(
            max_inflight=0), op_deadline=1.5, round_delay=1.0)
        return summary(W, pg, rep)

    s = both(run)
    r = s["report"]
    assert r["converged"] and r["expired"] == [0, 1]
    assert r["ops_completed"] == 0 and not s["writes"] and r["rounds"] <= 3


# -- the seeded torture slice -------------------------------------------------

def _torture_scenarios():
    """MapChurn x CrashPoint x TornWrite x shard faults (the reference's
    grid)."""
    sites = (None,) + PORT.chaos.CRASH_SITES
    for seed in range(15):
        for si, site in enumerate(sites):
            for torn in (False, True):
                yield seed * 100 + si * 10 + torn, site, torn


def _scenario(W, scenario_seed, site, torn, device):
    rng = np.random.default_rng(scenario_seed)
    faults = []
    for _ in range(3):
        n_bad = int(rng.integers(1, M + 1))
        victims = rng.choice(N, size=n_bad, replace=False)
        cut = int(rng.integers(0, n_bad + 1))
        faults.append(([int(v) for v in victims[:cut]],
                       [int(v) for v in victims[cut:]]))
    pg = make_pg(W, n_objects=3, seed=scenario_seed, faults=faults)
    if torn:
        erased, _ = faults[0]
        W.chaos.TornWrite(shards=[erased[0] if erased else 0], keep=9).apply(
            pg.stores[0], np.random.default_rng(scenario_seed))
    churn = W.chaos.MapChurn(seed=scenario_seed, max_down=1, p_fire=0.4,
                             max_events=3)
    crash = W.chaos.CrashPoint(site=site) if site else None
    journal = W.recovery.IntentJournal()
    rep = recover(W, pg, journal=journal, churn=churn, crashpoint=crash,
                  op_deadline=1e6, device=device)
    ok = [i for i in range(3) if i not in rep.unrecoverable]
    first = summary(W, pg, rep, journal)
    first["ok_healed"] = W.recovery.healed([pg.stores[i] for i in ok],
                                           [pg.originals[i] for i in ok])
    first["events"] = churn.events
    rep2 = recover(W, pg, journal=journal, device=device)
    return first, summary(W, pg, rep2, journal)


@pytest.mark.parametrize("scenario_seed,site,torn",
                         list(_torture_scenarios())[:14])
def test_recovery_torture_slice_equals_reference(scenario_seed, site, torn):
    """Zero data loss, an empty journal, no overrun deadline and an
    idempotent rerun — with the reference's report, writes and events."""
    first, again = both(lambda W: _scenario(W, scenario_seed, site, torn,
                                            False))
    r = first["report"]
    assert r["converged"] and first["ok_healed"] and first["pending"] == 0
    assert not r["expired"] and r["crashes"] == (1 if site else 0)
    assert again["report"]["ops_planned"] == 0 and not again["writes"]


@pytest.mark.parametrize("scenario_seed,site,torn",
                         [(0, None, False), (221, "writeback.after_write",
                                             True)])
def test_recovery_torture_on_the_device_branch(scenario_seed, site, torn):
    """The same scenarios with the fused call on the code's device: the
    port's plain torch tier against the reference's device path."""
    first, again = both(lambda W: _scenario(W, scenario_seed, site, torn,
                                            None))
    r = first["report"]
    assert r["converged"] and first["ok_healed"]
    assert r["device_calls"] == r["pattern_batches"] > 0
    assert not again["writes"]


# -- the OSD-failure flow (tests/test_recovery_flow.py) -----------------------

def test_osd_failure_recovery_flow():
    """Place a pg, encode, lose the OSD holding shard 1, remap, rebuild
    the shard for its new home under the HashInfo gate, backfill, and
    read the object back — in both packages, with the same placements
    and bytes."""
    def run(W):
        m = build_cluster(W, n_hosts=7, pool=2, pg_num=32)
        ec = code(W)
        width = K * ec.get_chunk_size(K * 4096)
        sinfo = W.stripe.StripeInfo(K, width)
        up, _, acting, _ = m.pg_to_up_acting_osds(2, 9)
        assert len(up) == N and NONE not in up
        rng = np.random.default_rng(99)
        obj = rng.integers(0, 256, size=width * 16, dtype=np.uint8).tobytes()
        shards = W.stripe.encode(sinfo, ec, obj)
        hinfo = W.stripe.HashInfo(N)
        hinfo.append(0, shards)
        stored = {acting[i]: shards[i] for i in range(N)}
        dead = acting[1]
        m.mark_down(dead)
        m.mark_out(dead)
        _, _, acting2, _ = m.pg_to_up_acting_osds(2, 9)
        assert dead not in acting2
        plan = ec.minimum_to_decode({1}, set(range(N)) - {1})
        rec = W.stripe.decode(sinfo, ec, {s: stored[acting[s]]
                                          for s in plan}, {1})[1]
        assert rec == shards[1]
        assert W.stripe.ceph_crc32c(0xFFFFFFFF, rec) == \
            hinfo.get_chunk_hash(1)
        old = dict(stored)
        stored[acting2[1]] = rec
        for i in range(N):
            if i != 1 and acting2[i] != acting[i]:
                stored[acting2[i]] = old[acting[i]]
        chunks = {i: stored[acting2[i]] for i in range(K)}
        cs = sinfo.chunk_size
        rebuilt = b"".join(chunks[i][s * cs:(s + 1) * cs]
                           for s in range(16) for i in range(K))
        assert rebuilt == obj
        return acting, acting2, sorted(plan)

    both(run)


def test_eio_corruption_detected_and_rereconstructed():
    def run(W):
        ec = code(W)
        width = K * ec.get_chunk_size(K * 1024)
        sinfo = W.stripe.StripeInfo(K, width)
        rng = np.random.default_rng(5)
        obj = rng.integers(0, 256, size=width * 4, dtype=np.uint8).tobytes()
        shards = W.stripe.encode(sinfo, ec, obj)
        hinfo = W.stripe.HashInfo(N)
        hinfo.append(0, shards)
        bad = bytearray(shards[2])
        bad[137] ^= 0x40
        stored = dict(shards)
        stored[2] = bytes(bad)
        failed = {s for s in stored
                  if W.stripe.ceph_crc32c(0xFFFFFFFF, stored[s])
                  != hinfo.get_chunk_hash(s)}
        survivors = {s: stored[s] for s in stored if s not in failed}
        plan = ec.minimum_to_decode(failed, set(survivors))
        rec = W.stripe.decode(sinfo, ec, {s: survivors[s] for s in plan},
                              failed)[2]
        return sorted(failed), rec == shards[2]

    assert both(run) == [[2], True]


def test_mass_failure_degraded_but_readable():
    """Lose two OSDs: every pg keeps at most m holes, and the port's bulk
    evaluator (``device="cpu"``) agrees with the scalar pipeline and the
    reference."""
    def run(W):
        m = build_cluster(W, n_hosts=8, pool=2, pg_num=32)
        for dead in (0, 5):
            m.mark_down(dead)
        up, _ = m.pg_to_up_bulk(2, engine="bulk")
        for ps in range(32):
            assert int((up[ps] == NONE).sum()) <= M
            assert up[ps].tolist() == m.pg_to_up_acting_osds(2, ps)[0]
        return up.tolist()

    both(run)
