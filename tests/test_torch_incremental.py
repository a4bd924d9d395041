"""OSDMap epochs in the port (``ceph_tpu_torch.crush.incremental`` and
``inc_binary``) against the reference's: every case of
``tests/test_incremental.py`` run through both packages (epoch rules,
XOR state bits, override layers, pools, crush replacement, randomized
delta streams, MapChurn sequences) with the resulting map state and
every placement equal, and binary incrementals round-tripped across
the packages: a blob encoded by one decodes in the other to the same
delta, and re-encodes to the same bytes.  Exact comparisons.
"""

from __future__ import annotations

import importlib
import struct
from types import SimpleNamespace

import numpy as np
import pytest

NONE = 0x7FFFFFFF


def world(name: str) -> SimpleNamespace:
    mods = {"crush": "crush", "osdmap": "crush.osdmap",
            "inc": "crush.incremental", "wire": "crush.inc_binary",
            "types": "crush.types", "chaos": "chaos"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def make_map(W, pg_num=32, hosts=4, devs=2):
    C = W.crush
    b = C.CrushBuilder()
    root = b.build_two_level(hosts, devs)
    b.add_rule(0, [C.step_take(root), C.step_chooseleaf_firstn(3, 1),
                   C.step_emit()])
    m = W.osdmap.OSDMap(crush=b.map)
    if W is PORT:
        m.device = "cpu"
    m.pools[1] = W.osdmap.PGPool(pool_id=1, pg_num=pg_num, size=3)
    return m


def state(m, placements: bool = True) -> dict:
    """Everything an incremental can change, plus (by default) every
    placement."""
    out = {"epoch": m.epoch, "max_osd": m.max_osd,
           "exists": list(m.osd_exists), "up": list(m.osd_up),
           "weight": list(m.osd_weight),
           "affinity": (None if m.osd_primary_affinity is None
                        else list(m.osd_primary_affinity)),
           "pg_temp": dict(m.pg_temp), "primary_temp": dict(m.primary_temp),
           "upmap": dict(m.pg_upmap),
           "upmap_items": {k: [tuple(p) for p in v]
                           for k, v in m.pg_upmap_items.items()},
           "pools": {pid: (p.pg_num, p.pgp_num, p.size, p.min_size,
                           p.crush_rule, p.erasure, p.hashpspool)
                     for pid, p in sorted(m.pools.items())}}
    if not placements:
        return out
    out["placements"] = {
        pid: [m.pg_to_up_acting_osds(pid, ps)
              for ps in range(m.pools[pid].pg_num)]
        for pid in sorted(m.pools)}
    return out


def both(fn):
    """``fn(W)`` on both packages; the results must be equal."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


# -- OSDMap::apply_incremental semantics -------------------------------------

def test_epoch_monotonic_and_gap_rejected():
    def run(W):
        m = make_map(W)
        I = W.inc
        msgs = [I.get_epoch(m)]
        I.apply_incremental(m, I.Incremental(epoch=1))
        for bad in (3, 1):
            with pytest.raises(ValueError, match="does not follow") as ei:
                I.apply_incremental(m, I.Incremental(epoch=bad))
            msgs.append(str(ei.value))
        I.apply_incremental(m, I.Incremental(epoch=2))
        return msgs, m.epoch

    assert both(run)[1] == 2


def test_state_xor_down_and_purge():
    def run(W):
        m = make_map(W)
        I = W.inc
        m.set_primary_affinity(3, 123)
        seen = []
        for epoch, bits in ((1, I.CEPH_OSD_UP), (2, I.CEPH_OSD_UP),
                            (3, I.CEPH_OSD_EXISTS | I.CEPH_OSD_UP)):
            I.apply_incremental(m, I.Incremental(epoch=epoch,
                                                 new_state={3: bits}))
            seen.append((m.exists(3), m.is_up(3)))
        return seen, state(m)

    seen, st = both(run)
    assert seen == [(True, False), (True, True), (False, False)]
    assert st["weight"][3] == 0 and st["affinity"][3] == 0x10000


def test_override_layer_add_and_remove():
    def run(W):
        m = make_map(W)
        I = W.inc
        seed = m.pools[1].raw_pg_to_pg(5)
        I.apply_incremental(m, I.Incremental(
            epoch=1, new_pg_temp={(1, seed): [1, 2, 3]},
            new_primary_temp={(1, seed): 2},
            new_pg_upmap={(1, seed + 1): [4, 5, 6]},
            new_pg_upmap_items={(1, seed): [(0, 7)]}))
        mid = state(m)
        I.apply_incremental(m, I.Incremental(
            epoch=2, new_pg_temp={(1, seed): []},
            new_primary_temp={(1, seed): -1},
            old_pg_upmap=[(1, seed + 1)],
            old_pg_upmap_items=[(1, seed)]))
        return mid, state(m), seed

    mid, end, seed = both(run)
    assert mid["pg_temp"][(1, seed)] == [1, 2, 3]
    assert mid["upmap_items"][(1, seed)] == [(0, 7)]
    assert not end["pg_temp"] and not end["primary_temp"]
    assert not end["upmap"] and not end["upmap_items"]


def test_incrementals_equal_direct_edits_through_pipeline():
    """A map advanced by incrementals places every pg exactly like a
    map edited directly (scalar and bulk pipelines), in both packages."""
    def run(W):
        I, O = W.inc, W.osdmap
        m_inc, m_dir = make_map(W, pg_num=48), make_map(W, pg_num=48)
        seed = m_dir.pools[1].raw_pg_to_pg(7)
        m_dir.mark_down(2)
        m_dir.osd_weight[5] = O.IN_WEIGHT // 2
        m_dir.set_primary_affinity(1, 77)
        m_dir.pg_temp[(1, seed)] = [6, 7, 0]
        m_dir.pools[2] = O.PGPool(pool_id=2, pg_num=16, size=2)
        final = I.catch_up(m_inc, [
            I.Incremental(epoch=1, new_state={2: I.CEPH_OSD_UP}),
            I.Incremental(epoch=2, new_weight={5: O.IN_WEIGHT // 2}),
            I.Incremental(epoch=3, new_primary_affinity={1: 77},
                          new_pg_temp={(1, seed): [6, 7, 0]}),
            I.Incremental(epoch=4, new_pools={
                2: O.PGPool(pool_id=2, pg_num=16, size=2)}),
        ])
        up_i, pr_i = m_inc.pg_to_up_bulk(1, engine="host")
        up_d, pr_d = m_dir.pg_to_up_bulk(1, engine="host")
        assert np.array_equal(up_i, up_d) and np.array_equal(pr_i, pr_d)
        st = state(m_inc)
        dst = state(m_dir)
        return final, st["placements"], dst["placements"], up_i.tolist()

    final, inc_pl, dir_pl, _ = both(run)
    assert final == 4 and inc_pl == dir_pl


def test_catch_up_sorts_and_skips_duplicates():
    def run(W):
        m = make_map(W)
        I = W.inc
        incs = [I.Incremental(epoch=2, new_weight={0: 0}),
                I.Incremental(epoch=1, new_state={1: I.CEPH_OSD_UP}),
                I.Incremental(epoch=2, new_weight={0: 0})]
        return I.catch_up(m, incs), state(m)

    final, st = both(run)
    assert final == 2 and st["weight"][0] == 0 and not st["up"][1]


def test_new_crush_swaps_hierarchy_and_invalidates_cache():
    """The port's bulk evaluator (``device="cpu"``) places on the new
    hierarchy after a crush replacement, like the scalar pipeline and
    like the reference."""
    def run(W):
        C, I = W.crush, W.inc
        m = make_map(W)
        m.pg_to_up_bulk(1, engine="bulk")           # warm the compiled map
        b2 = C.CrushBuilder()
        root2 = b2.build_two_level(2, 4)
        b2.add_rule(0, [C.step_take(root2), C.step_chooseleaf_firstn(3, 1),
                        C.step_emit()])
        I.apply_incremental(m, I.Incremental(epoch=1, new_crush=b2.map))
        up, _ = m.pg_to_up_bulk(1, engine="bulk")
        for ps in range(m.pools[1].pg_num):
            u, _, _, _ = m.pg_to_up_acting_osds(1, ps)
            assert up[ps].tolist() == (u + [NONE] * 3)[:3]
        return up.tolist()

    both(run)


def test_new_max_osd_resizes_vectors():
    def run(W):
        m = make_map(W)
        old = m.max_osd
        W.inc.apply_incremental(m, W.inc.Incremental(epoch=1,
                                                     new_max_osd=old + 4))
        grown = state(m)
        W.inc.apply_incremental(m, W.inc.Incremental(epoch=2,
                                                     new_max_osd=old))
        return old, grown, state(m)

    old, grown, shrunk = both(run)
    assert grown["max_osd"] == old + 4 and not grown["exists"][old]
    assert len(shrunk["weight"]) == old


def test_new_state_zero_means_mark_down_and_destroy_recreate():
    def run(W):
        I = W.inc
        m = make_map(W)
        I.apply_incremental(m, I.Incremental(epoch=1, new_state={3: 0}))
        seen = [(m.exists(3), m.is_up(3))]
        I.apply_incremental(m, I.Incremental(
            epoch=2, new_state={4: I.CEPH_OSD_EXISTS}))
        seen.append((m.exists(4), m.is_up(4)))
        I.apply_incremental(m, I.Incremental(
            epoch=3, new_state={4: I.CEPH_OSD_EXISTS}))
        seen.append((m.exists(4), m.is_up(4)))
        return seen, state(m)

    seen, _ = both(run)
    assert seen == [(True, False), (False, False), (True, False)]


def _direct_stream(W, seed, trials=3, epochs=10, pg_num=24):
    """Random epoch-ordered delta streams against the same edits made
    directly; returns the placements after every epoch."""
    I = W.inc
    rng = np.random.default_rng(seed)
    trail = []
    for trial in range(trials):
        m_inc, m_dir = make_map(W, pg_num), make_map(W, pg_num)
        for epoch in range(1, epochs + 1):
            inc = I.Incremental(epoch=epoch)
            kind = rng.integers(0, 5)
            osd = int(rng.integers(0, m_dir.max_osd))
            seed_pg = m_dir.pools[1].raw_pg_to_pg(int(rng.integers(0,
                                                                   pg_num)))
            if kind == 0:
                inc.new_state[osd] = I.CEPH_OSD_UP
                m_dir.osd_up[osd] = not m_dir.osd_up[osd]
            elif kind == 1:
                w = int(rng.integers(0, 0x10001))
                inc.new_weight[osd] = w
                m_dir.osd_weight[osd] = w
                if w:
                    m_dir.osd_exists[osd] = True
            elif kind == 2:
                aff = int(rng.integers(0, 0x10001))
                inc.new_primary_affinity[osd] = aff
                m_dir.set_primary_affinity(osd, aff)
            elif kind == 3:
                if (1, seed_pg) in m_dir.pg_temp and rng.random() < 0.5:
                    inc.new_pg_temp[(1, seed_pg)] = []
                    m_dir.pg_temp.pop((1, seed_pg), None)
                else:
                    temp = [int(o) for o in rng.choice(m_dir.max_osd, 3,
                                                       replace=False)]
                    inc.new_pg_temp[(1, seed_pg)] = list(temp)
                    m_dir.pg_temp[(1, seed_pg)] = list(temp)
            else:
                if (1, seed_pg) in m_dir.pg_upmap_items \
                        and rng.random() < 0.5:
                    inc.old_pg_upmap_items.append((1, seed_pg))
                    m_dir.pg_upmap_items.pop((1, seed_pg), None)
                else:
                    pair = (int(rng.integers(0, m_dir.max_osd)),
                            int(rng.integers(0, m_dir.max_osd)))
                    inc.new_pg_upmap_items[(1, seed_pg)] = [pair]
                    m_dir.pg_upmap_items[(1, seed_pg)] = [pair]
            I.apply_incremental(m_inc, inc)
            got = [m_inc.pg_to_up_acting_osds(1, ps) for ps in range(pg_num)]
            assert got == [m_dir.pg_to_up_acting_osds(1, ps)
                           for ps in range(pg_num)], (trial, epoch, kind)
            trail.append(got)
    return trail


def test_randomized_delta_streams_match_direct_edits():
    both(lambda W: _direct_stream(W, 20260730))


# -- the wire form: round trips within and across the packages ----------------

def _random_inc(W, rng, m, epoch):
    """One random placement-relevant delta against map ``m``."""
    C, I, O = W.crush, W.inc, W.osdmap
    inc = I.Incremental(epoch=epoch)
    osd = int(rng.integers(0, m.max_osd))
    seed = m.pools[1].raw_pg_to_pg(int(rng.integers(0, 24)))
    kind = int(rng.integers(0, 9))
    if kind == 0:
        inc.new_state[osd] = I.CEPH_OSD_UP
    elif kind == 1:
        inc.new_weight[osd] = int(rng.integers(0, 0x10001))
    elif kind == 2:
        inc.new_primary_affinity[osd] = int(rng.integers(0, 0x10001))
    elif kind == 3:
        if (1, seed) in m.pg_temp and rng.random() < 0.5:
            inc.new_pg_temp[(1, seed)] = []
        else:
            inc.new_pg_temp[(1, seed)] = [int(o) for o in rng.choice(
                m.max_osd, 3, replace=False)]
    elif kind == 4:
        if (1, seed) in m.pg_upmap_items and rng.random() < 0.5:
            inc.old_pg_upmap_items.append((1, seed))
        else:
            inc.new_pg_upmap_items[(1, seed)] = [
                (int(rng.integers(0, m.max_osd)),
                 int(rng.integers(0, m.max_osd)))]
    elif kind == 5:
        inc.new_primary_temp[(1, seed)] = (
            -1 if (1, seed) in m.primary_temp and rng.random() < 0.5
            else osd)
    elif kind == 6:
        pid = int(rng.integers(2, 5))
        if pid in m.pools and rng.random() < 0.5:
            inc.old_pools.append(pid)
        else:
            inc.new_pools[pid] = O.PGPool(
                pool_id=pid, pg_num=int(rng.integers(1, 33)),
                size=int(rng.integers(2, 5)),
                erasure=bool(rng.integers(0, 2)))
    elif kind == 7:
        if (1, seed) in m.pg_upmap and rng.random() < 0.5:
            inc.old_pg_upmap.append((1, seed))
        else:
            inc.new_pg_upmap[(1, seed)] = [int(o) for o in rng.choice(
                m.max_osd, 3, replace=False)]
    else:
        b2 = C.CrushBuilder()
        r2 = b2.build_two_level(4, 2)
        b2.add_rule(0, [C.step_take(r2), C.step_chooseleaf_firstn(3, 1),
                        C.step_emit()])
        inc.new_crush = b2.map
        inc.new_max_osd = 8
    return inc


def _wire_stream(W, seed, trials=3, epochs=12):
    """(blobs, placements after each epoch) of a random delta stream
    applied through encode -> decode in package ``W``."""
    rng = np.random.default_rng(seed)
    blobs, trail = [], []
    for _ in range(trials):
        m_wire, m_dir = make_map(W, 24), make_map(W, 24)
        for epoch in range(1, epochs + 1):
            inc = _random_inc(W, rng, m_dir, epoch)
            blob = W.wire.encode_incremental(inc)
            inc2 = W.wire.decode_incremental(blob)
            for f in ("epoch", "new_weight", "new_state",
                      "new_primary_affinity", "new_pg_temp",
                      "new_primary_temp", "new_pg_upmap", "old_pg_upmap",
                      "new_pg_upmap_items", "old_pg_upmap_items",
                      "new_pools", "old_pools", "new_max_osd"):
                assert getattr(inc2, f) == getattr(inc, f), f
            assert W.wire.encode_incremental(inc2) == blob
            W.inc.apply_incremental(m_wire, inc2)
            W.inc.apply_incremental(m_dir, inc)
            assert state(m_wire, False) == state(m_dir, False)
            blobs.append(blob)
        got = state(m_wire)
        assert got == state(m_dir)
        trail.append(got["placements"])
    return blobs, trail


@pytest.mark.parametrize("seed", [0x17C5, 99])
def test_incremental_wire_roundtrip_equals_reference(seed):
    """encode -> decode -> apply equals direct apply in the port, and the
    port's blobs are the reference's, byte for byte."""
    blobs, _ = both(lambda W: _wire_stream(W, seed))
    assert len(blobs) == 36 and len(set(blobs)) > 1


@pytest.mark.parametrize("seed", [7, 2026])
def test_incremental_blobs_cross_the_packages(seed):
    """A blob encoded by either package decodes in the other to the same
    delta, which applies to the same map state and re-encodes to the
    same bytes."""
    rng_r, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    m_r, m_p = make_map(REF, 24), make_map(PORT, 24)
    m_rp, m_pr = make_map(PORT, 24), make_map(REF, 24)
    for epoch in range(1, 16):
        inc_r = _random_inc(REF, rng_r, m_r, epoch)
        inc_p = _random_inc(PORT, rng_p, m_p, epoch)
        blob_r = REF.wire.encode_incremental(inc_r)
        blob_p = PORT.wire.encode_incremental(inc_p)
        assert blob_r == blob_p
        into_port = PORT.wire.decode_incremental(blob_r)
        into_ref = REF.wire.decode_incremental(blob_p)
        assert PORT.wire.encode_incremental(into_port) == blob_r
        assert REF.wire.encode_incremental(into_ref) == blob_p
        REF.inc.apply_incremental(m_r, inc_r)
        PORT.inc.apply_incremental(m_p, inc_p)
        PORT.inc.apply_incremental(m_rp, into_port)
        REF.inc.apply_incremental(m_pr, into_ref)
        assert state(m_r, False) == state(m_p, False) == \
            state(m_rp, False) == state(m_pr, False)
    assert state(m_r) == state(m_p) == state(m_rp) == state(m_pr)


def test_incremental_wire_errors_equal_reference():
    def run(W):
        dec, enc = W.wire.decode_incremental, W.wire.encode_incremental
        msgs = []
        blob = enc(W.inc.Incremental(epoch=3))
        for bad, exc in ((b"\x00" * 16, ValueError),
                         (blob[:4] + struct.pack("<I", 99) + blob[8:],
                          ValueError),
                         (blob + b"\x00", ValueError),
                         (blob[:-2], EOFError)):
            with pytest.raises(exc) as ei:
                dec(bad)
            msgs.append(str(ei.value))
        return msgs, W.wire.INC_MAGIC, blob

    msgs, magic, _ = both(run)
    assert "magic" in msgs[0] and "version" in msgs[1]
    assert "trailing" in msgs[2]


def test_incremental_wire_crush_payload():
    """A delta carrying a full crush map round-trips and applies like
    the direct delta; its blob is the reference's."""
    def run(W):
        C, I = W.crush, W.inc
        m1, m2 = make_map(W), make_map(W)
        b2 = C.CrushBuilder()
        r2 = b2.build_two_level(3, 3)
        b2.add_rule(0, [C.step_take(r2), C.step_chooseleaf_firstn(3, 1),
                        C.step_emit()])
        inc = I.Incremental(epoch=1, new_crush=b2.map, new_max_osd=9)
        blob = W.wire.encode_incremental(inc)
        I.apply_incremental(m1, inc)
        I.apply_incremental(m2, W.wire.decode_incremental(blob))
        assert state(m1) == state(m2)
        return blob, state(m1)

    both(run)


# -- MapChurn sequences (the orchestrator's replan discipline) ----------------

@pytest.mark.parametrize("seed", range(4))
def test_churn_sequence_incrementally_equals_rebuilt_final_map(seed):
    """A seeded MapChurn applied incrementally places like a map rebuilt
    at the net final state, and like a catch_up replay of the recorded
    deltas — and the port's sequence is the reference's."""
    def run(W):
        m_inc = make_map(W, pg_num=48)
        churn = W.chaos.MapChurn(seed=seed, max_down=2, p_fire=0.8,
                                 max_events=12)
        for i in range(30):
            churn.step(m_inc, stage=("plan", "dispatch", "writeback")[i % 3])
        assert W.inc.get_epoch(m_inc) == churn.epochs_advanced
        m_dir = make_map(W, pg_num=48)
        for osd in range(m_inc.max_osd):
            m_dir.osd_weight[osd] = m_inc.osd_weight[osd]
            m_dir.osd_up[osd] = m_inc.osd_up[osd]
            m_dir.osd_exists[osd] = m_inc.osd_exists[osd]
        got = state(m_inc)
        assert got["placements"] == state(m_dir)["placements"]
        up_i, pr_i = m_inc.pg_to_up_bulk(1, engine="host")
        up_d, pr_d = m_dir.pg_to_up_bulk(1, engine="host")
        assert np.array_equal(up_i, up_d) and np.array_equal(pr_i, pr_d)
        m_replay = make_map(W, pg_num=48)
        assert W.inc.catch_up(m_replay, churn.incrementals) == \
            W.inc.get_epoch(m_inc)
        assert state(m_replay)["placements"] == got["placements"]
        blobs = [W.wire.encode_incremental(i) for i in churn.incrementals]
        return churn.events, blobs, got

    events, _, _ = both(run)
    assert events


def test_churn_storm_on_the_bulk_evaluator():
    """A 120-event storm on a 64-host map: incremental, rebuilt and
    replayed maps agree on the port's bulk evaluator (``device="cpu"``)
    over every pg, and with the reference's placements."""
    def run(W):
        m = make_map(W, pg_num=128, hosts=64, devs=4)
        churn = W.chaos.MapChurn(seed=4, max_down=16, fire_every=1,
                                 max_events=120)
        for i in range(120):
            churn.step(m, stage=("plan", "dispatch", "writeback")[i % 3])
        assert W.inc.get_epoch(m) == 120
        replay = make_map(W, pg_num=128, hosts=64, devs=4)
        W.inc.catch_up(replay, churn.incrementals)
        up, pr = m.pg_to_up_bulk(1, engine="bulk")
        up2, pr2 = replay.pg_to_up_bulk(1, engine="host")
        assert np.array_equal(up, up2) and np.array_equal(pr, pr2)
        return up.tolist(), pr.tolist(), churn.events

    both(run)
