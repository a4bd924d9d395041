"""The OSDMap pipeline, the balancer and EC pool creation of the port
(``ceph_tpu_torch.crush.{osdmap,balancer,poolops}``,
``ceph_tpu_torch.utils.config.ErasureCodeProfileStore``) against the
reference's: ``pg_to_up_acting_bulk`` on the port's bulk evaluator
(``device="cpu"``) against the reference's host engine (the same arrays
its bulk path is pinned to) and the scalar pipeline, ``calc_pg_upmaps``,
``create_erasure_pool`` and the ``create_rule`` output of jerasure,
isa, shec, clay and lrc (with ``crush-locality``).  Exact comparisons.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.crush.balancer import calc_pg_upmaps as ref_upmaps
from ceph_tpu.crush.osdmap import OSDMap as RefOSDMap, PGPool as RefPool
from ceph_tpu.crush.poolops import create_erasure_pool as ref_create
from ceph_tpu.utils.config import ErasureCodeProfileStore as RefStore
from ceph_tpu_torch.crush.balancer import calc_pg_upmaps
from ceph_tpu_torch.crush.osdmap import OSDMap, PGPool
from ceph_tpu_torch.crush.poolops import create_erasure_pool
from ceph_tpu_torch.utils.config import ErasureCodeProfileStore
from ceph_tpu_torch.utils.errors import NoDeviceError

from test_torch_crush import PORT, REF

NONE = 0x7FFFFFFF


def cluster(P, racks=3, hosts=4, devs=2):
    """root "default" -> rack -> host -> osd, straw2, named buckets."""
    b = P.builder.CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")
    rk, d = [], 0
    for r in range(racks):
        hs = []
        for h in range(hosts):
            hs.append(b.add_bucket("straw2", "host", [d + i
                                                      for i in range(devs)],
                                   name=f"r{r}h{h}"))
            d += devs
        rk.append(b.add_bucket("straw2", "rack", hs, name=f"rack{r}"))
    root = b.add_bucket("straw2", "root", rk, name="default")
    T = P.types
    b.add_rule(0, [T.step_take(root), T.step_chooseleaf_firstn(0, 1),
                   T.step_emit()], name="replicated")
    b.add_rule(1, [T.step_set_chooseleaf_tries(5),
                   T.step_set_choose_tries(100), T.step_take(root),
                   T.step_chooseleaf_indep(0, 1), T.step_emit()],
               name="ec")
    return b


def osdmaps(device="cpu"):
    """The same OSDMap in both packages: a replicated and an EC pool,
    down / out / reweighted osds, primary affinity, every override
    layer."""
    out = []
    for P, M, Pool in ((PORT, OSDMap, PGPool), (REF, RefOSDMap, RefPool)):
        m = M(crush=cluster(P).map)
        if M is OSDMap:
            m.device = device
        m.pools[1] = Pool(pool_id=1, pg_num=200, size=3, crush_rule=0)
        m.pools[2] = Pool(pool_id=2, pg_num=128, size=6, min_size=5,
                          crush_rule=1, erasure=True)
        m.mark_down(3)
        m.mark_out(7)
        m.osd_weight[11] = 0x8000
        for osd, aff in ((0, 0), (5, 0x4000), (12, 0x8000)):
            m.set_primary_affinity(osd, aff)
        m.pg_upmap[(1, 4)] = [1, 9, 17]
        m.pg_upmap_items[(1, 6)] = [(3, 21), (0, 2)]
        m.pg_upmap_items[(2, 9)] = [(5, 22)]
        m.pg_temp[(1, 8)] = [4, 5, 6, 7]
        m.pg_temp[(2, 3)] = [NONE, 1, 2, 3, 4, 5]
        m.primary_temp[(1, 10)] = 14
        out.append(m)
    return out


@pytest.mark.parametrize("pool_id", [1, 2])
def test_pg_to_up_acting_bulk_equals_reference(pool_id):
    port, ref = osdmaps()
    got = port.pg_to_up_acting_bulk(pool_id, engine="bulk")
    want = ref.pg_to_up_acting_bulk(pool_id, engine="host")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        port.pg_counts_per_osd(pool_id), ref.pg_counts_per_osd(
            pool_id, engine="host"))
    raw, pps = port.pg_to_raw_bulk(pool_id)
    np.testing.assert_array_equal(pps, ref.pools[pool_id].pps_all())
    # the bulk arrays row for row against the port's scalar pipeline
    up, upp, act, actp = got
    for ps in range(0, port.pools[pool_id].pg_num, 7):
        u, p, a, ap = port.pg_to_up_acting_osds(pool_id, ps)
        assert list(up[ps][:len(u)]) == u and int(upp[ps]) == p
        assert list(act[ps][:len(a)]) == a and int(actp[ps]) == ap
        assert (u, p, a, ap) == ref.pg_to_up_acting_osds(pool_id, ps)


def test_calc_pg_upmaps_equals_reference():
    port, ref = osdmaps()
    got = calc_pg_upmaps(port, None, max_deviation=1.0, max_iterations=40)
    want = ref_upmaps(ref, None, max_deviation=1.0, max_iterations=40,
                      engine="host")
    assert got == want and got
    assert port.pg_upmap_items == ref.pg_upmap_items
    for pid in (1, 2):
        np.testing.assert_array_equal(
            port.pg_to_up_bulk(pid)[0], ref.pg_to_up_bulk(pid,
                                                          engine="host")[0])


def test_sharded_engine_names_its_queue_item(monkeypatch):
    """engine="sharded" (the data plane's x sweep over every visible
    member) is mapping for mapping engine="bulk": over 3 virtual CPU
    members, and at width 1 (no virtual members)."""
    port, _ = osdmaps()
    raw, pps = port.pg_to_raw_bulk(1, engine="bulk")
    for n in ("3", ""):
        monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", n)
        got, gpps = port.pg_to_raw_bulk(1, engine="sharded")
        np.testing.assert_array_equal(got, raw)
        np.testing.assert_array_equal(gpps, pps)


def test_bulk_path_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = osdmaps(device=None)
    with pytest.raises(NoDeviceError):
        port.pg_to_up_bulk(1)
    up, _ = port.pg_to_up_bulk(1, engine="host")    # the host engine runs
    assert up.shape == (200, 3)


PROFILES = {
    "jerasure": {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "4", "m": "2"},
    "isa": {"plugin": "isa", "technique": "reed_sol_van", "k": "4",
            "m": "2"},
    "shec": {"plugin": "shec", "k": "6", "m": "3", "c": "2"},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
            "crush-locality": "rack"},
    "lrc_steps": {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
                  "crush-steps": '[["choose", "rack", 2], '
                                 '["chooseleaf", "host", 4]]'},
    "jerasure_m1_osd": {"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "4", "m": "1", "crush-failure-domain": "osd"},
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_create_erasure_pool_and_rule_equal_reference(name):
    profile = dict({"crush-failure-domain": "host",
                    "crush-root": "default"}, **PROFILES[name])
    port_m = OSDMap(crush=cluster(PORT).map, device="cpu")
    ref_m = RefOSDMap(crush=cluster(REF).map)
    port_s = ErasureCodeProfileStore(device="cpu")
    ref_s = RefStore()
    port_s.set("p", profile)
    ref_s.set("p", profile)
    got = create_erasure_pool(port_m, port_s, "p", pool_id=5, pg_num=64)
    want = ref_create(ref_m, ref_s, "p", pool_id=5, pg_num=64)
    for f in ("pool_id", "pg_num", "pgp_num", "size", "min_size",
              "crush_rule", "erasure", "hashpspool"):
        assert getattr(got, f) == getattr(want, f), f
    gr, wr = port_m.crush.rules[got.crush_rule], \
        ref_m.crush.rules[want.crush_rule]
    assert (gr.steps, gr.type, gr.name, gr.rule_id) == \
        (wr.steps, wr.type, wr.name, wr.rule_id)
    # create_rule on a fresh builder, and rule reuse by name
    pb, rb = cluster(PORT), cluster(REF)
    assert port_s.instantiate("p").create_rule(pb, name="x") == \
        ref_s.instantiate("p").create_rule(rb, name="x")
    assert [(r.steps, r.type, r.name) for r in pb.map.rules.values()] == \
        [(r.steps, r.type, r.name) for r in rb.map.rules.values()]
    again = create_erasure_pool(port_m, port_s, "p", pool_id=6, pg_num=8)
    assert again.crush_rule == got.crush_rule
    # placements of the new pool against the reference's host engine;
    # lrc's locality rule chains a choose of n > 1, outside the bulk
    # evaluator's envelope (it raises; the host engine runs it)
    engine = "bulk"
    if name.startswith("lrc"):
        engine = "host"
        with pytest.raises(ValueError, match="chained"):
            port_m.pg_to_up_bulk(5)
    np.testing.assert_array_equal(
        port_m.pg_to_up_bulk(5, engine=engine)[0],
        ref_m.pg_to_up_bulk(5, engine="host")[0])


def test_profile_errors_equal_reference():
    for profile in ({"plugin": "jerasure", "k": "4", "m": "2",
                     "crush-failure-domain": "zone"},
                    {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
                     "crush-steps": '[["spread", "host", 1]]'}):
        msgs = []
        for M, Store, create, P in (
                (OSDMap, ErasureCodeProfileStore, create_erasure_pool, PORT),
                (RefOSDMap, RefStore, ref_create, REF)):
            m = M(crush=cluster(P).map)
            store = Store(device="cpu") if Store is \
                ErasureCodeProfileStore else Store()
            with pytest.raises(ValueError) as e:
                store.set("bad", profile)
                create(m, store, "bad", pool_id=1, pg_num=8)
            msgs.append(str(e.value))
            assert not m.pools
        assert msgs[0] == msgs[1]


def test_profile_store_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        ErasureCodeProfileStore().set("p", PROFILES["jerasure"])
    store = ErasureCodeProfileStore(device="cpu")
    store.set("p", PROFILES["jerasure"])
    assert store.ls() == ["default", "p"]
    assert store.instantiate("p").device.type == "cpu"
