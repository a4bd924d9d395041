"""The port's cluster plane (``ceph_tpu_torch.cluster``) against the
reference's ``ceph_tpu.cluster``, on the CPU, tolerance 0.

- topology: the same CRUSH map (the binary wire form and the JSON
  decompile, so buckets, weights, classes, shadow trees and rules),
  the same pools and ``topology_summary``, the same validation errors,
  the same ``ClusterSpec.sized`` factorizations; without a card
  ``build_cluster`` raises ``NoDeviceError``;
- balance: ``BalanceReport.to_dict()``, the upmap items and the
  trajectory equal the reference's host loop, on the port's bulk
  evaluator (``device="cpu"``) and its host mapper;
- storms: ``StormReport.to_dict()`` equal, ``verify_storm_equivalence``
  holds on the port, a drained storm revives every OSD;
- rateless: ``plan_assignments``, the ``simulate_first_k`` schedules,
  ``shard_weights``, ``RatelessReport.to_dict()`` and the healed store
  bytes equal the reference's, on the host recovery and on the fused
  repair of CPU tensors.

The reference's bulk evaluator compiles for seconds a rule; its host
mapper (equal to it by the ladder invariant) stands in here.  Clusters
stay at 120 OSDs or fewer: the 10k-OSD run is the card's
(``chip_smoke.py`` phase 11).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def world(name: str) -> SimpleNamespace:
    mods = {"cluster": "cluster", "topology": "cluster.topology",
            "rateless": "cluster.rateless", "chaos": "chaos",
            "binary": "crush.binary", "compiler": "crush.compiler",
            "registry": "codes.registry", "stripe": "codes.stripe",
            "recovery": "recovery", "throttle": "recovery.throttle",
            "runner": "scenario.runner", "plane": "parallel.plane"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def small_spec(W, **kw):
    base = dict(seed=7, racks=5, hosts_per_rack=2, osds_per_host=2,
                replicated_pg_num=128, ec_pg_num=32, ec_k=4, ec_m=2)
    base.update(kw)
    return W.cluster.ClusterSpec(**base)


def build(W, spec):
    if W is PORT:
        return W.cluster.build_cluster(spec, device="cpu")
    return W.cluster.build_cluster(spec)


def plain(x):
    """A JSON-comparable form: dataclasses flattened, tuples to lists,
    dict keys to strings."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def same(a, b) -> None:
    assert json.dumps(plain(a), sort_keys=True) == \
        json.dumps(plain(b), sort_keys=True)


# -- topology ---------------------------------------------------------------

SPECS = {
    "small": {},
    "small_seed8": {"seed": 8},
    "classless": {"device_classes": ()},
    "tiers12": {"weight_tiers": (1.0, 2.0), "replicated_pg_num": 192},
    # one rack of one host: the EC class dies out, the rule falls back
    # to the whole tree
    "narrow": {"racks": 3, "hosts_per_rack": 2, "ec_k": 2, "ec_m": 1,
               "seed": 3},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_topology_equals_reference(name):
    rs, ps = small_spec(REF, **SPECS[name]), small_spec(PORT, **SPECS[name])
    assert dataclasses.asdict(rs) == dataclasses.asdict(ps)
    rm, pm = build(REF, rs), build(PORT, ps)
    assert PORT.binary.encode_map(pm.crush) == \
        REF.binary.encode_map(rm.crush)
    assert PORT.compiler.decompile(pm.crush) == \
        REF.compiler.decompile(rm.crush)
    same({pid: dataclasses.asdict(p) for pid, p in pm.pools.items()},
         {pid: dataclasses.asdict(p) for pid, p in rm.pools.items()})
    same(PORT.topology.topology_summary(ps, pm),
         REF.topology.topology_summary(rs, rm))
    assert pm.device is not None and str(pm.device) == "cpu"
    assert (PORT.topology.EC_POOL, PORT.topology.REPLICATED_POOL) == \
        (REF.topology.EC_POOL, REF.topology.REPLICATED_POOL)


@pytest.mark.parametrize("n", [20, 50, 120, 1000, 10_000])
def test_sized_equals_reference(n):
    assert dataclasses.asdict(PORT.cluster.ClusterSpec.sized(n, seed=1)) \
        == dataclasses.asdict(REF.cluster.ClusterSpec.sized(n, seed=1))


@pytest.mark.parametrize("kw", [
    {"racks": 2, "replicated_size": 3},
    {"racks": 3, "hosts_per_rack": 1, "ec_k": 4, "ec_m": 2},
])
def test_validation_errors_equal_reference(kw):
    with pytest.raises(ValueError) as r:
        build(REF, small_spec(REF, **kw))
    with pytest.raises(ValueError) as p:
        build(PORT, small_spec(PORT, **kw))
    assert str(p.value) == str(r.value)


def test_build_cluster_needs_a_card_by_default(monkeypatch):
    from ceph_tpu_torch.utils.errors import NoDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        PORT.cluster.build_cluster(small_spec(PORT))
    with pytest.raises(NoDeviceError):
        PORT.topology.topology_summary(small_spec(PORT))


# -- balance ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["bulk", "host"])
@pytest.mark.parametrize("spec_kw", [
    {"replicated_pg_num": 192},
    {"replicated_pg_num": 192, "weight_tiers": (1.0, 2.0)},
])
def test_balance_equals_reference(engine, spec_kw):
    rm = build(REF, small_spec(REF, **spec_kw))
    pm = build(PORT, small_spec(PORT, **spec_kw))
    r = REF.cluster.balance_cluster(rm, engine="host")
    p = PORT.cluster.balance_cluster(pm, engine=engine)
    want = r.to_dict()
    want["engine"] = engine
    assert p.to_dict() == want
    assert p.changes == r.changes
    assert p.trajectory == r.trajectory
    assert pm.pg_upmap_items == rm.pg_upmap_items


# -- storms -----------------------------------------------------------------

@pytest.mark.parametrize("engine,measure_every", [
    ("bulk", 1), ("host", 1), ("bulk", 3)])
def test_storm_equals_reference(engine, measure_every):
    spec_kw = {"replicated_pg_num": 48, "ec_pg_num": 16}
    rm = build(REF, small_spec(REF, **spec_kw))
    pm = build(PORT, small_spec(PORT, **spec_kw))
    rc = REF.chaos.MapChurn(seed=9, max_down=4, fire_every=1,
                            max_events=6)
    pc = PORT.chaos.MapChurn(seed=9, max_down=4, fire_every=1,
                             max_events=6)
    r = REF.cluster.run_churn_storm(rm, churn=rc, events=6,
                                    engine="host",
                                    measure_every=measure_every)
    p = PORT.cluster.run_churn_storm(pm, churn=pc, events=6,
                                     engine=engine,
                                     measure_every=measure_every)
    want = r.to_dict()
    want["engine"] = engine
    assert p.to_dict() == want
    same(pc.events, rc.events)
    assert not pc.downed and all(pm.is_up(o) for o in range(pm.max_osd))
    PORT.cluster.verify_storm_equivalence(
        pm, pc, lambda: build(PORT, small_spec(PORT, **spec_kw)),
        engine=engine, scalar_samples=4)


def test_storm_equivalence_gate_catches_divergence():
    """The gate raises when the advanced map differs from its replay."""
    from ceph_tpu_torch.crush.incremental import CEPH_OSD_UP, Incremental
    spec = small_spec(PORT)
    m = build(PORT, spec)
    churn = PORT.chaos.MapChurn(seed=9, max_down=4, fire_every=1,
                                max_events=4)
    PORT.cluster.run_churn_storm(m, churn=churn, events=4, engine="bulk")
    # an edit the recorded deltas do not carry
    m.osd_weight[3] = 0
    churn.incrementals.append(Incremental(epoch=m.epoch + 1,
                                          new_state={5: CEPH_OSD_UP}))
    with pytest.raises(AssertionError):
        PORT.cluster.verify_storm_equivalence(
            m, churn, lambda: build(PORT, spec), engine="bulk")


# -- rateless ---------------------------------------------------------------

@pytest.mark.parametrize("n_units,n_shards,r,seed", [
    (40, 8, 3, 2), (40, 8, 3, 3), (8, 4, 9, 0), (12, 8, 2, 7),
    (5, 1, 2, 1)])
def test_plan_assignments_equal_reference(n_units, n_shards, r, seed):
    assert PORT.cluster.plan_assignments(n_units, n_shards, r, seed) == \
        REF.cluster.plan_assignments(n_units, n_shards, r, seed)


@pytest.mark.parametrize("r,slow", [(2, {0: 10.0}), (1, {0: 10.0}),
                                    (2, {}), (3, {0: 10.0, 5: 3.0})])
def test_first_k_schedule_and_weights_equal_reference(r, slow):
    work = [1.0 + (i % 5) * 0.25 for i in range(64)]
    sched = {}
    for W in (REF, PORT):
        plan = W.cluster.plan_assignments(64, 8, r, seed=4)
        s = W.cluster.simulate_first_k(
            plan, W.chaos.Straggler(seed=4, slow=slow), work)
        sched[W.name] = (s, W.cluster.shard_weights(s))
    (rs, rw), (ps, pw) = sched["ceph_tpu"], sched["ceph_tpu_torch"]
    same(ps, rs)
    assert ps.wasted_fraction == rs.wasted_fraction
    assert pw == rw


def _damaged(W, ec, sinfo, n_objects, erasures=1):
    return W.runner.stage_damaged_objects(
        sinfo, ec, n_objects, seed=0,
        injectors_for=lambda i: [W.chaos.ShardErasure(
            shards=list(range(1, 1 + erasures)))])


def _rs42(W, device):
    kw = {"device": device} if W is PORT else {}
    return W.registry.ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
        **kw)


@pytest.mark.parametrize("device,erasures,n_objects", [
    (False, 1, 6), (None, 1, 6), (False, 3, 3), (None, 2, 4)])
def test_rateless_recover_equals_reference(device, erasures, n_objects):
    """The recovery of one pg's damaged objects under a 10x straggler:
    the same report and the same healed bytes; ``device=None`` runs the
    fused repair on CPU tensors against the reference's on its CPU
    backend."""
    out = {}
    for W in (REF, PORT):
        ec = _rs42(W, "cpu")
        chunk = ec.get_chunk_size(4096)
        sinfo = W.stripe.StripeInfo(4, 4 * chunk)
        objects, stores, hinfos, _ = _damaged(W, ec, sinfo, n_objects,
                                              erasures)
        m = build(W, small_spec(W))
        throttle = W.throttle.OsdRecoveryThrottle()
        prev = W.plane.set_data_plane(None)
        try:
            rec, rr = W.cluster.rateless_recover(
                sinfo, ec, m, W.topology.EC_POOL, 5, stores, hinfos,
                redundancy=2,
                straggler=W.chaos.Straggler(seed=1, slow={0: 10.0}),
                throttle=throttle, seed=7, device=device)
        finally:
            W.plane.set_data_plane(prev)
        out[W.name] = (rec, rr, stores, objects, throttle)
    rrec, rrr, rst, robj, rth = out["ceph_tpu"]
    prec, prr, pst, pobj, pth = out["ceph_tpu_torch"]
    assert prr.to_dict() == rrr.to_dict()
    assert prec.to_dict() == rrec.to_dict()
    same(prr.schedule, rrr.schedule)
    assert prr.n_shards == 8             # no plane: the default 8
    assert [pth.limit_for(o) for o in range(20)] == \
        [rth.limit_for(o) for o in range(20)]
    for a, b in zip(pst, rst):
        assert a.snapshot() == b.snapshot()
    if erasures <= 2:
        assert prec.converged and PORT.recovery.healed(pst, pobj)
    else:
        assert prec.unrecoverable == list(range(n_objects))


def test_rateless_dispatch_call_is_the_fused_repair():
    from ceph_tpu_torch.codes.engine import fused_repair_call
    ec = _rs42(PORT, "cpu")
    available, erased = (0, 1, 3, 4, 5), (2,)
    fn = PORT.cluster.rateless_dispatch_call(ec, list(available),
                                             list(erased))
    assert fn is fused_repair_call(ec, available, erased)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 5, 1024), dtype=np.uint8))
    ref_ec = _rs42(REF, None)
    ref = REF.rateless.rateless_dispatch_call(ref_ec, available, erased)
    got = fn(x)
    want = ref(x.numpy())
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_exports_equal_reference():
    assert PORT.cluster.__all__ == REF.cluster.__all__
    assert PORT.rateless.__all__ == REF.rateless.__all__
    assert PORT.rateless.WEIGHT_NOISE_FLOOR == \
        REF.rateless.WEIGHT_NOISE_FLOOR
