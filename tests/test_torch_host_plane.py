"""Host fault domains on the port's data plane (``ceph_tpu_torch.parallel``
with the supervisor's host and member quarantine) against the
reference's (``tests/test_host_plane.py``) on the CPU.

Each scenario runs through both packages on a plane of 8 members — the
reference's 8 forced CPU devices (tests/conftest.py), the port's 8
virtual CPU members (``CEPH_TPU_TORCH_VIRTUAL_DEVICES=8``) — with the
same seeded ``HostFaultPlan`` / ``DispatchFaultPlan``: the bytes, the
supervisor's ``stats()`` (key for key, the port's ``card_failures``
aside), the plan's ``summary()``, the flight recorder's triggers and the
plane's topology must be equal.  The reference's "xla" tier is the
port's "torch".

Held elsewhere: the scenario runner's host-loss section in
tests/test_torch_scenario.py, bench_diff's ``host_chaos`` category and
the host-chaos demo in tests/test_torch_tools.py and
tests/test_torch_demos.py, the audit-registry entries
(``engine.fused_repair_host_sharded``, ``chaos.host_plane``) in
tests/test_torch_entrypoints.py.  The port's own: the member and host
quarantine on the card (CPU tensors marked as the card's), where a
reshrink keeps the work on the plane and a width-1 loss raises
DeviceDispatchError.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_supervisor import (PORT, REF, _dev, _mk_ec, both, host,
                                   isolated, same_bytes, triggers)

HOSTS = {W.name: importlib.import_module(f"{W.name}.chaos.hosts")
         for W in (PORT, REF)}


@pytest.fixture(autouse=True)
def eight_members(monkeypatch):
    """The port's counterpart of the reference's 8 forced CPU devices."""
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "8")


def H(W):
    return HOSTS[W.name]


def topo(W):
    p = W.plane.data_plane()
    return None if p is None else {"hosts": p.hosts, "n": p.n_devices}


def _xor_body(k):
    def body(x):
        return x ^ np.uint8(k)
    return body


# -- the acceptance arc: HostLoss mid-stream on the multi-host plane ----------

def test_host_loss_reshrinks_host_granular_and_repromotes():
    """A persistent HostLoss at a warm seam: ONE host-granular reshrink
    (2x4 -> 1x4), the reclaim hook fired once, every completion equal,
    held down until the adversary releases, then re-promotion restores
    the 2-host plane."""
    data = np.arange(128, dtype=np.uint8).reshape(8, 16)
    body = _xor_body(0x3C)

    def run(W):
        with isolated(W) as sup:
            p0 = W.plane.activate(None, hosts=2)
            assert p0 is not None and p0.hosts == 2 and p0.n_devices == 8
            reclaims = []
            sup.set_inflight_reclaim(lambda s: reclaims.append(s) or 1)
            outs, held = [], []
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostLoss(1, seam="stream.batch", at=2,
                                   calls=None)], seed=3)) as plan:
                for _ in range(4):
                    outs.append(np.asarray(sup.dispatch(
                        "stream.batch", body, (data,), host_fn=body,
                        rebuild=lambda: body)))
                mid = dict(sup.stats(), topology=topo(W))
                for _ in range(sup.promote_after + 2):
                    held.append(sup.tick())
                plan.clear()
                for _ in range(sup.promote_after + 2):
                    held.append(sup.tick())
                summary = plan.summary()
            return {"outs": outs, "mid": mid, "held": held,
                    "reclaims": reclaims, "summary": summary,
                    "stats": sup.stats(), "topology": topo(W),
                    "triggers": triggers(W)}
    got = both(run)
    assert all(same_bytes(o, body(data)) for o in got["outs"])
    assert got["mid"]["host_quarantines"] == 1
    assert got["mid"]["quarantines"] == 0
    assert got["mid"]["journal_redispatches"] == 1
    assert got["mid"]["topology"] == {"hosts": 1, "n": 4}
    assert got["reclaims"] == ["stream.batch"]
    assert got["stats"]["host_repromotions"] == 1
    assert got["topology"] == {"hosts": 2, "n": 8}
    assert "host_quarantined" in got["triggers"]
    assert "repromoted" in got["triggers"]


def test_host_loss_reshrinks_4_2_1_and_repromotes():
    """Two hosts lost on a 4-host plane (4 x 2 members): the hosts halve
    twice, 4 -> 2 -> 1, each step host-granular (the survivors keep
    their members), then re-promotion restores all 4 hosts."""
    data = np.arange(64, dtype=np.uint8).reshape(4, 16)
    body = _xor_body(0x19)

    def run(W):
        with isolated(W) as sup:
            p0 = W.plane.activate(None, hosts=4)
            assert p0.hosts == 4 and p0.devices_per_host == 2
            widths = []
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostLoss(3, seam="wide.batch", at=1, calls=None),
                     H(W).HostLoss(1, seam="wide.batch", at=1,
                                   calls=None)], seed=41)) as plan:
                for _ in range(3):
                    out = np.asarray(sup.dispatch(
                        "wide.batch", body, (data,), host_fn=body,
                        rebuild=lambda: body))
                    assert same_bytes(out, body(data))
                    widths.append(topo(W))
                mid = sup.stats()
                plan.clear()
                for _ in range(sup.promote_after + 2):
                    sup.tick()
                summary = plan.summary()
            return {"widths": widths, "mid": mid, "summary": summary,
                    "stats": sup.stats(), "topology": topo(W),
                    "triggers": triggers(W)}
    got = both(run)
    assert got["widths"][-1] == {"hosts": 1, "n": 2}
    assert got["mid"]["host_quarantines"] == 2
    assert got["mid"]["quarantines"] == 0
    assert got["stats"]["host_repromotions"] == 1
    assert got["topology"] == {"hosts": 4, "n": 8}


def test_journal_reclaim_returns_redo_and_fences():
    """The in-flight reclaim the host quarantine's hook replays: a
    completed write is kept, a torn one rolled back and returned for
    re-dispatch, one begun after the loss fenced out — in both
    packages alike."""
    def run(W):
        journal = importlib.import_module(f"{W.name}.recovery.journal")
        store_mod = importlib.import_module(f"{W.name}.chaos.store")
        j = journal.IntentJournal()
        store = store_mod.ShardStore({0: b"x" * 64})
        full, torn = b"a" * 64, b"b" * 64
        j.begin(0, 0, epoch=5, payloads={1: full}, targets={1: 1})
        store.write(1, full)
        j.begin(1, 0, epoch=5, payloads={2: torn}, targets={2: 2})
        store.write(2, torn[:10])
        j.begin(2, 0, epoch=7, payloads={3: full}, targets={3: 3})
        stats, redo = j.reclaim([store], fence_epoch=7)
        return {"replayed": stats.replayed, "completed": stats.completed,
                "rolled_back": stats.rolled_back,
                "redo": [(r.op_id, r.payloads) for r in redo],
                "digest": journal.payload_digest(torn),
                "shards": sorted(store.shards),
                "pending": [r.op_id for r in j.pending()]}
    got = both(run)
    assert got["replayed"] == 2 and got["completed"] == 1
    assert got["redo"] == [(1, {2: got["digest"]})]
    assert 2 not in got["shards"] and got["pending"] == [2]


def _stores(W, n_obj=4):
    from importlib import import_module
    stripe = import_module(f"{W.name}.codes.stripe")
    chaos = import_module(f"{W.name}.chaos")
    ec = _mk_ec(W)
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    sinfo = stripe.StripeInfo(k, k * 512)
    rng = np.random.default_rng(17)
    originals, stores, hinfos = [], [], []
    for i in range(n_obj):
        obj = rng.integers(0, 256, k * 512, np.uint8).tobytes()
        shards = stripe.encode(sinfo, ec, obj)
        hinfo = stripe.HashInfo(n)
        hinfo.append(0, shards)
        store, _ = chaos.inject(shards, [chaos.ShardErasure(
            shards=[i % 2])], seed=200 + i, chunk_size=sinfo.chunk_size)
        originals.append(shards)
        stores.append(store)
        hinfos.append(hinfo)
    return ec, sinfo, originals, stores, hinfos


def test_repair_batched_survives_midstream_host_loss():
    """HostLoss mid-``repair_batched``: the second fused pattern batch
    lands on the dead host; zero data loss, the heal byte for byte, a
    host-granular reshrink, re-promotion."""
    def run(W):
        with isolated(W) as sup:
            W.plane.activate(None, hosts=2)
            ec, sinfo, originals, stores, hinfos = _stores(W)
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostLoss(1, seam="engine.fused_repair", at=2,
                                   calls=None)], seed=19)) as plan:
                rep = W.scrub.repair_batched(sinfo, ec, stores, hinfos,
                                             device=True)
                plan.clear()
            healed = W.orch.healed(stores, originals)
            mid = sup.stats()
            for _ in range(sup.promote_after + 2):
                sup.tick()
            return {"batches": rep.pattern_batches, "healed": healed,
                    "snap": [s.snapshot() for s in stores], "mid": mid,
                    "stats": sup.stats(), "topology": topo(W),
                    "triggers": triggers(W)}
    got = both(run)
    assert got["batches"] == 2 and got["healed"]
    assert got["mid"]["host_quarantines"] >= 1
    assert got["stats"]["host_repromotions"] >= 1
    assert not got["stats"]["demoted"]
    assert "host_quarantined" in got["triggers"]


def test_serving_stream_survives_midstream_host_loss():
    """HostLoss mid-serving-stream: every response equal to the
    unfailed control while the plane reshrinks under it."""
    def run(W):
        with isolated(W) as sup:
            W.plane.activate(None, hosts=2)
            ec = _mk_ec(W)
            rng = np.random.default_rng(8)
            data = rng.integers(0, 256, (4, 4, 1024), np.uint8)

            def call():
                return host(W.engine.serve_dispatch_call(ec, "encode")(
                    _dev(W, data)))
            control = call()
            outs = []
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostLoss(1, seam="engine.serve-encode", at=3,
                                   calls=None)], seed=23)) as plan:
                for _ in range(6):
                    outs.append(call())
                mid = sup.stats()
                plan.clear()
                for _ in range(sup.promote_after + 2):
                    sup.tick()
            outs.append(call())
            return {"control": control, "outs": outs, "mid": mid,
                    "stats": sup.stats(), "topology": topo(W)}
    got = both(run)
    assert all(same_bytes(o, got["control"]) for o in got["outs"])
    assert got["mid"]["host_quarantines"] >= 1
    assert got["stats"]["host_repromotions"] >= 1
    assert got["topology"] == {"hosts": 2, "n": 8}


def test_width1_host_loss_completes_on_floor():
    """The reshrink floor: a host loss with NO plane (the process is its
    one fault domain) demotes to the numpy twin on CPU tensors, and the
    dispatch still completes byte for byte."""
    data = np.arange(64, dtype=np.uint8)
    body = _xor_body(0x81)

    def run(W):
        with isolated(W) as sup:
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostLoss(0, seam="floor.batch", at=1,
                                   calls=1)], seed=29)):
                out = np.asarray(sup.dispatch(
                    "floor.batch", body, (data,), host_fn=body,
                    rebuild=lambda: body))
            mid = sup.stats()
            for _ in range(sup.promote_after + 2):
                sup.tick()
            return {"out": out, "mid": mid, "stats": sup.stats()}
    got = both(run)
    assert same_bytes(got["out"], body(data))
    assert got["mid"]["host_quarantines"] == 0
    assert got["mid"]["demotions"] >= 1
    assert got["mid"]["host_completions"] >= 1
    assert not got["stats"]["demoted"]


def test_host_partition_quarantines_and_fences():
    """A partitioned host: the same reshrink arc, fenced while the
    partition stands, re-admitted after."""
    data = np.arange(32, dtype=np.uint8)
    body = _xor_body(0x07)

    def run(W):
        with isolated(W) as sup:
            W.plane.activate(None, hosts=2)
            plan = H(W).HostFaultPlan(
                [H(W).HostPartition(1, seam="part.batch", at=1,
                                    calls=None)], seed=31)
            kind = plan.active("part.batch", hosts=2).kind
            with H(W).host_faults(plan):
                out = np.asarray(sup.dispatch(
                    "part.batch", body, (data,), host_fn=body,
                    rebuild=lambda: body))
                mid = sup.stats()
                for _ in range(sup.promote_after + 2):
                    sup.tick()
                held = sup.stats()["host_repromotions"]
                plan.clear()
                for _ in range(sup.promote_after + 2):
                    sup.tick()
            return {"kind": kind, "out": out, "mid": mid, "held": held,
                    "stats": sup.stats(), "triggers": triggers(W)}
    got = both(run)
    assert got["kind"] == "host_partition"
    assert same_bytes(got["out"], body(data))
    assert got["mid"]["host_quarantines"] == 1 and got["held"] == 0
    assert got["stats"]["host_repromotions"] == 1


def test_member_quarantine_halves_and_repromotes():
    """A persistent dispatch fault on a 4-member plane without hosts:
    quarantines 4 -> 2 -> single-device, then the tier ladder; every
    output equal, and re-promotion restores the 4 members."""
    from test_torch_supervisor import _fused_seam

    def run(W):
        with isolated(W) as sup:
            assert W.plane.activate(4) is not None
            call = _fused_seam(W, B=8)
            control = call()
            with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                    "backend_loss", seam="engine.fused_repair", at=1,
                    calls=None)], seed=7) as plan:
                out = call()
                plan.clear()
            mid = dict(sup.stats(), topology=topo(W))
            for _ in range(sup.promote_after + 1):
                sup.tick()
            return {"equal": same_bytes(out, control), "mid": mid,
                    "stats": sup.stats(), "topology": topo(W),
                    "after": same_bytes(call(), control),
                    "triggers": triggers(W)}
    got = both(run)
    assert got["equal"] and got["after"]
    assert got["mid"]["quarantines"] == 2
    assert got["mid"]["demotions"] >= 1
    assert got["mid"]["topology"] is None
    assert got["topology"] == {"hosts": 1, "n": 4}
    assert not got["stats"]["demoted"]
    assert "device_quarantined" in got["triggers"]


def test_a_plane_narrows_only_for_its_own_kind():
    """A plane of the card's members is no help to a host row: a
    persistent loss on a row dispatch leaves the card plane whole and
    demotes the tier, where a plane of the CPU's members quarantines."""
    import torch
    from ceph_tpu_torch.parallel.mesh import make_mesh
    data = np.arange(64, dtype=np.uint8).reshape(4, 16)
    body = _xor_body(0x5A)
    for kind, quarantined in (("cuda", False), ("cpu", True)):
        with isolated(PORT) as sup:
            plane = PORT.plane.DataPlane(make_mesh(
                tp=1, devices=[torch.device(kind, 0)] * 4))
            PORT.plane.set_data_plane(plane)
            with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                    "backend_loss", seam="rows.batch", at=1, calls=None)],
                    seed=5):
                got = sup.dispatch("rows.batch", body, (data,),
                                   host_fn=body, rebuild=lambda: body)
            assert same_bytes(got, body(data))
            st = sup.stats()
            assert (st["quarantines"] == 2) is quarantined, kind
            assert st["demotions"] >= 1 and st["card_failures"] == 0
            assert (PORT.plane.data_plane() is plane) is not quarantined


@pytest.mark.parametrize("hosts", [1, 2])
def test_quarantine_on_the_card_keeps_the_work_on_the_plane(
        monkeypatch, hosts):
    """The card rule with a plane: a persistent failure reshrinks the
    plane (a host loss by hosts first, then members) and the reshrunk
    dispatch completes on the plane — no demotion, no host twin; only
    at width 1 does the loss raise DeviceDispatchError.  CPU tensors
    stand in for the card's here."""
    from ceph_tpu_torch.utils.errors import DeviceDispatchError
    from test_torch_supervisor import _fused_seam
    monkeypatch.setattr(PORT.sup, "_on_card", lambda args: True)
    with isolated(PORT) as sup:
        PORT.plane.activate(4, hosts=hosts)
        call = _fused_seam(PORT, B=8)
        control = call()
        # a finite loss: two calls down, healed by the first reshrinks
        with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                "backend_loss", seam="engine.fused_repair", at=1,
                calls=2)], seed=5):
            assert same_bytes(call(), control)
        st = sup.stats()
        assert st["quarantines"] == 2 and st["demotions"] == 0
        assert st["host_completions"] == 0 and st["card_failures"] == 0
        for _ in range(sup.promote_after + 1):
            sup.tick()
        assert topo(PORT) == {"hosts": hosts, "n": 4}
        # a persistent loss: 4 -> 2 -> 1, then the card rule raises
        with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                "backend_loss", seam="engine.fused_repair", at=1,
                calls=None)], seed=5):
            with pytest.raises(DeviceDispatchError):
                call()
        st = sup.stats()
        assert st["quarantines"] == 4 and st["card_failures"] == 1
        assert st["demotions"] == 0 and topo(PORT) is None


def test_host_flap_torture():
    """A flapping host (down 2 / up 2, three cycles) across a 24-call
    stream: every completion equal, several quarantine and re-promotion
    round trips, a clean exit at full width."""
    data = np.arange(256, dtype=np.uint8).reshape(16, 16)
    body = _xor_body(0x42)

    def run(W):
        with isolated(W) as sup:
            W.plane.activate(None, hosts=2)
            outs = []
            with H(W).host_faults(H(W).HostFaultPlan(
                    [H(W).HostFlap(1, seam="flap.batch", at=2, calls=2,
                                   up_calls=2, cycles=3)],
                    seed=37)) as plan:
                for _ in range(24):
                    outs.append(np.asarray(sup.dispatch(
                        "flap.batch", body, (data,), host_fn=body,
                        rebuild=lambda: body)))
                plan.clear()
                for _ in range(sup.promote_after + 2):
                    sup.tick()
                summary = plan.summary()
            return {"outs": outs, "stats": sup.stats(),
                    "summary": summary, "topology": topo(W)}
    got = both(run)
    assert all(same_bytes(o, body(data)) for o in got["outs"])
    assert got["stats"]["host_quarantines"] >= 2
    assert got["stats"]["host_repromotions"] >= 2
    assert not got["stats"]["demoted"]
    assert got["topology"] == {"hosts": 2, "n": 8}


# -- bench, selftest, the shared degrade shape ---------------------------------

def test_bench_host_chaos_workload_host():
    """``-w host-chaos --device host``: one fault domain, so the loss
    demotes to the ground-truth twin (the width-1 floor); the row's
    counter deltas equal the reference's."""
    argv = ["-p", "jerasure", "-P", "technique=reed_sol_van", "-P", "k=4",
            "-P", "m=2", "-s", "4096", "--workload", "host-chaos",
            "--device", "host", "--batch", "2", "--iterations", "1",
            "-e", "1"]
    rows = {}
    for W in (PORT, REF):
        bench = importlib.import_module(
            f"{W.name}.bench.erasure_code_benchmark")
        with isolated(W):
            b = bench.ErasureCodeBench()
            b.setup(argv)
            rows[W.name] = b.run()
    port, ref = rows["ceph_tpu_torch"], rows["ceph_tpu"]
    assert port["workload"] == ref["workload"] == "host-chaos"
    assert port["verified"] is ref["verified"] is True
    assert port["hosts"] == ref["hosts"] == 1
    for key in ("faults_fired", "reclaim_calls", "demoted_at_end",
                "total_bytes", "erasures"):
        assert port[key] == ref[key], key
    assert port["supervisor"].pop("card_failures") == 0
    assert port["supervisor"] == ref["supervisor"]
    assert port["supervisor"]["demotions"] >= 1
    assert port["supervisor"]["host_completions"] >= 1


def test_bench_host_chaos_workload_on_a_plane(monkeypatch):
    """``-w host-chaos --device cpu`` over 4 members in 2 hosts: one
    host quarantine, the reclaim hook, one re-promotion, nothing
    demoted, the heal byte for byte (the workload's own gate)."""
    from ceph_tpu_torch.bench import erasure_code_benchmark as bench
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "4")
    with isolated(PORT):
        b = bench.ErasureCodeBench()
        b.setup(["-p", "jerasure", "-P", "technique=reed_sol_van", "-P",
                 "k=4", "-P", "m=2", "-s", "16384", "--workload",
                 "host-chaos", "--device", "cpu", "--batch", "4",
                 "--iterations", "1", "-e", "1", "--hosts", "2"])
        row = b.run()
    assert row["hosts"] == 2 and row["verified"] is True
    sup = row["supervisor"]
    assert sup["host_quarantines"] == 1 and sup["host_repromotions"] == 1
    assert sup["demotions"] == 0 and sup["card_failures"] == 0
    assert row["reclaim_calls"] == 1 and not row["demoted_at_end"]
    assert PORT.plane.data_plane() is None      # the plane it found


def test_bench_host_chaos_on_the_card_without_a_plane(monkeypatch):
    """``-w host-chaos`` on one card with no virtual members: no plane
    forms, so the process is its one fault domain; losing host 0 raises
    DeviceDispatchError on each of the loss's two calls and the pass is
    re-queued, with nothing demoted and the heal byte for byte (the
    workload's own gate).  CPU tensors stand in for the card's."""
    from ceph_tpu_torch.bench import erasure_code_benchmark as bench
    monkeypatch.delenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES")
    monkeypatch.setattr(PORT.sup, "_on_card", lambda args: True)
    with isolated(PORT):
        b = bench.ErasureCodeBench()
        b.setup(["-p", "jerasure", "-P", "technique=reed_sol_van", "-P",
                 "k=4", "-P", "m=2", "-s", "16384", "--workload",
                 "host-chaos", "--device", "cpu", "--batch", "4",
                 "--iterations", "1", "-e", "1", "--hosts", "2"])
        row = b.run()
    assert row["hosts"] == 1 and row["verified"] is True
    sup = row["supervisor"]
    assert row["faults_fired"] == 2 and sup["card_failures"] == 2
    assert sup["demotions"] == 0 and sup["host_completions"] == 0
    assert sup["host_quarantines"] == 0 and sup["quarantines"] == 0
    assert not row["demoted_at_end"]


def test_host_chaos_selftest_green():
    def run(W):
        W.plane.set_data_plane(None)
        st = H(W).host_chaos_selftest()
        return st
    st = both(run)
    assert st["multi_host"] is True
    assert st["host_quarantines"] >= 1 and st["host_repromotions"] >= 1
    assert st["journal_redispatches"] >= 1
    assert not st["demoted"] and st["plan"]["fired"] >= 1


def test_plane_degrade_routes_through_shared_shape():
    """Activation-time degrade and the quarantines emit the same
    ``engine_mesh_degraded`` flight note, in both packages."""
    def run(W):
        rec = W.recorder.FlightRecorder()
        prev = W.recorder.set_global_flight_recorder(rec)
        try:
            W.plane._degrade("unit-test narrowing")
            entries = [e for e in rec.to_dict()["entries"]
                       if e["kind"] == "engine_mesh_degraded"]
            return {k: entries[-1][k] for k in ("kind", "reason", "seam")}
        finally:
            W.recorder.set_global_flight_recorder(prev)
    got = both(run)
    assert got == {"kind": "engine_mesh_degraded",
                   "reason": "unit-test narrowing",
                   "seam": "parallel.plane.activate"}


def test_width1_plane_degrades_without_virtual_members(monkeypatch):
    """One CPU and no virtual members: a plane cannot form, degrades
    (logged and counted), and the engine stays single-device."""
    from ceph_tpu_torch.telemetry import metrics as tel
    monkeypatch.delenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES")
    prev = PORT.plane.set_data_plane(None)
    try:
        before = tel.global_metrics().counter_value("engine_mesh_degraded")
        assert PORT.plane.activate() is None
        after = tel.global_metrics().counter_value("engine_mesh_degraded")
        assert after == before + 1
        assert PORT.plane.data_plane() is None
    finally:
        PORT.plane.set_data_plane(prev)
