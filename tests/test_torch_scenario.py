"""The port's composed scenario (``ceph_tpu_torch.scenario``: spec, the
mClock arbiter, the runner, the report) against the reference's
``ceph_tpu.scenario``, on the CPU, letter for letter.

- ``ScenarioSpec`` JSON: each package's ``to_json`` equals the other's
  and each ``from_json`` reads the other's; the validation errors;
- the arbiter: ``qos_selftest``, and a scripted FakeClock decision log
  (class admissions, the tenant door, hold times, the burn-rate scale);
- ``run_scenario`` on a FakeClock with ``throughput_service_model()``:
  the host executor with the arbiter on and off, the device executor
  on CPU tensors (``device="cpu"``) against the reference's device
  executor on its CPU backend, plus a ``dispatch_fault`` and a
  ``host_loss`` variant (8 virtual members): the ScenarioReport JSON
  and the batcher's dispatch log equal the reference's.  The one field
  not compared is ``slo.stream_compiles``: the reference counts jax
  compiles after warmup, the port kernel setups (0 here);
- the serving loop's hooks (``sla``, ``interleave``, ``on_result``)
  leave a hookless run unchanged.

The device variants serve the rs k=4 m=2 codec only: the reference's
device executor compiles each shec and clay pattern for seconds.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from test_torch_supervisor import PORT as SUP_PORT
from test_torch_supervisor import REF as SUP_REF
from test_torch_supervisor import isolated


def world(name: str) -> SimpleNamespace:
    mods = {"scenario": "scenario", "spec": "scenario.spec",
            "qos": "scenario.qos", "runner": "scenario.runner",
            "report": "scenario.report", "loadgen": "serve.loadgen",
            "retry": "utils.retry", "topology": "cluster.topology"}
    ns = SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})
    ns.sup_world = SUP_REF if name == "ceph_tpu" else SUP_PORT
    return ns


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def sim_run(W, spec, executor="host", enabled=None):
    kw = {"device": "cpu"} if W is PORT and executor == "device" else {}
    return W.scenario.run_scenario(
        spec, clock=W.retry.FakeClock(), executor=executor,
        service_model=W.loadgen.throughput_service_model(),
        enable_arbiter=enabled, **kw)


def report_dict(run) -> dict:
    d = json.loads(run.report.to_json())
    d["slo"].pop("stream_compiles", None)
    return d


def dispatch_log(run) -> str:
    return json.dumps(run.serving.batcher.dispatch_log, sort_keys=True,
                      default=str)


# -- spec -------------------------------------------------------------------

def _specs(W):
    base = W.spec.default_scenario(seed=7, n_requests=32)
    return {
        "default": base,
        "qos": base.with_qos(enabled=False, floor=0.2),
        "dispatch_fault": replace(base, chaos=replace(
            base.chaos, dispatch_fault="backend_loss",
            dispatch_fault_at=3, dispatch_fault_calls=None)),
        "host_loss": replace(base, chaos=replace(
            base.chaos, host_loss="host_flap", host_loss_host=0,
            host_loss_hosts=4, host_loss_at=3, host_loss_calls=None)),
        "week": W.spec.tenant_week_scenario(seed=17, days=2, day_s=6.0),
    }


@pytest.mark.parametrize("name", ["default", "qos", "dispatch_fault",
                                  "host_loss", "week"])
def test_spec_json_both_ways(name):
    ref, port = _specs(REF)[name], _specs(PORT)[name]
    assert port.to_json() == ref.to_json()
    assert PORT.spec.ScenarioSpec.from_json(ref.to_json()) == port
    assert REF.spec.ScenarioSpec.from_json(port.to_json()) == ref
    assert PORT.spec.ScenarioSpec.from_json(port.to_json()).to_json() == \
        ref.to_json()


def _bad_specs(W):
    L = W.loadgen
    traffic = L.TrafficSpec(codecs=[L.CodecSpec(
        "rs_k4_m2", "jerasure",
        {"technique": "reed_sol_van", "k": "4", "m": "2"}, 4096)])
    C = W.topology.ClusterSpec
    return [lambda: W.spec.ScenarioSpec(traffic=None),
            lambda: W.spec.ScenarioSpec(traffic=traffic,
                                        cluster=C(ec_k=2, ec_m=1)),
            lambda: W.spec.ScenarioSpec(traffic=traffic,
                                        cluster=C(ec_pg_num=0))]


@pytest.mark.parametrize("i", range(3))
def test_spec_validation_errors_equal_reference(i):
    with pytest.raises(ValueError) as r:
        _bad_specs(REF)[i]()
    with pytest.raises(ValueError) as p:
        _bad_specs(PORT)[i]()
    assert str(p.value) == str(r.value)


def test_exports_equal_reference():
    assert PORT.scenario.__all__ == REF.scenario.__all__
    assert PORT.spec.DISASTER_KINDS == REF.spec.DISASTER_KINDS
    assert PORT.spec.QOS_CLASSES == REF.spec.QOS_CLASSES
    assert PORT.qos.CLASSES == REF.qos.CLASSES


# -- the arbiter ------------------------------------------------------------

def test_qos_selftest_equals_reference():
    assert PORT.qos.qos_selftest() == REF.qos.qos_selftest()


def _decision_log(W, enabled):
    """A scripted FakeClock day of the arbiter: every class asks each
    millisecond, the client stream misses in bursts, two tenants (one
    reserved, one limited) knock at the door."""
    clock = W.retry.FakeClock()
    spec = W.spec.QosSpec(reservation={"recovery": 2.0, "scrub": 1.0},
                          weight={"recovery": 4.0, "rebalance": 2.0},
                          limit={"recovery": 40.0, "scrub": 8.0},
                          weight_rate=10.0, miss_budget=0.02, window=16,
                          enabled=enabled)
    arb = W.qos.MClockArbiter(spec, clock=clock)
    arb.register_tenant("alpha", reservation=20.0, weight=2.0)
    arb.register_tenant("noisy", weight=1.0, limit=30.0)
    log = []
    for step in range(600):
        if step % 3 == 0:
            arb.record_client(not (200 <= step < 320 and step % 2))
        row = [round(arb.pressure(), 9), round(arb.background_scale(), 9)]
        for cls in ("recovery", "scrub", "rebalance", "client"):
            row.append(arb.admit(cls))
            row.append(round(arb.hold_for(cls), 9))
        for ten in ("alpha", "noisy"):
            row.append(arb.admit_tenant(ten, clock.monotonic()))
            row.append(round(arb.tenant_hold(ten), 9))
        log.append(row)
        clock.sleep(0.001)
    return log, arb.snapshot()


@pytest.mark.parametrize("enabled", [True, False])
def test_arbiter_decision_log_equals_reference(enabled):
    r_log, r_snap = _decision_log(REF, enabled)
    p_log, p_snap = _decision_log(PORT, enabled)
    assert p_log == r_log
    assert p_snap == r_snap


def test_arbiter_errors_equal_reference():
    texts = []
    for W in (REF, PORT):
        arb = W.qos.MClockArbiter(W.spec.QosSpec(),
                                  clock=W.retry.FakeClock())
        with pytest.raises(ValueError) as e:
            arb.admit("mystery")
        texts.append(str(e.value))
    assert texts[1] == texts[0]


# -- run_scenario -----------------------------------------------------------

@pytest.mark.parametrize("enabled", [None, False])
def test_host_executor_equals_reference(enabled):
    ref = sim_run(REF, REF.spec.default_scenario(
        seed=42, n_requests=64, damaged_objects=3, storm_events=4),
        enabled=enabled)
    port = sim_run(PORT, PORT.spec.default_scenario(
        seed=42, n_requests=64, damaged_objects=3, storm_events=4),
        enabled=enabled)
    assert port.report.to_json() == ref.report.to_json()
    assert dispatch_log(port) == dispatch_log(ref)
    assert port.report.ok()
    assert [s.snapshot() for s in port.stores] == \
        [s.snapshot() for s in ref.stores]


def test_arbiter_strictly_better_on_cpu_tensors():
    """The pinned contention claim on the device executor: arbiter-on
    client p99 and miss rate strictly better than arbiter-off, both
    converged, healed and byte-verified."""
    spec = PORT.spec.default_scenario(seed=42, n_requests=64,
                                      damaged_objects=3, storm_events=4)
    on = sim_run(PORT, spec, "device").report
    off = sim_run(PORT, spec, "device", enabled=False).report
    for rep in (on, off):
        assert rep.ok() and rep.gates["unrecoverable"] == []
        assert rep.slo["stream_compiles"] == 0
    assert on.p99_ms < off.p99_ms
    assert on.deadline_miss_rate < off.deadline_miss_rate


def _device_spec(W, variant):
    base = W.spec.default_scenario(seed=42, n_requests=24,
                                   stripe_size=4096, damaged_objects=2,
                                   erasures=1, storm_events=2)
    spec = replace(base, traffic=replace(
        base.traffic, codecs=[base.traffic.codecs[0]]))
    if variant == "dispatch_fault":
        spec = replace(spec, chaos=replace(
            spec.chaos, dispatch_fault="backend_loss",
            dispatch_fault_at=2, dispatch_fault_calls=None))
    if variant == "host_loss":
        spec = replace(spec, chaos=replace(
            spec.chaos, host_loss="host_loss", host_loss_at=2,
            host_loss_calls=None))
    return spec


@pytest.mark.parametrize("variant", ["plain", "dispatch_fault",
                                     "host_loss"])
def test_device_executor_equals_reference(variant, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "8")
    runs = {}
    for W in (REF, PORT):
        with isolated(W.sup_world):
            runs[W.name] = sim_run(W, _device_spec(W, variant), "device")
    ref, port = runs["ceph_tpu"], runs["ceph_tpu_torch"]
    assert report_dict(port) == report_dict(ref)
    assert dispatch_log(port) == dispatch_log(ref)
    rep = port.report
    assert rep.ok() and rep.slo["stream_compiles"] == 0
    assert "stream_compiles" in ref.report.slo
    if variant == "dispatch_fault":
        assert rep.supervisor["counters"]["demotions"] >= 1
        assert rep.supervisor["counters"]["repromotions"] >= 1
        assert not rep.supervisor["demoted_at_end"]
    if variant == "host_loss":
        hp = rep.host_plane
        assert hp["counters"]["host_quarantines"] >= 1
        assert hp["topology_armed"] == {"hosts": 2, "devices_per_host": 4}
        assert hp["topology_at_end"] == hp["topology_armed"]


def test_card_failure_holds_client_fires_until_the_backend_returns(
        monkeypatch):
    """The card's rule on CPU tensors marked as the card's
    (``ops.supervisor._on_card``): the persistent backend loss raises
    ``DeviceDispatchError`` instead of demoting — a warm dispatch is
    counted, a client fire holds its requests, a recovery round
    re-queues — and once only held work is left the fault clears, as
    it does when the stream drains: every request verifies, recovery
    heals the bytes of the unfaulted control run, nothing demoted."""
    monkeypatch.setattr(PORT.sup_world.sup, "_on_card", lambda args: True)
    with isolated(PORT.sup_world):
        run = sim_run(PORT, _device_spec(PORT, "dispatch_fault"), "device")
    with isolated(PORT.sup_world):
        ctrl = sim_run(PORT, _device_spec(PORT, "plain"), "device")
    rep = run.report
    assert rep.ok(), rep.gates
    assert len(run.serving.results) == 24
    assert run.serving.batcher.card_failures >= 1
    assert run.serving.batcher.held() == 0
    counters = rep.supervisor["counters"]
    assert counters["card_failures"] >= 1
    assert counters.get("demotions", 0) == 0
    assert not rep.supervisor["demoted_at_end"]
    assert rep.supervisor["plan"]["cleared"]
    assert [sorted(st.shards.items()) for st in run.stores] == \
        [sorted(st.shards.items()) for st in ctrl.stores]


def test_held_work_nobody_releases_raises():
    """A fire that failed on the card with no ``on_stall`` to bring the
    backend back: the stream ends with held work, and that raises."""
    from ceph_tpu_torch.serve import batcher as port_batcher
    from ceph_tpu_torch.utils.errors import DeviceDispatchError
    spec = PORT.loadgen.default_spec(seed=3, n_requests=8)

    def lost(self, b, stack):
        raise DeviceDispatchError("engine.serve-encode", "backend_loss",
                                  "lost")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_batcher.ContinuousBatcher, "_execute", lost)
        with pytest.raises(DeviceDispatchError, match="held"):
            PORT.runner.run_serving_scenario(
                spec, clock=PORT.retry.FakeClock(), executor="host",
                service_model=PORT.loadgen.throughput_service_model())


def test_scenario_selftest_equals_reference():
    assert PORT.runner.scenario_selftest() == REF.runner.scenario_selftest()


def test_run_scenario_needs_a_card_by_default(monkeypatch):
    from ceph_tpu_torch.utils.errors import NoDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PORT.spec.default_scenario(seed=1, n_requests=4)
    with pytest.raises(NoDeviceError):
        PORT.scenario.run_scenario(spec, clock=PORT.retry.FakeClock())
    with pytest.raises(ValueError, match="executor"):
        PORT.scenario.run_scenario(spec, executor="jax")


# -- the serving loop's hooks -----------------------------------------------

@pytest.mark.parametrize("arrival", ["closed", "open"])
def test_serving_hooks_leave_the_loop_unchanged(arrival):
    from ceph_tpu_torch.serve.sla import SlaRecorder, SloPolicy
    spec = PORT.loadgen.default_spec(seed=3, n_requests=48,
                                     arrival=arrival)

    def run(**kw):
        return PORT.runner.run_serving_scenario(
            spec, clock=PORT.retry.FakeClock(), executor="host",
            service_model=PORT.loadgen.throughput_service_model(), **kw)
    bare = run()
    turns, seen = [], []
    sla = SlaRecorder(SloPolicy(deadlines=dict(spec.deadlines)))
    hooked = run(sla=sla, interleave=lambda: turns.append(1),
                 on_result=seen.append)
    assert hooked.report == bare.report
    assert hooked.batcher.dispatch_log == bare.batcher.dispatch_log
    assert len(seen) == len(hooked.results) == len(bare.results)
    assert len(turns) > 0 and sla.report(1.0)["requests"] == 48
    ref = REF.runner.run_serving_scenario(
        REF.loadgen.default_spec(seed=3, n_requests=48, arrival=arrival),
        clock=REF.retry.FakeClock(), executor="host",
        service_model=REF.loadgen.throughput_service_model())
    assert json.dumps(bare.report, sort_keys=True, default=str) == \
        json.dumps(ref.report, sort_keys=True, default=str)
