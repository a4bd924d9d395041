"""The port's multi-tenant compressed week (``ceph_tpu_torch.scenario.
week``) against the reference's ``ceph_tpu.scenario.week``, on the CPU.

- the pinned tiny week (3 tenants, 2 days, all four staged disasters)
  on an EventClock: the report JSON, ``dispatch_crc`` and the batcher's
  dispatch log equal the reference's on the host executor; on the
  device executor (CPU tensors against the reference's CPU backend)
  too, but for one supervisor counter: the port runs a seam reached
  from inside another seam's callable bare (``ops/supervisor.py``), so
  the two fused repairs nested in the backend-loss stage's
  ``week.recovery`` dispatches are not counted as ``dispatches`` (nor
  self-verified, ``verified_clean``);
- the isolation gate's verdicts (arbiter on passes, off fails) and the
  baselines equal the reference's;
- the stepped clock equals the discrete-event clock;
- ``week_selftest`` equals the reference's;
- the four instruments' clocks are restored on every exit path;
- the generator's week options (shared payloads, the burst boost)
  give the reference's stream.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_supervisor import PORT as SUP_PORT
from test_torch_supervisor import REF as SUP_REF
from test_torch_supervisor import isolated


def world(name: str) -> SimpleNamespace:
    mods = {"scenario": "scenario", "week": "scenario.week",
            "spec": "scenario.spec", "loadgen": "serve.loadgen",
            "retry": "utils.retry", "sup": "ops.supervisor",
            "telemetry": "telemetry", "recorder": "telemetry.recorder",
            "spans": "telemetry.spans"}
    ns = SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})
    ns.sup_world = SUP_REF if name == "ceph_tpu" else SUP_PORT
    return ns


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")
TINY = dict(seed=17, days=2, day_s=6.0, peak_rates=(40.0, 30.0, 20.0),
            burst_factor=80.0)


def tiny_spec(W):
    return W.spec.tenant_week_scenario(**TINY)


def week(W, executor="host", **kw):
    if W is PORT and executor == "device":
        kw["device"] = "cpu"
    with isolated(W.sup_world):
        return W.week.run_tenant_week(tiny_spec(W), executor=executor,
                                      **kw)


_RUNS: dict = {}


def cached(W, executor):
    key = (W.name, executor)
    if key not in _RUNS:
        _RUNS[key] = week(W, executor)
    return _RUNS[key]


def log_of(run) -> str:
    return json.dumps(run.batcher.dispatch_log, sort_keys=True,
                      default=str)


@pytest.mark.parametrize("executor", ["host", "device"])
def test_week_equals_reference(executor):
    ref, port = cached(REF, executor), cached(PORT, executor)
    r, p = json.loads(ref.report.to_json()), json.loads(port.report.to_json())
    if executor == "device":
        rs, ps = r["recovery"]["supervisor"], p["recovery"]["supervisor"]
        # the two fused repairs nested in week.recovery (see docstring)
        for key in ("dispatches", "verified_clean"):
            assert rs.pop(key) - ps.pop(key) == 2, key
    assert p == r
    assert port.report.gates["dispatch_crc"] == \
        ref.report.gates["dispatch_crc"]
    assert log_of(port) == log_of(ref)
    g = port.report.gates
    assert g["converged"] and g["healed"] and g["verified_requests"]
    assert port.report.executor == executor
    assert [d["kind"] for d in port.report.disasters] == [
        "rack_loss", "backend_loss", "host_loss", "tenant_burst"]


def test_isolation_gate_equals_reference():
    """Arbiter on passes the gate, the arbiter-off control fails it, in
    both packages, with equal baselines and verdicts."""
    out = {}
    for W in (REF, PORT):
        spec = tiny_spec(W)
        with isolated(W.sup_world):
            base = {n: W.week.isolated_baseline(spec, n, executor="host")
                    for n in ("alpha", "bravo")}
            off = W.week.run_tenant_week(spec, executor="host",
                                         enable_arbiter=False).report
        on = W.week.isolation_gate(cached(W, "host").report, base)
        out[W.name] = (base, on, W.week.isolation_gate(off, base),
                       off.to_json())
    assert out["ceph_tpu_torch"] == out["ceph_tpu"]
    base, on, off, _ = out["ceph_tpu_torch"]
    assert on["ok"] and not off["ok"]


def test_stepped_clock_equals_event_clock():
    stepped = week(PORT, clock_mode="step")
    assert stepped.report.to_json() == cached(PORT, "host").report.to_json()
    with pytest.raises(ValueError) as p:
        week(PORT, clock_mode="warp")
    with pytest.raises(ValueError) as r:
        week(REF, clock_mode="warp")
    assert str(p.value) == str(r.value)


def test_week_selftest_equals_reference():
    with isolated(SUP_REF):
        ref = REF.week.week_selftest()
    with isolated(SUP_PORT):
        port = PORT.week.week_selftest()
    assert port == ref
    assert port["executor"] == "host"


def _clocks(W):
    return [W.telemetry.global_metrics().clock,
            W.recorder.global_flight_recorder().clock,
            W.spans.global_tracer().clock,
            W.sup.global_supervisor().clock]


def test_instruments_follow_the_week_clock_and_are_restored(monkeypatch):
    before = _clocks(PORT)
    clock = PORT.retry.EventClock()
    with PORT.week._instruments_on(clock):
        assert all(c is clock for c in _clocks(PORT))
    assert _clocks(PORT) == before
    with pytest.raises(RuntimeError):
        with PORT.week._instruments_on(clock):
            raise RuntimeError("boom")
    assert _clocks(PORT) == before

    # a week that fails mid-run restores them too
    def fail(*a, **k):
        assert all(c is clock for c in _clocks(PORT))
        raise RuntimeError("mid-week")
    monkeypatch.setattr(PORT.week, "_run_week_body", fail)
    with pytest.raises(RuntimeError, match="mid-week"):
        PORT.week.run_tenant_week(tiny_spec(PORT), clock=clock,
                                  executor="host")
    assert _clocks(PORT) == before


def test_week_errors_equal_reference(monkeypatch):
    texts = []
    for W in (REF, PORT):
        with pytest.raises(ValueError) as e:
            W.week.run_tenant_week(tiny_spec(W), clock=object(),
                                   executor="host")
        texts.append(str(e.value))
        with pytest.raises(ValueError) as e:
            W.week.run_tenant_week(W.spec.default_scenario(seed=1),
                                   executor="host")
        texts.append(str(e.value))
    assert texts[2:] == texts[:2]
    from ceph_tpu_torch.utils.errors import NoDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        PORT.week.run_tenant_week(tiny_spec(PORT))


@pytest.mark.parametrize("tenant", ["alpha", "noisy"])
def test_generator_week_options_equal_reference(tenant):
    """Shared payloads and the burst boost: the same arrival offsets and
    the same payload bytes as the reference's generator."""
    streams = {}
    for W in (REF, PORT):
        spec = tiny_spec(W)
        ten = next(t for t in spec.tenants if t.name == tenant)
        gen = W.loadgen.LoadGenerator(ten.traffic, share_payloads=True)
        reqs, offs = gen.generate(boost=W.week._burst_boost(spec, tenant))
        streams[W.name] = (reqs, offs)
    (rr, ro), (pr, po) = streams["ceph_tpu"], streams["ceph_tpu_torch"]
    assert po == ro and len(pr) == len(rr)
    for a, b in zip(pr, rr):
        assert (a.op, a.tenant, a.req_id, a.available, a.erased) == \
            (b.op, b.tenant, b.req_id, b.available, b.erased)
        assert np.array_equal(a.payload, b.payload)
    # shared: requests of one (codec, object, pattern) hold one array
    dec = [r for r in pr if r.op != "encode"]
    keys = {}
    for r in dec:
        keys.setdefault((r.plugin, r.payload.tobytes(), r.erased),
                        set()).add(id(r.payload))
    assert all(len(ids) == 1 for ids in keys.values())
