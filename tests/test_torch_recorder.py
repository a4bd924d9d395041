"""The port's flight recorder and dump schema
(``ceph_tpu_torch.telemetry.{recorder,schema}``) against the reference's:
on a FakeClock-fresh world (tracer, metrics registry and recorder on one
clock) the same scenario leaves the same post-mortem blob in both
packages — at an UnrecoverableError's construction, a seeded
past-budget batched repair, an armed recompile budget, a crash site and
the serving SLO burn-rate trip — and the schema gives the same verdicts
on good and broken dumps.  The couplings: every structured event is a
breadcrumb in the ring, span roots reach it once the recorder is
installed, and ``CEPH_TPU_FLIGHT_DIR`` writes each blob.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest


def world(name: str) -> SimpleNamespace:
    mods = {"tel": "telemetry", "recorder": "telemetry.recorder",
            "schema": "telemetry.schema", "metrics": "telemetry.metrics",
            "spans": "telemetry.spans", "errors": "utils.errors",
            "retry": "utils.retry", "chaos": "chaos", "scrub": "scrub",
            "stripe": "codes.stripe", "engine": "codes.engine",
            "registry": "codes.registry", "sla": "serve.sla",
            "queue": "serve.queue"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


class flight_world:
    """A fresh tracer, metrics registry and flight recorder on one
    FakeClock, restored on exit (the reference's tests do the same)."""

    def __init__(self, W):
        self.W = W
        self.clock = W.retry.FakeClock()

    def __enter__(self):
        W, clk = self.W, self.clock
        kw = {"annotate": False} if W is REF else {}
        self.prev = (W.spans.set_global_tracer(W.spans.SpanTracer(clock=clk,
                                                                  **kw)),
                     W.metrics.set_global_metrics(
                         W.metrics.MetricsRegistry(clock=clk)),
                     W.recorder.set_global_flight_recorder(
                         W.recorder.FlightRecorder(clock=clk)))
        return self

    def __exit__(self, *exc):
        tr, reg, rec = self.prev
        self.W.spans.set_global_tracer(tr)
        self.W.metrics.set_global_metrics(reg)
        self.W.recorder.set_global_flight_recorder(rec)
        return False


def canon(blob) -> str:
    return json.dumps(blob, sort_keys=True)


def both(fn):
    got, want = fn(PORT), fn(REF)
    assert canon(got) == canon(want)
    return got


# -- the triggers ------------------------------------------------------------

def test_unrecoverable_construction_freezes_postmortem():
    def run(W):
        with flight_world(W):
            W.tel.counter("some_counter", 7)
            W.tel.event("breadcrumb", step=1)
            exc = W.errors.UnrecoverableError("3 shards lost",
                                              shards=[0, 2, 5],
                                              extents=[(0, 4096)])
            assert exc.shards == (0, 2, 5)
            blob = W.recorder.global_flight_recorder().last_dump()
            assert W.schema.validate_flight_dump(blob) == []
            return blob

    blob = both(run)
    assert blob["trigger"] == "unrecoverable"
    assert blob["context"] == {"extents": [[0, 4096]], "shards": [0, 2, 5]}
    assert blob["metrics_delta"]["ceph_tpu_telemetry.some_counter"] == 7
    # the event rode into the ring ahead of the trigger
    assert [e["kind"] for e in blob["entries"]] == ["breadcrumb",
                                                    "unrecoverable"]


def _unrecoverable_scenario(W, seed=13, objects=3):
    """A seeded past-budget batched repair on a FakeClock-fresh world:
    the blob it freezes and the recorder section."""
    with flight_world(W):
        prev_cache = W.engine.set_global_pattern_cache(
            W.engine.PatternCache())
        try:
            W.tel.install_flight_recorder()
            kw = {"device": "cpu"} if W is PORT else {}
            ec = W.registry.ErasureCodePluginRegistry.instance().factory(
                "jerasure", {"technique": "reed_sol_van", "k": "4",
                             "m": "2"}, **kw)
            n = ec.get_chunk_count()
            cs = ec.get_chunk_size(4096)
            sinfo = W.stripe.StripeInfo(4, 4 * cs)
            rng = np.random.default_rng(seed)
            stores, hinfos = [], []
            for i in range(objects):
                obj = rng.integers(0, 256, 4 * cs, dtype=np.uint8).tobytes()
                shards = W.stripe.encode(sinfo, ec, obj)
                h = W.stripe.HashInfo(n)
                h.append(0, shards)
                lost = [0, 1, 2] if i == 0 else [i % n]
                store, _ = W.chaos.inject(
                    shards, [W.chaos.ShardErasure(shards=lost)],
                    seed=seed + i, chunk_size=cs)
                stores.append(store)
                hinfos.append(h)
            with pytest.raises(W.errors.UnrecoverableError):
                W.scrub.repair_batched(sinfo, ec, stores, hinfos,
                                       clock=W.retry.FakeClock())
            rec = W.recorder.global_flight_recorder()
            return rec.last_dump(), rec.to_dict()
        finally:
            W.engine.set_global_pattern_cache(prev_cache)


def _scrub_series(section):
    """The recorder section without the metrics series the two packages
    name differently by design (the encode's tier counters: the
    reference's perf registry is not in this dump, the port's device
    counters are) — what is left must match letter for letter."""
    def strip(blob):
        blob = dict(blob)
        blob.pop("metrics", None)
        blob.pop("metrics_delta", None)
        return blob
    out = dict(section)
    out["dumps"] = [strip(b) for b in section["dumps"]]
    return out


def test_seeded_unrecoverable_dump_equals_reference():
    """A seeded past-budget repair freezes a schema-valid blob that is
    byte-identical across reruns and — ring, spans, context, reason —
    the reference's; the metrics it snapshots carry the same scrub
    series."""
    blob1, sec1 = _unrecoverable_scenario(PORT)
    blob2, sec2 = _unrecoverable_scenario(PORT)
    assert canon(blob1) == canon(blob2) and canon(sec1) == canon(sec2)
    assert PORT.schema.validate_flight_dump(blob1) == []
    ref_blob, ref_sec = _unrecoverable_scenario(REF)
    assert canon(_scrub_series(sec1)) == canon(_scrub_series(ref_sec))
    reg = "ceph_tpu_telemetry"
    for key in ("scrub_deep_scrub_seconds", "chaos_injections{kind=erase}"):
        assert canon(blob1["metrics"][reg].get(key)) == \
            canon(ref_blob["metrics"][reg].get(key))
    assert blob1["trigger"] == "unrecoverable"
    assert "unrecoverable" in {e["kind"] for e in blob1["entries"]}


def test_recompile_budget_trip_dumps():
    def run(W):
        with flight_world(W):
            cache = W.engine.PatternCache(recompile_budget=1)
            cache.get_or_build(("a",), lambda: 1)
            with pytest.raises(RuntimeError, match="recompile budget"):
                cache.get_or_build(("b",), lambda: 2)
            blob = W.recorder.global_flight_recorder().last_dump()
            return {k: blob[k] for k in ("trigger", "reason", "context",
                                         "entries", "dump", "time")}

    blob = both(run)
    assert blob["trigger"] == "recompile_budget"
    assert blob["context"]["builds"] == 2 and blob["context"]["budget"] == 1


def test_crash_site_trip_dumps():
    def run(W):
        with flight_world(W):
            cp = W.chaos.CrashPoint(site="writeback.after_write")
            with pytest.raises(W.errors.InjectedCrash):
                cp.visit("writeback.after_write")
            blob = W.recorder.global_flight_recorder().last_dump()
            assert W.schema.validate_flight_dump(blob) == []
            return blob

    blob = both(run)
    assert blob["trigger"] == "crash_site"
    assert blob["context"]["site"] == "writeback.after_write"


def test_burn_rate_monitor_trips_and_dumps():
    """The SLO burn-rate trip freezes the reference's dump: the same
    trips, the same blob, the same counter."""
    def run(W):
        with flight_world(W):
            mon = W.sla.BurnRateMonitor(budget=0.02, windows=((10, 4.0),))
            fired = [mon.record("encode", False) for _ in range(11)]
            for _ in range(10):
                mon.record("encode", True)
            fired += [mon.record("encode", False) for _ in range(10)]
            blob = W.recorder.global_flight_recorder().last_dump()
            trips = W.metrics.global_metrics().counter_value(
                "serve_slo_burn_trips", window="10")
            return fired, mon.trips, blob, trips

    fired, trips, blob, count = both(run)
    assert len(trips) == 2 and count == 2
    assert blob["trigger"] == "slo_burn" and blob["dump"] == 2


def test_sla_recorder_feeds_monitor():
    def run(W):
        with flight_world(W):
            rec = W.sla.SlaRecorder(monitor=W.sla.BurnRateMonitor(
                budget=0.02, windows=((4, 1.0),)))
            data = np.zeros((2, 64), np.uint8)
            for i in range(4):
                req = W.queue.EcRequest(op="encode", plugin="jerasure",
                                        profile={"k": "2", "m": "1"},
                                        stripe_size=128, payload=data)
                rec.record(W.queue.EcResult(
                    request=req, output=data, completed=float(i),
                    queue_wait=0.0, service=0.1, batch_occupancy=1,
                    batch_rung=1, deadline_met=(i % 2 == 0)))
            blob = W.recorder.global_flight_recorder().last_dump()
            return rec.monitor.trips, blob["context"], blob["reason"]

    trips, _, _ = both(run)
    assert len(trips) == 1


# -- the ring and the couplings -----------------------------------------------

def test_ring_bounds_and_span_roots():
    """Ring overflow drops the oldest and counts them; finished span
    roots land as summaries once the recorder is installed; a dump's
    counter delta is incremental — as in the reference."""
    def run(W):
        clk = W.retry.FakeClock()
        rec = W.recorder.FlightRecorder(clock=clk, max_entries=8,
                                        max_dumps=2)
        reg = W.metrics.MetricsRegistry(clock=clk)
        kw = {"annotate": False} if W is REF else {}
        tracer = W.spans.SpanTracer(clock=clk, **kw)
        W.recorder.install_flight_recorder(rec, tracer)
        with tracer.span("repair", objects=1):
            clk.sleep(0.5)
            with tracer.span("scrub"):
                reg.counter("selftest_ops", 3)
        for i in range(12):
            rec.note("tick", i=i)
        blob = rec.dump("manual", "selftest", registry=reg, tracer=tracer,
                        site="selftest")
        reg.counter("selftest_ops", 2)
        blob2 = rec.dump("manual", "again", registry=reg, tracer=tracer)
        rec.dump("manual", "third", registry=reg, tracer=tracer)
        return blob, blob2, rec.to_dict(), rec.dropped

    blob, blob2, section, dropped = both(run)
    assert dropped == 5 and len(blob["entries"]) == 8
    assert blob["metrics_delta"]["ceph_tpu_telemetry.selftest_ops"] == 3
    assert blob2["metrics_delta"]["ceph_tpu_telemetry.selftest_ops"] == 2
    assert section["dump_count"] == 3 and len(section["dumps"]) == 2
    assert PORT.schema.validate_flight_dump(blob) == []


def test_event_breadcrumbs_and_disabled_telemetry():
    """Every metrics.event is a breadcrumb; with telemetry disabled,
    note and trip record nothing and return None."""
    def run(W):
        with flight_world(W):
            W.tel.event("tier_change", engine="host")
            W.recorder.note("manual_note", x=1)
            W.metrics.set_enabled(False)
            try:
                off = (W.recorder.trip("manual", "off"),
                       W.recorder.note("ignored"))
                W.tel.event("ignored")
            finally:
                W.metrics.set_enabled(True)
            on = W.recorder.trip("manual", "on", why="test")
            return off, on, W.recorder.global_flight_recorder().to_dict()

    off, on, section = both(run)
    assert off == [None, None] or off == (None, None)
    assert [e["kind"] for e in section["entries"]] == [
        "tier_change", "manual_note", "manual"]


def test_flight_dir_writes_each_blob(tmp_path, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_FLIGHT_DIR", str(tmp_path))
    with flight_world(PORT):
        blob = PORT.recorder.trip("manual", "to disk", n=3)
    path = tmp_path / "flight_manual_0001.json"
    assert json.loads(path.read_text()) == json.loads(canon(blob))


def test_flight_recorder_selftest_names_item_6():
    """The selftest, on the program profiler's tick clock: its blob
    equals the reference's letter for letter."""
    got = PORT.recorder.flight_recorder_selftest()
    assert canon(got) == canon(REF.recorder.flight_recorder_selftest())
    assert PORT.schema.validate_flight_dump(got) == []


# -- the schema ----------------------------------------------------------------

def _broken(blob):
    bad1 = json.loads(canon(blob))
    del bad1["metrics_delta"]
    bad2 = json.loads(canon(blob))
    bad2["entries"] = [{"seq": 2, "kind": "a", "t": 0.0},
                       {"seq": 1, "kind": "b", "t": 0.0}]
    bad3 = json.loads(canon(blob))
    bad3["entries"] = [{"kind": "missing-seq"}]
    bad4 = json.loads(canon(blob))
    bad4["flight_schema_version"] = 99
    return [bad1, bad2, bad3, bad4]


def test_flight_dump_schema_verdicts_equal_reference():
    blob, _ = _unrecoverable_scenario(PORT)
    verdicts = [PORT.schema.validate_flight_dump(b)
                for b in [blob] + _broken(blob)]
    assert verdicts == [REF.schema.validate_flight_dump(b)
                        for b in [blob] + _broken(blob)]
    assert verdicts[0] == []
    assert any("metrics_delta" in e for e in verdicts[1])
    assert any("seq-ordered" in e for e in verdicts[2])
    assert all(v for v in verdicts[1:])


def test_unified_dump_sections_validate():
    """dump_all with the flight and trace sections validates in the
    port's schema and in the reference's, and a broken histogram or
    span fails both the same way."""
    with flight_world(PORT):
        PORT.tel.counter("x", 2)
        PORT.tel.observe("lat_seconds", 0.002, op="encode")
        with PORT.spans.global_tracer().span("repair"):
            pass
        PORT.errors.UnrecoverableError("x", shards=[1])
        dump = PORT.tel.dump_all(flight=True, traces=True)
    assert dump["flight_recorder"]["dump_count"] == 1
    bad = json.loads(canon(dump))
    hist = bad["ceph_tpu_telemetry"]["lat_seconds{op=encode}"]
    del hist["p99"]
    bad2 = json.loads(canon(dump))
    bad2["spans"]["spans"][0].pop("end")
    for d in (dump, bad, bad2):
        assert PORT.schema.validate_dump(d) == REF.schema.validate_dump(d)
    assert PORT.schema.validate_dump(dump) == []
    assert PORT.schema.validate_dump(bad) and PORT.schema.validate_dump(bad2)
    assert PORT.schema.validate_trace_dump(dump["traces"]) == \
        REF.schema.validate_trace_dump(dump["traces"]) == []
    assert PORT.schema.SCHEMA_VERSION == REF.schema.SCHEMA_VERSION
