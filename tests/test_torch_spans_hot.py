"""The armed hot-path spans (telemetry/spans.py ``root`` / ``child`` /
``note``) inside the port's placement and codec paths, on the CPU:

- outside any profiler and unarmed, ``pg_to_up_bulk`` and an RS
  encode / decode record no span and no total;
- inside a ``torch.profiler`` session, and inside ``spans.armed()``, one
  ``pg_to_up_bulk`` gives exactly one ``osdmap.pg_to_up_bulk`` root with
  the named children, each inside its parent, every stamp between two
  ``time.perf_counter()`` reads around the call;
- ``self_seconds`` is at least 0 and is the duration less what the
  children cover, summed over the spans of a name;
- ``host_syncs`` equals the growth of ``crush_bulk_host_syncs``;
- counts roll up, and the serving plane's spans keep recording whenever
  the metrics plane is on.
"""

import contextlib
import io
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.crush.builder import CrushBuilder
from ceph_tpu_torch.crush.osdmap import OSDMap, PGPool
from ceph_tpu_torch.crush.types import Tunables
from ceph_tpu_torch.telemetry import spans
from ceph_tpu_torch.telemetry.spans import SpanTracer
from ceph_tpu_torch.utils import log
from ceph_tpu_torch.utils.perf import global_perf
from ceph_tpu_torch.utils.retry import FakeClock

CPU = torch.device("cpu")
JEWEL = dict(choose_local_tries=0, choose_local_fallback_tries=0,
             choose_total_tries=50, chooseleaf_descend_once=1,
             chooseleaf_vary_r=1, chooseleaf_stable=1)
CHILDREN = {"osdmap.overlay", "crush.rung", "crush.sync",
            "crush.host_residue"}


def _rs():
    return ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3",
                     "crush-root": "default",
                     "crush-failure-domain": "host"}, device=CPU)


def _osdmap(code, hosts=12, per_host=2, pg_num=64):
    """An 11-wide EC pool on ``hosts`` straw2 hosts: tight enough that
    the first rung flags lanes and deeper rungs run."""
    b = CrushBuilder(tunables=Tunables(**JEWEL))
    b.add_type(1, "host")
    b.add_type(10, "root")
    ids = [b.add_bucket("straw2", "host",
                        [h * per_host + i for i in range(per_host)],
                        weights=[0x10000] * per_host, bucket_id=-2 - h,
                        name=f"host{h}") for h in range(hosts)]
    b.add_bucket("straw2", "root", ids, bucket_id=-1, name="default")
    rule = code.create_rule(b, name="ec")
    return OSDMap(crush=b.map, pools={1: PGPool(
        1, pg_num, size=11, min_size=9, crush_rule=rule, erasure=True)},
        device="cpu")


@pytest.fixture
def tracer():
    """A fresh process tracer for the test, the old one put back after."""
    tr = SpanTracer()
    prev = spans.set_global_tracer(tr)
    try:
        yield tr
    finally:
        spans.set_global_tracer(prev)


@pytest.fixture(scope="module")
def code():
    return _rs()


@pytest.fixture(scope="module")
def osdmap(code):
    m = _osdmap(code)
    m.pg_to_up_bulk(1)          # the compiled map and rule, built once
    return m


def _walk(sp):
    yield sp
    for c in sp.children:
        yield from _walk(c)


def _codec_calls(code):
    x = torch.randint(0, 256, (2, 8, 4096), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(5))
    parity = code.encode_chunks_torch(x)
    full = torch.cat([x, parity], dim=1)
    got = code.decode_chunks_torch(full[:, 2:], tuple(range(2, 11)),
                                   (0, 1))
    assert torch.equal(got, x[:, :2])


def test_unarmed_sites_record_nothing(tracer, osdmap, code):
    osdmap.pg_to_up_bulk(1)
    _codec_calls(code)
    assert tracer.totals() == {}
    assert len(tracer.finished) == 0 and tracer.dropped == 0


@contextlib.contextmanager
def _profiled():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        yield


@pytest.mark.parametrize("arm", [_profiled, spans.armed],
                         ids=["profiler", "armed"])
def test_one_call_one_root_with_its_children(tracer, osdmap, arm):
    s0 = global_perf().get("crush_bulk_host_syncs")
    with arm():
        a = time.perf_counter()
        up, primary = osdmap.pg_to_up_bulk(1)
        b = time.perf_counter()
    syncs = global_perf().get("crush_bulk_host_syncs") - s0
    osdmap.pg_to_up_bulk(1)             # disarmed again: not recorded
    assert len(tracer.finished) == 1
    root = tracer.finished[0]
    assert root.name == "osdmap.pg_to_up_bulk"
    assert {c.name for c in root.children} == CHILDREN
    assert [c.name for c in root.children].count("osdmap.overlay") == 2
    rungs = [c for c in root.children if c.name == "crush.rung"]
    assert len(rungs) >= 2, "the map is meant to need a deeper rung"
    assert rungs[0].attrs == {"tries": rungs[0].attrs["tries"],
                              "lanes": 64}
    assert all(0 < r.attrs["lanes"] < 64 for r in rungs[1:])
    for sp in _walk(root):
        assert a <= sp.start <= sp.end <= b
        for c in sp.children:
            assert sp.start <= c.start <= c.end <= sp.end
    totals = tracer.totals()
    assert totals["osdmap.pg_to_up_bulk"]["count"] == 1
    # one helper feeds both counters
    assert syncs > 0
    assert totals["osdmap.pg_to_up_bulk"]["counts"]["host_syncs"] == syncs
    assert totals["crush.sync"]["counts"]["host_syncs"] == syncs
    assert totals["crush.sync"]["count"] == syncs
    residue = totals["crush.host_residue"]["counts"]["residue_lanes"]
    assert residue == osdmap._compiled_map().last_residue.size
    # the answer is the unarmed one
    up0, primary0 = osdmap.pg_to_up_bulk(1)
    assert np.array_equal(up, up0) and np.array_equal(primary, primary0)
    assert tracer.totals()["osdmap.pg_to_up_bulk"]["count"] == 1


def test_self_seconds_sum_as_defined(tracer, osdmap, code):
    with spans.armed():
        osdmap.pg_to_up_bulk(1)
        osdmap.pg_to_up_bulk(1)
        _codec_calls(code)
    roots = list(tracer.finished)
    assert [r.name for r in roots] == ["osdmap.pg_to_up_bulk"] * 2 + [
        "codec.encode", "codec.decode"]
    want: dict = {}
    for root in roots:
        for sp in _walk(root):
            covered = sum(c.duration for c in sp.children)
            t = want.setdefault(sp.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += sp.duration
            t[2] += sp.duration - covered
    totals = tracer.totals()
    assert set(totals) == set(want)
    for name, (count, secs, self_s) in want.items():
        assert totals[name]["count"] == count
        assert totals[name]["seconds"] == pytest.approx(secs, abs=1e-9)
        assert totals[name]["self_seconds"] == pytest.approx(self_s,
                                                             abs=1e-9)
        assert totals[name]["self_seconds"] >= 0
    assert totals["engine.dispatch"]["count"] == 2
    assert totals["codec.encode"]["counts"] == {}
    tracer.reset()
    assert tracer.totals() == {} and len(tracer.finished) == 0


def test_counts_roll_up_on_an_injected_clock(tracer):
    clock = FakeClock()
    tracer.clock = clock
    spans.note("host_syncs")            # nothing open: no effect
    with spans.child("crush.sync"):     # no armed root: a no-op
        spans.note("host_syncs")
    assert tracer.totals() == {}
    with spans.armed():
        with spans.root("r", k=1) as r:
            clock.now += 1.0
            with spans.child("a"):
                clock.now += 2.0
                with spans.child("b"):
                    spans.note("host_syncs", 3)
                    clock.now += 4.0
                spans.note("host_syncs")
            with spans.root("c"):       # a root inside a root: a child
                clock.now += 0.5
    assert r.attrs == {"k": 1}
    t = tracer.totals()
    assert t["r"] == {"count": 1, "seconds": 7.5, "self_seconds": 1.0,
                      "counts": {"host_syncs": 4}}
    assert t["a"] == {"count": 1, "seconds": 6.0, "self_seconds": 2.0,
                      "counts": {"host_syncs": 4}}
    assert t["b"]["counts"] == {"host_syncs": 3}
    assert t["c"]["self_seconds"] == 0.5
    assert [s.name for s in tracer.finished] == ["r"]
    assert tracer.to_dict()["spans"][0]["counts"] == {"host_syncs": 4}


def test_armed_roots_evict_with_a_plain_count():
    tr = SpanTracer(clock=FakeClock(), max_roots=2)
    prev = spans.set_global_tracer(tr)
    try:
        with spans.armed():
            for _ in range(5):
                with spans.root("x"):
                    pass
    finally:
        spans.set_global_tracer(prev)
    assert len(tr.finished) == 2 and tr.dropped == 3
    assert tr.totals()["x"]["count"] == 5


def test_serving_spans_record_unarmed(tracer):
    """The serving plane's spans keep today's rule: they record whenever
    the metrics plane is on, armed or not, and add no totals."""
    with tracer.span("serve.batch"):
        with tracer.span("serve.dispatch"):
            pass
    assert [s.name for s in tracer.finished] == ["serve.batch"]
    assert tracer.finished[0].children[0].name == "serve.dispatch"
    assert tracer.totals() == {}


def test_span_debug_stream_at_level_20(tracer):
    """SpanTracer.span streams enter/exit at level 20 and builds nothing
    below it; the armed hot-path spans never stream."""
    buf = io.StringIO()
    log.set_stream(buf)
    prev = log.get_level("telemetry")
    try:
        log.set_level("telemetry", 20)
        with tracer.span("serve.batch"):
            with spans.armed(), spans.root("codec.encode"):
                pass
        log.set_level("telemetry", 1)
        with tracer.span("serve.dispatch"):
            pass
    finally:
        log.set_level("telemetry", prev)
        log.set_stream(None)
    lines = buf.getvalue().splitlines()
    assert [ln.split("telemetry: ")[1].split(" dur=")[0]
            for ln in lines] == ["span+ serve.batch", "span- serve.batch"]
    assert tracer.finished[0].children[0].name == "codec.encode"
