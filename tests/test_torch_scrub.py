"""The port's deep scrub → repair → remap pipeline (``ceph_tpu_torch.scrub``)
against the reference's (``ceph_tpu.scrub``) on the same seeded objects
and faults: the cases of ``tests/test_scrub.py`` (classification,
retries on a FakeClock, repair gates, structured UnrecoverableError with
its extents, degraded reads, OSD feedback), the batched repair of
``tests/test_scrub_batched.py`` over the five families (jerasure
reed_sol_van and cauchy_good, isa, shec, lrc, clay) on both branches —
``device=None``, the fused call on the code's device (here the CPU, the
plain torch tier), and ``device=False``, the grouped host path — and a
seeded slice of ``tests/test_scrub_fuzz.py``.  Reports, healed bytes,
error texts and counts must be equal: tolerance 0.

The reference runs as its own tests run it on the CPU; its clay device
path is compiled once per pattern (seconds each), so clay's ``device=None``
case compares with the reference's host path, whose bytes are the same
by the reference's own contract.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

N_STRIPES = 4


def world(name: str) -> SimpleNamespace:
    mods = {"chaos": "chaos", "stripe": "codes.stripe", "scrub": "scrub",
            "registry": "codes.registry", "engine": "codes.engine",
            "crush": "crush", "osdmap": "crush.osdmap",
            "types": "crush.types", "inc": "crush.incremental",
            "retry": "utils.retry", "errors": "utils.errors",
            "fallback": "ops.fallback"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def plain(x):
    """Reports as plain values: dataclasses to (name, fields), enums to
    their value, tuples to lists, bytearrays to bytes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, bytearray):
        return bytes(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def error(e) -> tuple:
    """A raised scrub error as plain values."""
    return (type(e).__name__, str(e), list(getattr(e, "shards", ())),
            [list(x) for x in getattr(e, "extents", ())],
            None if e.__cause__ is None else str(e.__cause__))


def outcome(fn):
    """fn()'s plain result, or the plain error it raised."""
    try:
        return ("ok", plain(fn()))
    except (PORT.errors.CephTpuError, REF.errors.CephTpuError) as e:
        return ("raised", error(e))


def both(fn):
    """``fn(W)`` on the port and on the reference; the plain results
    must be equal.  Returns the port's."""
    got, want = plain(fn(PORT)), plain(fn(REF))
    assert got == want
    return got


def code(W, plugin, profile):
    """A plugin instance: the port's on the CPU (the caller asks)."""
    kw = {"device": "cpu"} if W is PORT else {}
    return W.registry.ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), **kw)


RS = ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"})


def make_object(W, stripes=N_STRIPES, seed=0, size=1024, prof=RS):
    ec = code(W, *prof)
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(k * size)
    sinfo = W.stripe.StripeInfo(k, width)
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, 256, size=width * stripes,
                       dtype=np.uint8).tobytes()
    shards = W.stripe.encode(sinfo, ec, obj)
    hinfo = W.stripe.HashInfo(ec.get_chunk_count())
    hinfo.append(0, shards)
    return ec, sinfo, obj, shards, hinfo


# -- deep scrub (tests/test_scrub.py) -----------------------------------------

SCRUBS = {
    "clean": (lambda C: [], 1, {}),
    "every_fault_kind": (lambda C: [C.ShardErasure(shards=[0]),
                                    C.BitFlip(shards=[2], flips=1),
                                    C.Truncate(shard=4, keep=17)], 5, {}),
    "transient_retried": (lambda C: [C.TransientErrors(shards=[1],
                                                       count=2)], 6,
                          {"attempts": 4}),
    "transient_exhausted": (lambda C: [C.TransientErrors(shards=[3],
                                                         count=10)], 7,
                            {"attempts": 2}),
    "zero_stripe": (lambda C: [C.ZeroStripe(stripe=1)], 15, {}),
}


@pytest.mark.parametrize("case", sorted(SCRUBS))
def test_deep_scrub_equals_reference(case):
    """The verdicts (state, expected and actual crc, length, error text),
    the retried shards and the FakeClock's sleeps are the reference's."""
    injectors, seed, policy = SCRUBS[case]

    def run(W):
        ec, sinfo, _, shards, hinfo = make_object(W)
        store, faults = W.chaos.inject(shards, injectors(W.chaos),
                                       seed=seed,
                                       chunk_size=sinfo.chunk_size)
        clock = W.retry.FakeClock()
        rep = W.scrub.deep_scrub(
            sinfo, ec, store, hinfo, clock=clock,
            retry_policy=W.retry.RetryPolicy(**policy) if policy else None)
        return plain(rep), rep.bad, clock.sleeps, plain(faults)

    rep, bad, sleeps, _ = both(run)
    want = {"clean": [], "every_fault_kind": [0, 2, 4],
            "transient_retried": [], "transient_exhausted": [3],
            "zero_stripe": list(range(6))}[case]
    assert bad == want
    if case == "transient_retried":
        assert sleeps == [0.01, 0.02]


REPAIRS = {
    "mixed_faults": (lambda C: [C.ShardErasure(shards=[5]),
                                C.BitFlip(shards=[1], flips=3)], 8),
    "full_budget": (lambda C: [C.ShardErasure(shards=[0]),
                               C.Truncate(shard=3, keep=0)], 9),
    "clean_noop": (lambda C: [], 1),
    "over_budget": (lambda C: [C.ShardErasure(shards=[0, 1]),
                               C.BitFlip(shards=[2], flips=1)], 10),
    "zero_stripe": (lambda C: [C.ZeroStripe(stripe=1)], 15),
}


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_repair_equals_reference(case):
    """repair's report (rebuilt bytes, both gates) or its structured
    error (shards, merged extents, message) and the store after it are
    the reference's; a repairable object heals byte for byte."""
    injectors, seed = REPAIRS[case]

    def run(W):
        ec, sinfo, _, shards, hinfo = make_object(W)
        store, _ = W.chaos.inject(shards, injectors(W.chaos), seed=seed,
                                  chunk_size=sinfo.chunk_size)
        res = outcome(lambda: W.scrub.repair(sinfo, ec, store, hinfo))
        healed = store.snapshot() == shards
        scrubbed = W.scrub.deep_scrub(sinfo, ec, store, hinfo).is_clean
        return res, healed, scrubbed, store.snapshot()

    res, healed, scrubbed, _ = both(run)
    if case in ("over_budget", "zero_stripe"):
        assert res[0] == "raised" and res[1][0] == "UnrecoverableError"
        assert not healed
    else:
        assert res[0] == "ok" and healed and scrubbed


def test_over_budget_extents_cover_the_lost_data_chunks():
    ec, sinfo, _, shards, hinfo = make_object(PORT)
    store, _ = PORT.chaos.inject(
        shards, [PORT.chaos.ShardErasure(shards=[0, 1]),
                 PORT.chaos.BitFlip(shards=[2], flips=1)], seed=10,
        chunk_size=sinfo.chunk_size)
    with pytest.raises(PORT.errors.UnrecoverableError) as ei:
        PORT.scrub.repair(sinfo, ec, store, hinfo)
    cs, width = sinfo.chunk_size, sinfo.stripe_width
    assert ei.value.shards == (0, 1, 2)
    assert ei.value.extents == tuple((s * width, 3 * cs)
                                     for s in range(N_STRIPES))
    assert 0 not in store.shards and 1 not in store.shards


def test_repair_refuses_on_stale_hashinfo():
    def run(W):
        ec, sinfo, _, shards, hinfo = make_object(W)
        bad = W.stripe.HashInfo(6)
        bad.append(0, shards)
        bad.cumulative_shard_hashes[3] ^= 0x1
        store, _ = W.chaos.inject(shards, [W.chaos.ShardErasure(shards=[0])],
                                  seed=11, chunk_size=sinfo.chunk_size)
        return outcome(lambda: W.scrub.repair(sinfo, ec, store, bad))

    res = both(run)
    assert res[0] == "raised" and res[1][0] == "ScrubError"


@pytest.mark.parametrize("bad,window", [([4, 5], None), ([0, 3], None),
                                        ([1, 2], (1000, 9000)),
                                        ([0, 1, 2], (0, 4096))])
def test_unrecoverable_extents_equal_reference(bad, window):
    def run(W):
        ec, sinfo, *_ = make_object(W)
        return W.scrub.unrecoverable_extents(sinfo, ec, bad, N_STRIPES,
                                             window=window)

    ext = both(run)
    assert (not ext) == (bad == [4, 5])


@pytest.mark.parametrize("case", ["under_budget", "over_budget"])
def test_read_degraded_equals_reference(case):
    faults = {"under_budget": (lambda C: [C.ShardErasure(shards=[2]),
                                          C.BitFlip(shards=[0],
                                                    flips=1)], 12),
              "over_budget": (lambda C: [C.ShardErasure(shards=[0, 1]),
                                         C.BitFlip(shards=[2],
                                                   flips=1)], 13)}[case]

    def run(W):
        ec, sinfo, obj, shards, hinfo = make_object(W)
        store, _ = W.chaos.inject(shards, faults[0](W.chaos), seed=faults[1],
                                  chunk_size=sinfo.chunk_size)
        off, ln = (100, 6000) if case == "under_budget" else \
            (0, sinfo.stripe_width)
        res = outcome(lambda: W.scrub.read_degraded(sinfo, ec, store,
                                                    hinfo, off, ln))
        return res, obj[off:off + ln]

    res, want = both(run)
    if case == "under_budget":
        assert res == ["ok", want]
    else:
        assert res[0] == "raised"


def build_cluster(W, n_hosts=8, devs=2, size=6):
    C = W.crush
    b = C.CrushBuilder()
    root = b.build_two_level(n_hosts, devs)
    b.add_rule(0, [C.step_take(root),
                   C.step_chooseleaf_indep(size, b.type_id("host")),
                   C.step_emit()])
    m = W.osdmap.OSDMap(crush=b.map)
    if W is PORT:
        m.device = "cpu"
    m.pools[2] = W.osdmap.PGPool(pool_id=2, pg_num=16, size=size,
                                 erasure=True)
    return m


def test_osd_feedback_marks_and_remaps():
    def run(W):
        m = build_cluster(W)
        _, _, acting, _ = m.pg_to_up_acting_osds(2, 3)
        remap = W.scrub.apply_osd_feedback(m, 2, 3, acting,
                                           bad_shards=[1, 4])
        return plain(remap), remap.moved, acting, \
            [(m.is_up(o), m.is_out(o)) for o in remap.marked_osds]

    remap, moved, acting, marks = both(run)
    assert remap[1]["marked_osds"] == [acting[1], acting[4]]
    assert marks == [[False, True], [False, True]]
    assert {1, 4} <= set(moved)


@pytest.mark.parametrize("faulty", [True, False])
def test_scrub_and_repair_closes_the_loop(faulty):
    def run(W):
        ec, sinfo, obj, shards, hinfo = make_object(W)
        m = build_cluster(W)
        _, _, acting, _ = m.pg_to_up_acting_osds(2, 5)
        inj = [W.chaos.ShardErasure(shards=[3]),
               W.chaos.BitFlip(shards=[5], flips=1)] if faulty else []
        store, _ = W.chaos.inject(shards, inj, seed=14,
                                  chunk_size=sinfo.chunk_size)
        rep, remap = W.scrub.scrub_and_repair(
            sinfo, ec, store, hinfo, osdmap=m, pool_id=2, ps=5,
            acting=acting)
        back = W.scrub.read_degraded(sinfo, ec, store, hinfo, 0, len(obj))
        return plain(rep), plain(remap), store.snapshot() == shards, \
            back == obj

    rep, remap, healed, readable = both(run)
    assert healed and readable
    assert (remap is None) == (not faulty)


# -- batched repair over the five families ------------------------------------

FAMILIES = {
    "rs": RS,
    "cauchy_good": ("jerasure", {"technique": "cauchy_good", "k": "4",
                                 "m": "2", "packetsize": "32"}),
    "isa": ("isa", {"k": "4", "m": "2"}),
    "shec": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "lrc": ("lrc", {"k": "4", "m": "2", "l": "3"}),
    "clay": ("clay", {"k": "4", "m": "2", "d": "5"}),
}
# (erased, bit-flipped) per object: 3 distinct patterns and a clean one
FAULTS = {
    "default": [([1], []), ([0, 4], []), ([1], []), ([], [2]), ([], []),
                ([0, 4], [])],
    # lrc k=4 m=2 l=3 has 8 chunks in two local groups: one loss per
    # group and a parity loss
    "lrc": [([2], []), ([3], []), ([2], []), ([], [6]), ([], []),
            ([2, 6], [])],
    # shec k=4 m=3 c=2: patterns inside its recovery budget
    "shec": [([1], []), ([0, 5], []), ([1], []), ([], [3]), ([], []),
             ([0, 5], [])],
}


def make_objects(W, count, prof, stripes=2, size=512, seed=0):
    ec = code(W, *prof)
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(k * size)
    sinfo = W.stripe.StripeInfo(k, width)
    rng = np.random.default_rng(seed)
    objs = []
    for _ in range(count):
        obj = rng.integers(0, 256, size=width * stripes,
                           dtype=np.uint8).tobytes()
        shards = W.stripe.encode(sinfo, ec, obj)
        hinfo = W.stripe.HashInfo(ec.get_chunk_count())
        hinfo.append(0, shards)
        objs.append((shards, hinfo))
    return ec, sinfo, objs


def faulted_stores(W, sinfo, objs, faults, seed=100):
    stores = []
    for i, (shards, _) in enumerate(objs):
        erased, flipped = faults[i]
        inj = []
        if erased:
            inj.append(W.chaos.ShardErasure(shards=list(erased)))
        if flipped:
            inj.append(W.chaos.BitFlip(shards=list(flipped), flips=1))
        st, _ = W.chaos.inject(shards, inj, seed=seed + i,
                               chunk_size=sinfo.chunk_size)
        stores.append(st)
    return stores


def _batched(W, family, device, **kw):
    faults = FAULTS.get(family, FAULTS["default"])
    ec, sinfo, objs = make_objects(W, len(faults), FAMILIES[family])
    hinfos = [h for _, h in objs]
    stores = faulted_stores(W, sinfo, objs, faults)
    rep = W.scrub.repair_batched(sinfo, ec, stores, hinfos, device=device,
                                 **kw)
    healed = [st.snapshot() == {s: bytes(b) for s, b in sh.items()}
              for st, (sh, _) in zip(stores, objs)]
    return rep, healed, [st.snapshot() for st in stores]


@pytest.mark.parametrize("device", [None, False], ids=["device", "host"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_repair_equals_reference(family, device):
    """Every family heals byte for byte on both branches, one call per
    erasure pattern, and its report — per-object RepairReports with the
    rebuilt bytes, pattern batches, device calls, host batches — is the
    reference's on the same branch."""
    ref_device = False if family == "clay" else device
    got, healed, snaps = _batched(PORT, family, device)
    want, ref_healed, ref_snaps = _batched(REF, family, ref_device)
    assert all(healed) and all(ref_healed) and snaps == ref_snaps
    assert plain(got.reports) == plain(want.reports)
    faults = FAULTS.get(family, FAULTS["default"])
    patterns = len({tuple(sorted(e + f)) for e, f in faults if e or f})
    assert got.pattern_batches == want.pattern_batches == patterns
    if device is None:
        assert (got.device_calls, got.host_batches) == (patterns, 0)
    else:
        assert (got.device_calls, got.host_batches) == (0, patterns)
    if ref_device == device:
        assert (got.device_calls, got.host_batches, got.regroups,
                got.plan_epoch) == (want.device_calls, want.host_batches,
                                    want.regroups, want.plan_epoch)
    assert sorted(got.repaired_objects) == [0, 1, 2, 3, 5]


def test_batched_repair_one_device_call_per_pattern(monkeypatch):
    """≤1 host→device copy and one fused call per erasure-pattern batch:
    the fused callables are counted, with the shapes of their stacks."""
    calls = []
    real = PORT.engine.fused_repair_call

    def counting(ec, available, erased):
        fn = real(ec, available, erased)

        def call(stack):
            calls.append((tuple(stack.shape), stack.device.type))
            return fn(stack)
        return call

    monkeypatch.setattr(PORT.engine, "fused_repair_call", counting)
    rep, healed, _ = _batched(PORT, "rs", None)
    assert all(healed)
    assert rep.pattern_batches == rep.device_calls == len(calls) == 3
    # 2 objects x 2 stripes, 1 object x 2 stripes, 2 objects x 2 stripes
    assert sorted(c[0][0] for c in calls) == [2, 4, 4]
    assert {c[1] for c in calls} == {"cpu"}


def test_batched_repair_warm_path_builds_nothing():
    cache = PORT.engine.PatternCache()
    prev = PORT.engine.set_global_pattern_cache(cache)
    try:
        _batched(PORT, "rs", None)
        builds = cache.stats()["builds"]
        assert builds > 0
        _batched(PORT, "rs", None)
        after = cache.stats()
        assert after["builds"] == builds and after["hits"] > 0
    finally:
        PORT.engine.set_global_pattern_cache(prev)


def test_batched_repair_unrecoverable_and_no_write_back():
    def run(W):
        ec, sinfo, objs = make_objects(W, 2, RS)
        hinfos = [h for _, h in objs]
        over = faulted_stores(W, sinfo, objs, [([1], []), ([0, 1, 4], [])])
        res = outcome(lambda: W.scrub.repair_batched(sinfo, ec, over,
                                                     hinfos))
        stores = faulted_stores(W, sinfo, objs, [([1], []), ([2], [])])
        before = [s.snapshot() for s in stores]
        rep = W.scrub.repair_batched(sinfo, ec, stores, hinfos,
                                     write_back=False)
        untouched = [s.snapshot() == b for s, b in zip(stores, before)]
        return res, plain(rep.reports), untouched, \
            rep.reports[0].repaired[1] == bytes(objs[0][0][1])

    res, _, untouched, rebuilt = both(run)
    assert res[0] == "raised" and res[1][2] == [0, 1, 4] and res[1][3]
    assert untouched == [True, True] and rebuilt


def test_batched_repair_epoch_fence_regroups():
    """With an OSDMap given, a map epoch that moves between plan and a
    dispatch (the on_batch hook) re-scrubs and regroups; the counts and
    the stamped epoch are the reference's."""
    def run(W):
        m = build_cluster(W)
        seen = []

        def hook(batch_index, key):
            seen.append((batch_index, plain(key)))
            if batch_index == 1:
                W.inc.apply_incremental(m, W.inc.Incremental(
                    epoch=W.inc.get_epoch(m) + 1,
                    new_weight={3: 0x8000}))
        rep, healed, _ = _batched(W, "rs", None, osdmap=m, on_batch=hook)
        return (rep.pattern_batches, rep.device_calls, rep.regroups,
                rep.plan_epoch, seen, healed)

    batches, calls, regroups, epoch, seen, healed = both(run)
    assert all(healed) and regroups == 1 and epoch == 1


def test_device_none_reads_the_static_policy():
    """device=None follows the port's FallbackPolicy: a forced numpy tier
    sends a CPU code's batches to the grouped host path (as the
    reference's numpy tier does); on a code whose device is a card the
    forced tier raises before any repair, and nothing is written."""
    prev = PORT.fallback.set_global_policy(
        PORT.fallback.FallbackPolicy("numpy"))
    try:
        rep, healed, _ = _batched(PORT, "rs", None)
        assert (rep.device_calls, rep.host_batches) == (0, 3)
        assert all(healed)
        ec, sinfo, objs = make_objects(PORT, 2, RS)
        stores = faulted_stores(PORT, sinfo, objs, [([1], []), ([2], [])])
        before = [s.snapshot() for s in stores]
        ec.device = torch.device("cuda")    # as a card instance reads
        with pytest.raises(ValueError, match="forced"):
            PORT.scrub.repair_batched(sinfo, ec, stores,
                                      [h for _, h in objs])
        assert [s.snapshot() for s in stores] == before
    finally:
        PORT.fallback.set_global_policy(prev)


# -- the seeded fuzz slice (tests/test_scrub_fuzz.py) -------------------------

FUZZ_CASES = 8


def _fuzz(W, name, family):
    plugin, profile = FAMILIES[family]
    ec = code(W, plugin, profile)
    k = ec.get_data_chunk_count()
    width = k * ec.get_chunk_size(k * 512)
    sinfo = W.stripe.StripeInfo(k, width)
    rng = np.random.default_rng(0)
    obj = rng.integers(0, 256, size=width * 2, dtype=np.uint8).tobytes()
    shards = W.stripe.encode(sinfo, ec, obj)
    hinfo = W.stripe.HashInfo(ec.get_chunk_count())
    hinfo.append(0, shards)
    n = ec.get_chunk_count()
    m_total = n - k
    policy = W.retry.RetryPolicy(attempts=2 * (m_total + 1) + 1)
    out = []
    for case in range(FUZZ_CASES):
        seed = (zlib.crc32(name.encode()) + 7919 * case) & 0x7FFFFFFF
        rng = np.random.default_rng(seed)
        n_faults = int(rng.integers(1, m_total + 2))
        injectors = W.chaos.random_injectors(
            rng, n_faults,
            allow_kinds=("erase", "bitflip", "truncate", "transient"))
        store, faults = W.chaos.inject(shards, injectors, seed=seed,
                                       chunk_size=sinfo.chunk_size)
        snap = store.snapshot()
        truth = sorted(s for s in range(n) if snap.get(s) != shards[s])
        report = W.scrub.deep_scrub(sinfo, ec, store, hinfo,
                                    retry_policy=policy,
                                    clock=W.retry.FakeClock())
        assert report.bad == truth, (name, case)
        res = outcome(lambda: W.scrub.repair(
            sinfo, ec, store, hinfo, report, retry_policy=policy,
            clock=W.retry.FakeClock()))
        if res[0] == "ok":
            assert store.snapshot() == shards, (name, case)
        else:
            assert res[1][2] == truth, (name, case)
        out.append((plain(faults), plain(report), res))
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_scrub_fuzz_slice_equals_reference(family):
    """Seeded random fault mixes: scrub flags exactly the damaged shards,
    repairable cases heal byte for byte, the rest raise naming exactly
    them — with the reference's faults, verdicts and outcomes."""
    cases = both(lambda W: _fuzz(W, f"torch_{family}", family))
    assert any(r[2][0] == "ok" for r in cases)
