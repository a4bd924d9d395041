"""The port's fault injection (``ceph_tpu_torch.chaos``) and bounded retry
(``ceph_tpu_torch.utils.retry``) against the reference's on the same
seeds: every case of ``tests/test_chaos.py`` run through both packages
(fault lists and store snapshots equal), ``MapChurn`` event logs and
recorded incrementals, ``CrashPoint`` visits, ``Straggler`` schedules,
the ``DispatchFaultPlan`` / ``HostFaultPlan`` firing tables, and
``retry_call`` / ``probe_call`` backoff schedules under a ``FakeClock``.
Exact comparisons.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

CHUNK = 256
N_STRIPES = 4


def world(name: str) -> SimpleNamespace:
    """The chaos, retry, error and crush modules of one package."""
    mods = {"chaos": "chaos", "dispatch": "chaos.dispatch",
            "hosts": "chaos.hosts", "store": "chaos.store",
            "retry": "utils.retry", "errors": "utils.errors",
            "crush": "crush", "osdmap": "crush.osdmap",
            "inc": "crush.incremental"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def plain(x):
    """Dataclasses, tuples and bytearrays as plain comparable values
    (the two packages' dataclasses are different types)."""
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
    """``fn(W)`` on the port and on the reference; asserts the two
    results are equal and returns the port's."""
    got, want = plain(fn(PORT)), plain(fn(REF))
    assert got == want
    return got


def make_shards(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return {s: rng.integers(0, 256, size=CHUNK * N_STRIPES,
                            dtype=np.uint8).tobytes()
            for s in range(n)}


# -- the injectors (tests/test_chaos.py) ---------------------------------------

def _injected(W, injectors, seed, chunk_size=None):
    store, faults = W.chaos.inject(make_shards(), injectors(W), seed=seed,
                                   chunk_size=chunk_size)
    return faults, store.snapshot(), store.shard_ids()


INJECTIONS = {
    "erase": (lambda W: [W.chaos.ShardErasure(shards=[3])], 1, None),
    "bitflip": (lambda W: [W.chaos.BitFlip(shards=[2], flips=1)], 2, None),
    "bitflip_random": (lambda W: [W.chaos.BitFlip(n=3, flips=4)], 21, None),
    "bitflip_pinned": (lambda W: [W.chaos.BitFlip(shards=[1],
                                                  offsets=[0, 77])], 22,
                       None),
    "truncate": (lambda W: [W.chaos.Truncate(shard=1, keep=100)], 3, None),
    "truncate_random": (lambda W: [W.chaos.Truncate()], 31, None),
    "zero_stripe": (lambda W: [W.chaos.ZeroStripe(stripe=2)], 4, CHUNK),
    "zero_stripe_random": (lambda W: [W.chaos.ZeroStripe()], 41, CHUNK),
    "transient": (lambda W: [W.chaos.TransientErrors(shards=[4], count=2)],
                  5, None),
    "torn_write": (lambda W: [W.chaos.TornWrite(n=2)], 51, CHUNK),
    "mixed": (lambda W: [W.chaos.ShardErasure(n=1),
                         W.chaos.BitFlip(n=2, flips=2),
                         W.chaos.Truncate()], 77, None),
    "compose": (lambda W: [W.chaos.Compose((
        W.chaos.ShardErasure(shards=[0]),
        W.chaos.Truncate(shard=1, keep=8)))], 6, None),
}


@pytest.mark.parametrize("case", sorted(INJECTIONS))
def test_injection_equals_reference(case):
    """The same injectors and seed give the same fault list and the same
    damaged bytes in both packages."""
    injectors, seed, chunk = INJECTIONS[case]
    faults, snap, ids = both(lambda W: _injected(W, injectors, seed, chunk))
    assert faults


def test_erasure_deletes_exactly_the_target():
    store, faults = PORT.chaos.inject(
        make_shards(), [PORT.chaos.ShardErasure(shards=[3])], seed=1)
    assert store.shard_ids() == [0, 1, 2, 4, 5]
    assert [(f.kind, f.shard) for f in faults] == [("erase", 3)]


def test_bitflip_changes_exactly_one_bit():
    shards = make_shards()
    store, faults = PORT.chaos.inject(
        shards, [PORT.chaos.BitFlip(shards=[2], flips=1)], seed=2)
    (f,) = faults
    assert f.kind == "bitflip" and f.shard == 2
    diff = (np.frombuffer(shards[2], np.uint8)
            ^ np.frombuffer(store.read(2), np.uint8))
    assert int(np.unpackbits(diff).sum()) == 1
    assert int(np.nonzero(diff)[0][0]) == f.offset
    for s in (0, 1, 3, 4, 5):
        assert store.read(s) == shards[s]


def test_zero_stripe_zeroes_one_chunk_of_every_shard():
    shards = make_shards()
    store, faults = PORT.chaos.inject(
        shards, [PORT.chaos.ZeroStripe(stripe=2)], seed=4, chunk_size=CHUNK)
    assert len(faults) == len(shards)
    for s, orig in shards.items():
        got = store.read(s)
        assert got[2 * CHUNK:3 * CHUNK] == b"\x00" * CHUNK
        assert got[:2 * CHUNK] == orig[:2 * CHUNK]
        assert got[3 * CHUNK:] == orig[3 * CHUNK:]


def test_zero_stripe_requires_chunk_size():
    store = PORT.store.ShardStore(make_shards())
    with pytest.raises(ValueError):
        PORT.chaos.ZeroStripe(stripe=0).apply(store,
                                              np.random.default_rng(0))


def test_transient_errors_then_clean_reads():
    def run(W):
        shards = make_shards()
        store, faults = W.chaos.inject(
            shards, [W.chaos.TransientErrors(shards=[4], count=2)], seed=5)
        errors = []
        for _ in range(2):
            with pytest.raises(W.errors.TransientBackendError) as ei:
                store.read(4)
            errors.append(str(ei.value))
        return (faults, errors, store.read(4) == shards[4],
                store.transient_failures, faults[0].damages_data)

    faults, errors, intact, failures, damages = both(run)
    assert intact and failures == 2 and not damages


def test_torn_write_truncates_the_next_write():
    def run(W):
        store = W.store.ShardStore(make_shards(), chunk_size=CHUNK)
        W.chaos.TornWrite(shards=[1], keep=5).apply(
            store, np.random.default_rng(0))
        store.write(1, b"x" * 64)
        first = bytes(store.shards[1])
        store.write(1, b"y" * 64)
        return first, bytes(store.shards[1])

    first, second = both(run)
    assert first == b"x" * 5 and second == b"y" * 64


def test_seed_determinism_and_divergence():
    def run(W):
        injectors = [W.chaos.ShardErasure(n=1), W.chaos.BitFlip(n=2, flips=2),
                     W.chaos.Truncate()]
        s1, f1 = W.chaos.inject(make_shards(), injectors, seed=77)
        s2, f2 = W.chaos.inject(make_shards(), injectors, seed=77)
        s3, _ = W.chaos.inject(make_shards(), injectors, seed=78)
        return (f1 == f2, s1.snapshot() == s2.snapshot(),
                s3.snapshot() != s1.snapshot())

    assert both(run) == [True, True, True]


def test_damaged_shards_excludes_transient():
    def run(W):
        _, faults = W.chaos.inject(
            make_shards(), [W.chaos.ShardErasure(shards=[5]),
                            W.chaos.TransientErrors(shards=[1], count=1)],
            seed=8)
        return W.chaos.damaged_shards(faults)

    assert both(run) == [5]


@pytest.mark.parametrize("seed", [123, 7, 2026])
def test_random_injectors_equal_reference(seed):
    """The fuzz generator draws the same injectors from the same rng,
    and they damage the same bytes."""
    def run(W):
        rng = np.random.default_rng(seed)
        injs = W.chaos.random_injectors(
            rng, 4, allow_kinds=("erase", "bitflip", "truncate",
                                 "zero_stripe", "transient"))
        store, faults = W.chaos.inject(make_shards(), injs, seed=seed,
                                       chunk_size=CHUNK)
        return injs, faults, store.snapshot()

    injs, faults, _ = both(run)
    assert len(faults) >= 1


def test_ensure_store_reuses_and_wraps():
    def run(W):
        st = W.store.ShardStore(make_shards(), chunk_size=CHUNK)
        same = W.store.ensure_store(st) is st
        wrapped = W.store.ensure_store(make_shards(), chunk_size=CHUNK)
        with pytest.raises(KeyError):
            wrapped.read(9)
        wrapped.delete(0)
        return same, wrapped.shard_ids(), wrapped.chunk_size

    assert both(run)[0] is True


# -- the adversaries -------------------------------------------------------------

def _cluster(W, n_hosts=9, devs=2, size=6):
    b = W.crush.CrushBuilder()
    root = b.build_two_level(n_hosts, devs)
    b.add_rule(0, [W.crush.step_take(root),
                   W.crush.step_chooseleaf_indep(size, b.type_id("host")),
                   W.crush.step_emit()])
    m = W.osdmap.OSDMap(crush=b.map)
    if W is PORT:
        m.device = "cpu"
    m.pools[1] = W.osdmap.PGPool(pool_id=1, pg_num=16, size=size,
                                 erasure=True)
    return m


def _churn_log(W, churn, steps, stages=("plan", "dispatch", "writeback")):
    m = _cluster(W)
    for i in range(steps):
        churn.step(m, stages[i % len(stages)])
    placements = [m.pg_to_up_acting_osds(1, ps) for ps in range(16)]
    return (churn.events, churn.incrementals, churn.downed,
            churn.epochs_advanced, W.inc.get_epoch(m), m.osd_weight,
            m.osd_up, placements, churn.scan_fallbacks)


@pytest.mark.parametrize("kw", [
    dict(seed=11, max_down=2, p_fire=1.0, max_events=6),
    dict(seed=3, max_down=1, fire_every=2, stages=("dispatch",)),
    dict(seed=5, max_down=1, p_fire=1.0, avoid_osds=(0, 1, 2)),
    dict(seed=9, max_down=3, p_fire=0.4, max_events=12),
    # the wide-map probe path (victims by seeded probes, not a scan)
    dict(seed=4, max_down=2, p_fire=0.7, scan_limit=4),
])
def test_mapchurn_event_log_equals_reference(kw):
    """MapChurn replays from (seed, params): the same events, the same
    incrementals, and the same placements after them, in both packages."""
    events, incs, downed, advanced, epoch, *_ = both(
        lambda W: _churn_log(W, W.chaos.MapChurn(**kw), 40))
    assert advanced == epoch == len(events) > 0
    if "avoid_osds" in kw:
        for ev in events:
            if ev["kind"] == "down":
                osd = int(ev["detail"].split(".")[1].split()[0])
                assert osd not in kw["avoid_osds"]
    assert len(downed) <= kw["max_down"]


def test_mapchurn_replays_deterministically():
    logs = [_churn_log(PORT, PORT.chaos.MapChurn(seed=11, max_down=2,
                                                 p_fire=1.0, max_events=6),
                       10) for _ in range(2)]
    assert plain(logs[0]) == plain(logs[1])
    assert len(logs[0][0]) == 6


@pytest.mark.parametrize("site", [None, "plan.after_scrub",
                                  "writeback.after_write"])
def test_crashpoint_visits_equal_reference(site):
    """CrashPoint fires once at its site's at_hit-th visit, then
    disarms; the hits table and the error text match the reference's."""
    def run(W):
        cp = W.chaos.CrashPoint(site=site, at_hit=2)
        raised = []
        for _ in range(3):
            for s in W.chaos.CRASH_SITES:
                try:
                    cp.visit(s)
                except W.errors.InjectedCrash as e:
                    raised.append((str(e), e.site, e.hit))
        return cp.hits, cp.fired, raised

    hits, fired, raised = both(run)
    assert fired == (site is not None)
    assert len(raised) == (1 if site else 0)
    assert PORT.chaos.CRASH_SITES == REF.chaos.CRASH_SITES


def test_straggler_schedule_equals_reference():
    def run(W):
        st = W.chaos.Straggler(seed=7, slow={0: 10.0, 3: 2.5}, jitter=0.2)
        return [st.service_time(s, u, work=1.5)
                for s in range(6) for u in range(4)]

    times = both(run)
    assert len(set(times)) > 1


# -- dispatch and host fault plans (host state machines) ---------------------

def _dispatch_table(W):
    D = W.dispatch
    faults = [D.DispatchFault("transient", seam="engine.fused_repair",
                              at=2, calls=2),
              D.DispatchFault("oom", seam="serve.dispatch", at=1),
              D.DispatchFault("corrupt", at=5, calls=3),
              D.DispatchFault("backend_loss", seam="ops.apply", at=3,
                              calls=None)]
    out = []
    with D.dispatch_faults(faults, seed=13) as plan:
        assert D.active_plan() is plan
        for i in range(8):
            for seam in ("engine.fused_repair", "serve.dispatch",
                         "ops.apply"):
                peek = plan.active(seam)
                f = plan.poll(seam)
                row = (seam, i, None if f is None else f.kind,
                       None if peek is None else peek.kind,
                       plan.pending_persistent())
                if f is not None and f.kind == "corrupt":
                    buf = np.arange(64, dtype=np.uint8).reshape(4, 16)
                    row += (plan.corrupt_output(f, seam, buf).tobytes(),)
                out.append(row)
        plan.clear()
        out.append((plan.poll("ops.apply"), plan.pending_persistent()))
        summary = plan.summary()
        fired = plan.fired
    assert D.active_plan() is None
    return out, summary, fired, [f.to_dict() for f in faults]


def test_dispatch_fault_plan_firing_table_equals_reference():
    table, summary, fired, _ = both(_dispatch_table)
    kinds = {row[2] for row in table[:-1]}
    assert {"transient", "oom", "corrupt", "backend_loss"} <= kinds
    assert summary["cleared"] and summary["fired"] == len(fired)


def test_dispatch_fault_validation_and_errors():
    def run(W):
        D = W.dispatch
        msgs = []
        for kw in (dict(kind="melt"), dict(kind="oom", at=0),
                   dict(kind="oom", calls=0)):
            with pytest.raises(ValueError) as ei:
                D.DispatchFault(**kw)
            msgs.append(str(ei.value))
        msgs.append(str(D.InjectedOom("engine.fused_repair")))
        return msgs, D.DISPATCH_FAULT_KINDS

    both(run)


def test_corrupt_output_copies_a_tensor_to_the_host():
    """The port's corrupt fault takes a tensor (any device) as well as
    an array, and flips the same bit as on the array."""
    import torch
    D = PORT.dispatch
    buf = np.arange(64, dtype=np.uint8)
    outs = []
    for value in (buf, torch.from_numpy(buf.copy())):
        plan = D.DispatchFaultPlan([D.DispatchFault("corrupt")], seed=3)
        f = plan.poll("s")
        outs.append(plan.corrupt_output(f, "s", (value, value))[0])
    assert np.array_equal(outs[0], outs[1])
    assert int(np.unpackbits(outs[0] ^ buf).sum()) == 1


def _host_table(W):
    H = W.hosts
    faults = [H.HostLoss(1, seam="plane.dispatch", at=2, calls=3),
              H.HostFlap(0, at=1, calls=2, up_calls=1, cycles=2),
              H.HostPartition(2, seam="serve", at=4)]
    out = []
    plan = H.HostFaultPlan(faults, seed=5)
    with H.host_faults(plan):
        assert H.active_host_plan() is plan
        for i in range(10):
            for seam in ("plane.dispatch", "serve"):
                hosts = 4 if i < 6 else 1
                peek = plan.active(seam, hosts)
                f = plan.poll(seam, hosts)
                out.append((seam, i, None if f is None else
                            (f.kind, f.host),
                            None if peek is None else peek.kind,
                            plan.down_hosts(hosts),
                            plan.pending_persistent()))
        plan.clear()
        out.append((plan.poll("serve", 4), plan.pending_persistent()))
    assert H.active_host_plan() is None
    return out, plan.summary(), plan.fired


def test_host_fault_plan_firing_table_equals_reference():
    table, summary, fired = both(_host_table)
    assert len(fired) > 0


def test_host_chaos_selftest_names_its_items():
    """The selftest runs (the data plane is ported): with no virtual
    members the planeless arc — a demotion to the twin, healed."""
    st = PORT.hosts.host_chaos_selftest()
    assert st["multi_host"] is False
    assert st["demotions"] >= 1 and st["host_completions"] >= 1
    assert not st["demoted"] and st["plan"]["fired"] >= 1


# -- bounded retry under a FakeClock (the reference's tests/test_retry.py) ----

class _Flaky:
    """Raises ``errors`` (TransientBackendError by default) for the
    first ``n`` calls, then returns ``n``."""

    def __init__(self, W, n, exc=None):
        self.W, self.n, self.calls = W, n, 0
        self.exc = exc or W.errors.TransientBackendError

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.calls <= self.n:
            raise self.exc(f"flake {self.calls}")
        return (self.n, args, tuple(sorted(kw.items())))


RETRY_CASES = {
    "recovers": (2, dict(attempts=4)),
    "capped": (5, dict(attempts=6, base_delay=0.5, multiplier=3.0,
                       max_delay=1.0)),
    "exhausted": (9, dict(attempts=3)),
    "deadline": (9, dict(attempts=10, base_delay=0.4, deadline=1.0)),
    "deadline_fits": (3, dict(attempts=10, base_delay=0.1, deadline=5.0)),
    "jitter_seeded": (6, dict(attempts=8, base_delay=0.05, max_delay=2.0,
                              jitter="decorrelated")),
    "jitter_unseeded": (6, dict(attempts=8, base_delay=0.05,
                                max_delay=2.0, jitter="decorrelated")),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_schedule_equals_reference(case):
    """retry_call sleeps the same amounts on a FakeClock, reports the same
    stats and raises the same RetryExhausted text as the reference; the
    decorrelated jitter draws from the same seeded (or fixed-fallback)
    rng."""
    import random
    fails, kw = RETRY_CASES[case]

    def run(W):
        clock = W.retry.FakeClock()
        stats = W.retry.RetryStats()
        seen = []
        rng = random.Random(99) if case == "jitter_seeded" else None
        try:
            out = W.retry.retry_call(
                _Flaky(W, fails), 1, key="v",
                policy=W.retry.RetryPolicy(**kw), clock=clock,
                on_retry=lambda a, d, e: seen.append((a, d, str(e))),
                stats=stats, rng=rng)
            err = None
        except W.errors.RetryExhausted as e:
            out = None
            err = (str(e), e.attempts, e.elapsed, e.deadline_expired,
                   str(e.last), str(e.__cause__))
        return out, err, clock.sleeps, clock.now, stats, seen

    both(run)


def test_retry_non_retryable_propagates_and_policy_validation():
    def run(W):
        f = _Flaky(W, 3, exc=KeyError)
        with pytest.raises(KeyError):
            W.retry.retry_call(f, policy=W.retry.RetryPolicy(attempts=5),
                               clock=W.retry.FakeClock())
        msgs = [f.calls]
        for kw in (dict(attempts=0), dict(base_delay=-1.0),
                   dict(deadline=0.0), dict(jitter="full")):
            with pytest.raises(ValueError) as ei:
                W.retry.RetryPolicy(**kw)
            msgs.append(str(ei.value))
        return msgs

    assert both(run)[0] == 1


@pytest.mark.parametrize("case", ["answers", "exhausts", "late"])
def test_probe_call_equals_reference(case):
    """probe_call's terminal error is ProbeTimeout, on an exhausted
    schedule and on an answer that came after its deadline."""
    def run(W):
        clock = W.retry.FakeClock()
        if case == "late":
            def fn():
                clock.sleep(2.5)
                return "late"
        else:
            fn = _Flaky(W, 1 if case == "answers" else 9)
        try:
            return ("ok", W.retry.probe_call(fn, target="osd.3",
                                             deadline=2.0, clock=clock),
                    clock.sleeps)
        except W.errors.ProbeTimeout as e:
            return ("timeout", str(e), e.target, e.deadline, e.elapsed,
                    e.deadline_expired, clock.sleeps)

    out = both(run)
    assert out[0] == ("ok" if case == "answers" else "timeout")
