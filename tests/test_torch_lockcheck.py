"""The port's runtime lock-order validator (``ceph_tpu_torch.utils.locks``)
and its rank table (``ceph_tpu_torch.analysis.lockmodel``): the cases of
``tests/test_lockcheck.py``.  Each unit case drives the port's
CheckedLock / CheckedRLock against an explicit LockMonitor on a fake
clock, and the same case through the reference's classes; the reports
must be equal.  The acceptance case runs the seeded dispatch-chaos
family in a subprocess under ``CEPH_TPU_LOCKCHECK=1``: a valid report,
the supervisor's lock among those recorded, zero order violations, zero
blocking events, nothing unregistered, and every runtime edge predicted
by the port's static lock graph (``analysis/concurrency.py``).  Every
``make_lock`` id under ``ceph_tpu_torch/`` must have a rank in the
port's table.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from ceph_tpu.utils import locks as ref_locks
from ceph_tpu_torch.analysis import lockmodel
from ceph_tpu_torch.utils import locks
from ceph_tpu_torch.utils.locks import (
    DEFAULT_BLOCKING_THRESHOLD_S,
    LOCKCHECK_ENV,
    LOCKCHECK_SCHEMA_VERSION,
    CheckedLock,
    CheckedRLock,
    LockMonitor,
    global_monitor,
    lockcheck_enabled,
    lockcheck_report,
    make_lock,
    make_rlock,
    reset_monitor,
    validate_lockcheck_report,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_PKG = REPO_ROOT / "ceph_tpu_torch"


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(case, ranks=None):
    """``case(L, mon)`` with the port's module and with the reference's,
    each on its own monitor (fake clock, ``ranks``); the reports must be
    equal.  Returns the port's."""
    ranks = {"a": 1, "b": 2, "c": 3} if ranks is None else ranks
    docs = []
    for L in (locks, ref_locks):
        mon = L.LockMonitor(clock=Clock(), ranks=ranks)
        case(L, mon)
        doc = mon.report()
        doc.pop("enabled")
        docs.append(doc)
    assert docs[0] == docs[1]
    return docs[0]


# ----------------------------------------------------------------------
# factory gating

def test_make_lock_plain_when_disabled(monkeypatch):
    monkeypatch.delenv(LOCKCHECK_ENV, raising=False)
    assert not lockcheck_enabled()
    assert type(make_lock("utils.locks.test")) is type(threading.Lock())
    assert type(make_rlock("utils.locks.test")) is type(threading.RLock())


def test_make_lock_checked_when_enabled(monkeypatch):
    monkeypatch.setenv(LOCKCHECK_ENV, "1")
    assert lockcheck_enabled()
    lk = make_lock("utils.locks.test")
    assert isinstance(lk, CheckedLock)
    assert lk.name == "utils.locks.test"
    assert isinstance(make_rlock("utils.locks.test"), CheckedRLock)


def test_gate_is_creation_time(monkeypatch):
    monkeypatch.delenv(LOCKCHECK_ENV, raising=False)
    lk = make_lock("utils.locks.test")
    monkeypatch.setenv(LOCKCHECK_ENV, "1")
    assert not isinstance(lk, CheckedLock)


# ----------------------------------------------------------------------
# monitor recording

def test_edges_and_acquisition_counts():
    def case(L, mon):
        a = L.CheckedLock("a", monitor=mon)
        b = L.CheckedLock("b", monitor=mon)
        with a:
            with b:
                pass
        with a:
            pass
    doc = both(case)
    assert doc["edges"] == [["a", "b"]]
    assert doc["locks"]["a"]["acquisitions"] == 2
    assert doc["locks"]["b"]["acquisitions"] == 1
    assert doc["order_violations"] == []


def test_rank_inversion_recorded():
    def case(L, mon):
        a = L.CheckedLock("a", monitor=mon)
        b = L.CheckedLock("b", monitor=mon)
        with b:
            with a:      # rank 1 acquired while rank 2 is held
                pass
    doc = both(case)
    assert ["b", "a"] in doc["edges"]
    [v] = doc["order_violations"]
    assert v["lock"] == "a" and v["held"] == "b"
    assert v["rank"] == 1 and v["held_rank"] == 2


def test_equal_rank_is_a_violation():
    def case(L, mon):
        a = L.CheckedLock("a", monitor=mon)
        b = L.CheckedLock("b", monitor=mon)
        with a:
            with b:
                pass
    assert len(both(case, {"a": 5, "b": 5})["order_violations"]) == 1


def test_unregistered_lock_surfaces():
    def case(L, mon):
        with L.CheckedLock("mystery", monitor=mon):
            pass
    doc = both(case)
    assert doc["unregistered"] == ["mystery"]
    assert doc["order_violations"] == []


def test_rlock_reentry():
    def case(L, mon):
        r = L.CheckedRLock("a", monitor=mon)
        with r:
            assert mon.held_depth("a") == 1
            with r:
                assert mon.held_depth("a") == 2
            assert mon.held_depth("a") == 1
        assert mon.held_depth("a") == 0
    doc = both(case)
    assert doc["locks"]["a"]["acquisitions"] == 1
    assert doc["locks"]["a"]["reentries"] == 1
    assert doc["edges"] == []


def test_blocking_event_on_long_hold():
    def case(L, mon):
        with L.CheckedLock("a", monitor=mon):
            mon.clock.advance(DEFAULT_BLOCKING_THRESHOLD_S * 4)
    doc = both(case)
    [ev] = doc["blocking_events"]
    assert ev["lock"] == "a"
    assert ev["held_s"] == pytest.approx(DEFAULT_BLOCKING_THRESHOLD_S * 4)
    assert doc["locks"]["a"]["held_max_s"] == pytest.approx(
        DEFAULT_BLOCKING_THRESHOLD_S * 4)


def test_short_hold_is_not_blocking():
    def case(L, mon):
        with L.CheckedLock("a", monitor=mon):
            mon.clock.advance(DEFAULT_BLOCKING_THRESHOLD_S / 2)
    assert both(case)["blocking_events"] == []


def test_cross_thread_contention():
    mon = LockMonitor(clock=Clock(), ranks={"a": 1})
    a = CheckedLock("a", monitor=mon)
    entered = threading.Event()
    done = threading.Event()

    def worker():
        entered.set()
        with a:
            pass
        done.set()

    a.acquire()
    t = threading.Thread(target=worker, name="contender")
    t.start()
    entered.wait(5)
    for _ in range(1000):
        if mon.report()["locks"]["a"].get("contentions"):
            break
        t.join(0.001)
    a.release()
    assert done.wait(5)
    t.join(5)
    doc = mon.report()
    assert doc["locks"]["a"]["contentions"] >= 1
    assert doc["locks"]["a"]["acquisitions"] == 2
    assert doc["edges"] == [] and doc["order_violations"] == []


def test_release_on_wrong_thread_is_flagged():
    doc = both(lambda L, mon: mon.record_release("ghost"))
    [v] = doc["order_violations"]
    assert v["lock"] == "ghost" and "never acquired" in v["detail"]


def test_try_acquire_nonblocking():
    mon = LockMonitor(clock=Clock(), ranks={"a": 1})
    a = CheckedLock("a", monitor=mon)
    assert a.acquire()
    got = [None]
    t = threading.Thread(
        target=lambda: got.__setitem__(0, a.acquire(blocking=False)))
    t.start()
    t.join(5)
    assert got[0] is False
    a.release()


# ----------------------------------------------------------------------
# report schema + globals

def test_report_schema_validates():
    def case(L, mon):
        with L.CheckedLock("a", monitor=mon):
            pass
    doc = both(case)
    doc["enabled"] = False
    validate_lockcheck_report(doc)
    ref_locks.validate_lockcheck_report(doc)
    assert doc["lockcheck_schema_version"] == LOCKCHECK_SCHEMA_VERSION
    validate_lockcheck_report(json.loads(json.dumps(doc)))


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("edges"),
    lambda d: d.update(lockcheck_schema_version=99),
    lambda d: d.update(edges=[["only-one"]]),
    lambda d: d.update(locks={"a": {}}),
    lambda d: d.update(order_violations="nope"),
], ids=["edges", "version", "edge", "lock", "violations"])
def test_report_schema_rejects(mutate):
    for L in (locks, ref_locks):
        doc = L.LockMonitor(clock=Clock(), ranks={}).report()
        mutate(doc)
        with pytest.raises(ValueError):
            L.validate_lockcheck_report(doc)


def test_global_monitor_reset_and_report():
    try:
        m = reset_monitor(clock=Clock(), ranks={"x": 1})
        assert global_monitor() is m
        CheckedLock("x").acquire()  # no explicit monitor: the global one
        doc = lockcheck_report()
        validate_lockcheck_report(doc)
        assert "x" in doc["locks"]
        m.reset()
        assert lockcheck_report()["locks"] == {}
    finally:
        reset_monitor()


# ----------------------------------------------------------------------
# the rank table

def _make_lock_ids() -> dict:
    """Every literal id passed to make_lock / make_rlock under
    ceph_tpu_torch/, with its file."""
    ids = {}
    for path in sorted(PORT_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("make_lock", "make_rlock")):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (
                    f"{path}: a make_lock id must be a string literal")
                ids[arg.value] = str(path.relative_to(REPO_ROOT))
    return ids


def test_every_make_lock_id_has_a_rank():
    ids = _make_lock_ids()
    assert len(ids) >= 20
    ranks = lockmodel.all_ranks()
    missing = {i: f for i, f in ids.items() if i not in ranks}
    assert missing == {}
    # and the table declares no lock the package does not create
    assert set(ranks) == set(ids)
    # each id names its module
    for lid, path in ids.items():
        mod = lockmodel.spec(lid).module
        assert path == "ceph_tpu_torch/" + mod.replace(".", "/") + ".py", lid
    # the monitor reads the table
    assert LockMonitor().ranks == ranks


def test_rank_table_keeps_the_reference_order():
    """Every lock the two packages share has the reference's rank."""
    from ceph_tpu.analysis import lockmodel as ref_model
    ref = ref_model.all_ranks()
    shared = set(ref) & set(lockmodel.all_ranks())
    assert len(shared) >= 20
    assert {i: lockmodel.all_ranks()[i] for i in shared} == \
        {i: ref[i] for i in shared}


# ----------------------------------------------------------------------
# acceptance: the seeded dispatch-chaos family under CEPH_TPU_LOCKCHECK=1

_CHAOS_CHILD = r'''
import json

import numpy as np

from ceph_tpu_torch.utils import locks
assert locks.lockcheck_enabled(), "child needs CEPH_TPU_LOCKCHECK=1"

from ceph_tpu_torch.chaos import ShardErasure, inject
from ceph_tpu_torch.chaos.dispatch import (DispatchFault, arm_plan,
                                           dispatch_faults)
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.codes.stripe import HashInfo, StripeInfo
from ceph_tpu_torch.codes.stripe import encode as stripe_encode
from ceph_tpu_torch.ops import fallback
from ceph_tpu_torch.ops.supervisor import (DispatchSupervisor,
                                           set_global_supervisor)
from ceph_tpu_torch.recovery.orchestrator import healed
from ceph_tpu_torch.scrub import repair_batched
from ceph_tpu_torch.utils.retry import FakeClock

fallback.set_global_policy(fallback.FallbackPolicy(force=None))
sup = DispatchSupervisor(clock=FakeClock(), self_verify=True,
                         deadline_s=0.05, promote_after=2, probe_every=1)
set_global_supervisor(sup)

ec = ErasureCodePluginRegistry.instance().factory(
    "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"},
    device="cpu")
n = ec.get_chunk_count()
k = ec.get_data_chunk_count()
sinfo = StripeInfo(k, k * 512)
rng = np.random.default_rng(11)
originals, stores, hinfos = [], [], []
for i in range(4):
    obj = rng.integers(0, 256, k * 512, np.uint8).tobytes()
    shards = stripe_encode(sinfo, ec, obj)
    hinfo = HashInfo(n)
    hinfo.append(0, shards)
    store, _ = inject(shards, [ShardErasure(shards=[i % 2])],
                      seed=100 + i, chunk_size=sinfo.chunk_size)
    originals.append(shards)
    stores.append(store)
    hinfos.append(hinfo)

with dispatch_faults([DispatchFault("backend_loss",
                                    seam="engine.fused_repair", at=2,
                                    calls=None)], seed=12) as plan:
    rep = repair_batched(sinfo, ec, stores, hinfos, device=True)
    plan.clear()
assert rep.pattern_batches == 2
assert healed(stores, originals), "chaos scenario failed to heal"
for _ in range(sup.promote_after + 1):
    sup.tick()
assert sup.stats()["repromotions"] >= 1
arm_plan(None)

print(json.dumps(locks.lockcheck_report()))
'''


def test_chaos_family_runs_in_declared_order():
    env = dict(os.environ)
    env.update({"CEPH_TPU_LOCKCHECK": "1"})
    res = subprocess.run([sys.executable, "-c", _CHAOS_CHILD],
                         capture_output=True, text=True,
                         cwd=str(REPO_ROOT), env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    validate_lockcheck_report(doc)
    assert doc["enabled"] is True
    assert "ops.supervisor.DispatchSupervisor._lock" in doc["locks"]
    assert "ops.fallback.FallbackPolicy._lock" in doc["locks"]
    assert "chaos.dispatch.DispatchFaultPlan._lock" in doc["locks"]
    assert doc["order_violations"] == []
    assert doc["blocking_events"] == []
    assert doc["unregistered"] == []
    ranks = lockmodel.all_ranks()
    for held, acquired in doc["edges"]:
        assert ranks[held] < ranks[acquired], (held, acquired)
    # every runtime held->acquired edge is predicted by the port's static
    # lock graph (analysis/concurrency.py), as the reference's test holds
    # its own
    from ceph_tpu_torch.analysis.concurrency import static_lock_graph
    static = {tuple(e) for e in
              static_lock_graph([str(REPO_ROOT / "ceph_tpu_torch")])["edges"]}
    runtime = {tuple(e) for e in doc["edges"]}
    assert runtime <= static, f"unpredicted edges: {runtime - static}"
