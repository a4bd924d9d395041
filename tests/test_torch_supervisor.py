"""The port's supervised dispatch plane (``ceph_tpu_torch.ops.supervisor``
with ``chaos/dispatch.py`` and the live tier of ``ops/fallback.py``)
against the reference's (``ceph_tpu.ops.supervisor``) on the CPU: the
cases of ``tests/test_supervisor.py``, each scenario run through both
packages with the same seeded ``DispatchFaultPlan``.  The bytes, the
supervisor's ``stats()``, the plan's ``summary()``, the FakeClock's
timeline (its time and every sleep) and the flight recorder's triggers
must be equal: tolerance 0.

- the torture matrix: fault kind x dispatch seam (``engine.fused_repair``,
  ``engine.serve-encode``, ``ops.apply_matrix``, ``crush.bulk_rule``),
  every cell the reference defines (its tier-1 slice and its slow rest);
- retry without demotion, the OOM split, OOM that never starves, live
  demotion with a flight dump, the hang deadline, corrupt output caught
  (and passed through with self-verify off), the re-promotion streak,
  mid-stream loss through ``repair_batched``, the floor twin, unclassified
  errors propagating, the classifier, the fault-plan semantics, the
  bench's device-chaos row and ``supervisor_selftest``;
- the port's own: the CUDA fault table (constructed ``KernelLaunchError``s
  and ``AcceleratorError``s by ``cudaError_t`` number,
  ``torch.cuda.OutOfMemoryError``, a ``KernelBuildError``,
  launch-configuration and own-kernel faults and message-only errors
  that must propagate and never demote), the card rule (a failure that
  would step the tier down raises ``DeviceDispatchError`` for a dispatch
  on CUDA tensors, exercised here by marking CPU tensors as the card's),
  one supervised dispatch per fused repair (the nested-seam mark), the
  lean clean path entering the ladder with the reference's counts, and
  the live tier on the ops seams.

Both packages' data planes are set to None (the reference's ``no_plane``
fixture), so their plane counters stay at zero and compare equal
(tests/test_torch_host_plane.py and test_torch_multichip.py drive the
planes); the port's ``card_failures`` (zero off the card) is left out of
the comparison.  The reference's "xla" tier is the port's "torch".
"""

from __future__ import annotations

import importlib
import itertools
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def world(name: str) -> SimpleNamespace:
    mods = {"dispatch": "chaos.dispatch", "chaos": "chaos",
            "engine": "codes.engine", "registry": "codes.registry",
            "stripe": "codes.stripe", "fallback": "ops.fallback",
            "sup": "ops.supervisor", "errors": "utils.errors",
            "retry": "utils.retry", "recorder": "telemetry.recorder",
            "scrub": "scrub", "orch": "recovery.orchestrator",
            "crush": "crush", "bulk": "crush.bulk",
            "plane": "parallel.plane"}
    return SimpleNamespace(name=name, **{
        k: importlib.import_module(f"{name}.{v}") for k, v in mods.items()})


REF, PORT = world("ceph_tpu"), world("ceph_tpu_torch")


def tier(W) -> str:
    """The CPU's device tier: the reference's "xla", the port's "torch"."""
    return "torch" if W is PORT else "xla"


@contextmanager
def isolated(W, policy_force=None, **sup_kw):
    """A fresh policy, supervisor (FakeClock, the reference fixture's
    knobs unless overridden), flight recorder and pattern cache; no data
    plane; restored on exit."""
    kw = dict(clock=W.retry.FakeClock(), self_verify=True,
              deadline_s=0.05, promote_after=2, probe_every=1)
    kw.update(sup_kw)
    pol = W.fallback.FallbackPolicy(force=policy_force)
    prev_pol = W.fallback.set_global_policy(pol)
    s = W.sup.DispatchSupervisor(**kw)
    prev = W.sup.set_global_supervisor(s)
    prev_rec = W.recorder.set_global_flight_recorder(
        W.recorder.FlightRecorder())
    prev_cache = W.engine.set_global_pattern_cache(W.engine.PatternCache())
    prev_plane = W.plane.set_data_plane(None)
    try:
        yield s
    finally:
        W.sup.set_global_supervisor(prev)
        W.fallback.set_global_policy(prev_pol)
        W.recorder.set_global_flight_recorder(prev_rec)
        W.engine.set_global_pattern_cache(prev_cache)
        W.dispatch.arm_plan(None)
        W.plane.set_data_plane(prev_plane)


def triggers(W) -> list:
    return [d["trigger"] for d in
            W.recorder.global_flight_recorder().to_dict()["dumps"]]


def timeline(s) -> dict:
    return {"now": s.clock.now, "sleeps": list(s.clock.sleeps)}


def host(out):
    """A seam's output as host arrays (a tuple stays a tuple)."""
    if isinstance(out, (tuple, list)):
        return tuple(host(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


def same_bytes(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bytes(x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


# supervisor counters only one package has: the port's card rule's (both
# have the data plane's; tests/test_torch_host_plane.py drives them)
REF_ONLY: set = set()
PORT_ONLY = {"card_failures"}


def _common(res, W):
    """``res`` with every supervisor counter dict (``stats()`` or the
    bench row's deltas) cut to the keys both packages have; the cut
    counters must be zero (or None)."""
    if isinstance(res, dict):
        out = {k: _common(v, W) for k, v in res.items()}
        if "rung_downshifts" in res:
            for k in (REF_ONLY if W is REF else PORT_ONLY) & set(res):
                assert not res[k], f"{W.name}: {k} = {res[k]!r}"
                del out[k]
        return out
    if isinstance(res, list):
        return [_common(v, W) for v in res]
    return res


def both(fn):
    """``fn(W)`` on the port and on the reference; the results (nested
    dicts, lists, numpy arrays) must be equal.  Returns the port's."""
    got, want = _common(fn(PORT), PORT), _common(fn(REF), REF)
    _equal(got, want)
    return got


def _equal(a, b, path="result"):
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {set(a) ^ set(b)}"
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length"
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and same_bytes(a, b), path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# ----------------------------------------------------------------------
# seam callers: each returns a zero-arg call producing host arrays

def _mk_ec(W, k=4, m=2):
    kw = {"device": "cpu"} if W is PORT else {}
    return W.registry.ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": str(k),
                     "m": str(m)}, **kw)


def _dev(W, x: np.ndarray):
    if W is PORT:
        return torch.from_numpy(np.ascontiguousarray(x))
    import jax.numpy as jnp
    return jnp.asarray(x)


def _fused_seam(W, B=4, C=1024):
    ec = _mk_ec(W)
    n = ec.get_chunk_count()
    erased = (1,)
    avail = tuple(i for i in range(n) if i != 1)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (B, ec.get_data_chunk_count(), C),
                        np.uint8)
    parity = np.asarray(ec.encode_chunks_batch(data))
    surv = np.ascontiguousarray(
        np.concatenate([data, parity], axis=1)[:, np.array(avail), :])

    def call():
        return host(W.engine.fused_repair_call(ec, avail, erased)(
            _dev(W, surv)))
    return call


def _serve_seam(W, B=4, C=1024):
    ec = _mk_ec(W)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (B, ec.get_data_chunk_count(), C),
                        np.uint8)

    def call():
        return host(W.engine.serve_dispatch_call(ec, "encode")(
            _dev(W, data)))
    return call


def _ops_seam(W, B=4, C=1024):
    ec = _mk_ec(W)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (B, 4, C), np.uint8)
    if W is PORT:
        from ceph_tpu_torch.ops.gf_kernels import apply_matrix_best
        from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    else:
        from ceph_tpu.ops.pallas_gf import apply_matrix_best
        from ceph_tpu.ops.xla_ops import matrix_to_static
    ms = matrix_to_static(ec.matrix)

    def call():
        return host(apply_matrix_best(_dev(W, x), ms, 8))
    return call


def _bulk_seam(W, n_x=8):
    b = W.crush.CrushBuilder()
    root = b.build_two_level(4, 2)
    b.add_rule(0, [W.crush.step_take(root),
                   W.crush.step_chooseleaf_indep(0, 1),
                   W.crush.step_emit()])
    kw = {"device": "cpu"} if W is PORT else {}
    cm = W.bulk.CompiledCrushMap(b.map, **kw)
    xs = np.arange(n_x, dtype=np.int64)

    def call():
        out, cnt = W.bulk.bulk_do_rule(cm, 0, xs, 3)
        return np.asarray(out), np.asarray(cnt).astype(np.int32)
    return call


SEAMS = {
    "engine.fused_repair": _fused_seam,
    "engine.serve-encode": _serve_seam,
    "ops.apply_matrix": _ops_seam,
    "crush.bulk_rule": _bulk_seam,
}
KINDS = ("transient", "oom", "backend_loss", "hang", "corrupt")
# the bulk seam opts out of self-verify, so corruption there is out of
# the matrix by design, as in the reference
EXCLUDED_CASES = {("crush.bulk_rule", "corrupt")}
TORTURE = [c for c in itertools.product(SEAMS, KINDS)
           if c not in EXCLUDED_CASES]


def _torture_one(W, seam, kind):
    """One torture cell: warm, arm, run under the fault, heal,
    re-promote, run again; every output equal to the unfailed control."""
    with isolated(W) as sup:
        call = SEAMS[seam](W)
        control = call()
        persistent = kind in ("backend_loss", "hang")
        faults = [W.dispatch.DispatchFault(
            kind, seam=seam, at=1, calls=(None if persistent else 1))]
        with W.dispatch.dispatch_faults(faults, seed=5) as plan:
            out = call()
            assert same_bytes(out, control), f"{seam}/{kind}: bytes"
            assert plan.fired, f"{seam}/{kind}: fault never fired"
            plan.clear()
            summary = plan.summary()
        for _ in range(sup.promote_after + 1):
            sup.tick()
        assert not sup.demoted
        assert W.fallback.global_policy().engine() == tier(W)
        again = call()
        assert same_bytes(again, control)
        return {"control": control, "stats": sup.stats(),
                "plan": summary, "clock": timeline(sup),
                "triggers": triggers(W)}


@pytest.mark.parametrize("seam,kind", TORTURE)
def test_torture_matrix(seam, kind):
    res = both(lambda W: _torture_one(W, seam, kind))
    st = res["stats"]
    if kind == "transient":
        assert st["retries"] >= 1
    elif kind == "oom":
        assert st["rung_downshifts"] + st["demotions"] >= 1
    elif kind == "corrupt":
        assert st["verify_failures"] >= 1
    else:
        assert st["demotions"] >= 1 and st["repromotions"] >= 1


# ----------------------------------------------------------------------
# the classification ladder, piece by piece

def _under(W, make_call, faults, seed, *, B=4, clear=True, **sup_kw):
    """Control, then one call under the armed faults: (bytes equal,
    stats, plan summary, clock, triggers)."""
    with isolated(W, **sup_kw) as sup:
        call = make_call(W, B=B)
        control = call()
        with W.dispatch.dispatch_faults(
                [W.dispatch.DispatchFault(*f[:1], **f[1]) for f in faults],
                seed=seed) as plan:
            out = call()
            if clear:
                plan.clear()
            summary = plan.summary()
        return {"equal": same_bytes(out, control), "stats": sup.stats(),
                "plan": summary, "clock": timeline(sup),
                "triggers": triggers(W)}


def test_transient_retries_without_demotion():
    res = both(lambda W: _under(W, _fused_seam, [(
        "transient", dict(seam="engine.fused_repair", at=1, calls=1))], 1,
        clear=False))
    assert res["equal"]
    assert res["stats"]["retries"] == 1
    assert res["stats"]["demotions"] == 0 and not res["stats"]["demoted"]
    assert res["clock"]["sleeps"] == [0.002]


def test_oom_splits_batch_rung():
    res = both(lambda W: _under(W, _fused_seam, [(
        "oom", dict(seam="engine.fused_repair", at=1, calls=1))], 1, B=8,
        clear=False))
    assert res["equal"]
    assert res["stats"]["rung_downshifts"] >= 1
    assert res["stats"]["demotions"] == 0


def test_persistent_oom_never_starves():
    """A device that runs out of memory at every rung splits down to
    batch 1, then demotes and completes on the numpy twin."""
    res = both(lambda W: _under(W, _fused_seam, [(
        "oom", dict(seam="engine.fused_repair", at=1, calls=None))], 1,
        B=8))
    assert res["equal"]
    st = res["stats"]
    assert st["rung_downshifts"] >= 1 and st["demotions"] >= 1
    assert st["host_completions"] >= 1


def test_backend_loss_demotes_live_and_flight_dumps():
    def run(W):
        with isolated(W) as sup:
            call = _fused_seam(W)
            control = call()
            pol = W.fallback.global_policy()
            assert pol.engine() == tier(W)
            with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                    "backend_loss", seam="engine.fused_repair", at=1,
                    calls=None)], seed=2) as plan:
                assert same_bytes(call(), control)
                assert pol.engine() == "numpy"          # LIVE demotion
                assert pol.demoted
                # every dispatch keeps completing on the host twin
                assert same_bytes(call(), control)
                plan.clear()
                summary = plan.summary()
            return {"stats": sup.stats(), "plan": summary,
                    "clock": timeline(sup), "triggers": triggers(W)}
    res = both(run)
    assert "backend_demoted" in res["triggers"]
    assert "backend_lost" in res["triggers"]


def test_hang_burns_deadline_then_demotes():
    res = both(lambda W: _under(W, _fused_seam, [(
        "hang", dict(seam="engine.fused_repair", at=1, calls=None))], 3))
    assert res["equal"]
    assert res["clock"]["now"] > 0                  # the deadline burned
    assert res["stats"]["hangs"] >= 1 and res["stats"]["demotions"] >= 1


def test_corrupt_output_caught_and_never_returned():
    res = both(lambda W: _under(W, _fused_seam, [(
        "corrupt", dict(seam="engine.fused_repair", at=1, calls=1))], 4,
        clear=False))
    assert res["equal"]                             # never written back
    assert res["stats"]["verify_failures"] == 1
    assert "output_corruption" in res["triggers"]


def test_corrupt_propagates_without_self_verify():
    """Self-verify off (the default): injected corruption reaches the
    caller, the same flipped bit in both packages."""
    def run(W):
        with isolated(W, self_verify=False, deadline_s=None,
                      promote_after=3, probe_every=4) as sup:
            call = _fused_seam(W)
            control = call()
            with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                    "corrupt", seam="engine.fused_repair", at=1,
                    calls=1)], seed=4) as plan:
                out = call()
                fired = [(f.kind, f.seam, f.call, f.detail)
                         for f in plan.fired]
            assert not same_bytes(out, control)
            assert sup.stats()["verify_failures"] == 0
            return {"out": out, "fired": fired, "stats": sup.stats()}
    both(run)


# ----------------------------------------------------------------------
# health probe / re-promotion properties

def test_repromotion_needs_consecutive_clean_probes():
    def run(W):
        with isolated(W) as sup:
            call = _fused_seam(W)
            control = call()
            plan = W.dispatch.DispatchFaultPlan(
                [W.dispatch.DispatchFault("backend_loss",
                                          seam="engine.fused_repair",
                                          at=1, calls=None)], seed=6)
            prev = W.dispatch.arm_plan(plan)
            try:
                assert same_bytes(call(), control)
                assert sup.demoted
                assert not sup.tick() and not sup.tick()
                assert sup.stats()["probe_failed"] >= 2
                plan.clear()
                assert not sup.tick()           # promote_after=2: #1
                assert sup.demoted
                assert sup.tick()               # #2 promotes
                assert not sup.demoted
                assert W.fallback.global_policy().engine() == tier(W)
                return {"stats": sup.stats(), "triggers": triggers(W)}
            finally:
                W.dispatch.arm_plan(prev)
    res = both(run)
    assert res["stats"]["repromotions"] == 1
    assert "repromoted" in res["triggers"]


def test_probe_failure_resets_clean_streak():
    def run(W):
        with isolated(W) as sup:
            call = _fused_seam(W)
            control = call()
            plan = W.dispatch.DispatchFaultPlan(
                [W.dispatch.DispatchFault("backend_loss",
                                          seam="engine.fused_repair",
                                          at=1, calls=None)], seed=6)
            prev = W.dispatch.arm_plan(plan)
            try:
                assert same_bytes(call(), control)
                plan.clear()
                ticks = [sup.tick()]            # clean #1
                plan.cleared = False            # the fault flaps back
                ticks.append(sup.tick())        # the streak resets
                plan.clear()
                ticks += [sup.tick(), sup.tick()]
                return {"ticks": ticks, "stats": sup.stats()}
            finally:
                W.dispatch.arm_plan(prev)
    assert both(run)["ticks"] == [False, False, False, True]


def test_no_plane_demotes_instead_of_quarantine():
    """Without a data plane (tests/test_torch_host_plane.py has the
    quarantines), a persistent loss on a batch of 8 takes the tier
    ladder in both packages: no quarantine, a live demotion, the host
    twin, and re-promotion restores the tier."""
    def run(W):
        with isolated(W) as sup:
            call = _fused_seam(W, B=8)
            control = call()
            with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                    "backend_loss", seam="engine.fused_repair", at=1,
                    calls=None)], seed=7) as plan:
                assert same_bytes(call(), control)
                plan.clear()
            for _ in range(sup.promote_after + 1):
                sup.tick()
            assert not sup.demoted
            assert same_bytes(call(), control)
            if W is REF:
                ref = sup.stats()
                assert ref["quarantines"] == 0
                assert ref["plane_width0"] is None
            return {"stats": sup.stats(), "triggers": triggers(W)}
    st = both(run)["stats"]
    assert st["demotions"] == 1


# ----------------------------------------------------------------------
# mid-stream loss through repair_batched: byte-identical heal, zero data
# loss, flight dump, re-promotion

def _midstream(W):
    with isolated(W) as sup:
        ec = _mk_ec(W)
        n = ec.get_chunk_count()
        k = ec.get_data_chunk_count()
        sinfo = W.stripe.StripeInfo(k, k * 512)
        rng = np.random.default_rng(11)
        originals, stores, hinfos = [], [], []
        for i in range(4):
            obj = rng.integers(0, 256, k * 512, np.uint8).tobytes()
            shards = W.stripe.encode(sinfo, ec, obj)
            hinfo = W.stripe.HashInfo(n)
            hinfo.append(0, shards)
            # two patterns -> two fused batches; the SECOND loses the
            # backend (a warm seam, mid-stream)
            store, _ = W.chaos.inject(shards, [W.chaos.ShardErasure(
                shards=[i % 2])], seed=100 + i,
                chunk_size=sinfo.chunk_size)
            originals.append(shards)
            stores.append(store)
            hinfos.append(hinfo)
        with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                "backend_loss", seam="engine.fused_repair", at=2,
                calls=None)], seed=12) as plan:
            rep = W.scrub.repair_batched(sinfo, ec, stores, hinfos,
                                         device=True)
            plan.clear()
            summary = plan.summary()
        assert W.orch.healed(stores, originals)         # zero data loss
        for st, orig in zip(stores, originals):
            for s, buf in orig.items():
                assert bytes(st.shards[s]) == bytes(buf)
        out = {"batches": rep.pattern_batches, "stats": sup.stats(),
               "plan": summary, "triggers": triggers(W),
               "stores": [{s: bytes(b) for s, b in st.shards.items()}
                          for st in stores]}
        for _ in range(sup.promote_after + 1):
            sup.tick()
        out["after"] = sup.stats()
        return out


def test_repair_batched_survives_midstream_backend_loss():
    res = both(_midstream)
    assert res["batches"] == 2
    assert res["stats"]["demotions"] >= 1
    assert res["stats"]["host_completions"] >= 1
    assert "backend_demoted" in res["triggers"]
    assert res["after"]["repromotions"] >= 1 and not res["after"]["demoted"]


# ----------------------------------------------------------------------
# DispatchFaultPlan semantics (the port's copy, held to the reference's)

def test_fault_window_semantics():
    def run(W):
        plan = W.dispatch.DispatchFaultPlan(
            [W.dispatch.DispatchFault("transient", seam="s", at=2,
                                      calls=2)], seed=0)
        polls = [plan.poll("s"), plan.poll("other"), plan.poll("s"),
                 plan.poll("s"), plan.poll("s")]
        return {"kinds": [None if p is None else p.kind for p in polls],
                "summary": plan.summary()}
    res = both(run)
    assert res["kinds"] == [None, None, "transient", "transient", None]
    assert res["summary"]["fired"] == 2


def test_fault_persistent_until_cleared():
    def run(W):
        plan = W.dispatch.DispatchFaultPlan(
            [W.dispatch.DispatchFault("backend_loss", seam="s", at=1,
                                      calls=None)], seed=0)
        out = [plan.pending_persistent()]
        out += [plan.poll("s") is not None for _ in range(5)]
        plan.clear()
        out += [plan.poll("s") is None, plan.pending_persistent()]
        return out
    assert both(run) == [True] * 7 + [False]


@pytest.mark.parametrize("kwargs", [dict(kind="nope"),
                                    dict(kind="oom", at=0),
                                    dict(kind="oom", calls=0)],
                         ids=["kind", "at", "calls"])
def test_fault_validation(kwargs):
    for W in (PORT, REF):
        with pytest.raises(ValueError):
            W.dispatch.DispatchFault(**kwargs)


def test_corrupt_replays_byte_identically():
    def run(W):
        out = np.zeros((4, 16), np.uint8)
        flips = []
        for _ in range(2):
            plan = W.dispatch.DispatchFaultPlan(
                [W.dispatch.DispatchFault("corrupt", seam="s", at=1)],
                seed=9)
            f = plan.poll("s")
            flips.append(plan.corrupt_output(f, "s", out).tobytes())
        return flips
    flips = both(run)
    assert flips[0] == flips[1] != bytes(64)


# ----------------------------------------------------------------------
# the classifier

def _classifier_cases(W):
    D, E = W.dispatch, W.errors
    return [E.TransientBackendError("x"), D.InjectedOom("s"),
            D.InjectedBackendLoss("x"), D.DispatchHang("x"),
            E.RetryExhausted(3, E.TransientBackendError("t")),
            E.RetryExhausted(3, D.InjectedOom("s")),
            E.ProbeTimeout("x", 1.0),
            ValueError("shape"), RuntimeError("plain bug"),
            KeyError("k")]


# the reference's PJRT / gRPC texts: it classifies them by message; the
# port never reads a message (torch's errors carry a type and a number)
MESSAGE_CASES = [
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"), "oom"),
    (RuntimeError("UNAVAILABLE: socket closed"), "backend_loss"),
    (RuntimeError("host unreachable: worker lost"), "host_loss"),
]


def test_classifier():
    got = both(lambda W: [W.sup.classify_dispatch_error(e)
                          for e in _classifier_cases(W)])
    assert got == ["transient", "oom", "backend_loss", "backend_loss",
                   "transient", "oom", "backend_loss", None, None, None]
    assert [REF.sup.classify_dispatch_error(e)
            for e, _ in MESSAGE_CASES] == [c for _, c in MESSAGE_CASES]
    assert [PORT.sup.classify_dispatch_error(e)
            for e, _ in MESSAGE_CASES] == [None] * len(MESSAGE_CASES)


def test_floor_policy_completes_on_twin():
    """A policy already at the numpy floor plus a failing dispatch
    completes on the ground-truth twin, not re-raise."""
    def run(W):
        with isolated(W, policy_force="numpy", self_verify=None,
                      deadline_s=None, promote_after=3,
                      probe_every=4) as s:
            data = np.arange(32, dtype=np.uint8)

            def body(x):
                return x ^ np.uint8(0xFF)

            with W.dispatch.dispatch_faults([W.dispatch.DispatchFault(
                    "backend_loss", seam="s", at=1, calls=1)], seed=1):
                out = s.dispatch("s", body, (data,), host_fn=body)
            assert np.array_equal(out, body(data))
            return s.stats()
    st = both(run)
    assert st["host_completions"] == 1 and st["demotions"] == 0


def test_unclassified_errors_propagate():
    def run(W):
        with isolated(W) as sup:
            def boom():
                raise ValueError("a real bug")
            with pytest.raises(ValueError):
                sup.dispatch("s", boom, ())
            return sup.stats()
    assert both(run)["demotions"] == 0


# ----------------------------------------------------------------------
# the CUDA fault table (the port's own): by number, never by message

OOM_CODES = (2,)
LOSS_CODES = (46, 100, 214)
# launch configuration (invalid value, invalid configuration, no kernel
# image, out of resources) and the kernel's own faults (illegal address,
# launch timeout, device-side assert, illegal instruction, misaligned
# address, launch failure): never classified
NEVER_CODES = (1, 9, 209, 701, 700, 702, 710, 715, 716, 719)


def test_cuda_code_tables():
    assert PORT.sup.CUDA_OOM_CODES == frozenset(OOM_CODES)
    assert PORT.sup.CUDA_LOSS_CODES == frozenset(LOSS_CODES)
    assert not set(NEVER_CODES) & (PORT.sup.CUDA_OOM_CODES
                                   | PORT.sup.CUDA_LOSS_CODES)


@pytest.mark.parametrize("code,cls", [(c, "oom") for c in OOM_CODES]
                         + [(c, "backend_loss") for c in LOSS_CODES]
                         + [(c, None) for c in NEVER_CODES]
                         + [(None, None)])
def test_kernel_launch_error_classifies_by_code(code, cls):
    # the message says "out of memory" whatever the code: the class
    # comes from the number alone
    e = PORT.errors.KernelLaunchError(
        f"GF(2^8) matrix kernel failed: CUDA error {code} (out of memory, "
        f"backend unavailable)", code=code)
    assert e.code == code
    assert PORT.sup.classify_dispatch_error(e) == cls


def _accelerator_error(code):
    """torch's error for a failed CUDA call, as torch raises it: its
    ``error_code`` the cudaError_t."""
    e = torch.AcceleratorError(f"CUDA error: code {code}")
    e.error_code = code
    return e


@pytest.mark.parametrize("err,cls", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "oom"),
    (RuntimeError("CUDA error: GPU has fallen off the bus"), None),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), None),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     None),
    (RuntimeError("CUDA error: device-side assert triggered (backend "
                  "unavailable?)"), None),
    (RuntimeError("CUDA error: misaligned address"), None),
    (RuntimeError("CUDA error: unspecified launch failure"), None),
    (RuntimeError("CUDA error: too many resources requested for launch"),
     None),
    (PORT.errors.KernelBuildError("nvcc failed for gf8_matrix.cu: out of "
                                  "memory"), None),
    (NotImplementedError("Could not run 'aten::add.Tensor' with arguments "
                         "from the 'CUDA' backend"), None),
    (RuntimeError("our own bug: backend connection unavailable"), None),
    (ConnectionError("connection reset"), None),
    (_accelerator_error(214), "backend_loss"),
    (_accelerator_error(2), "oom"),
    (_accelerator_error(700), None),
    (_accelerator_error(702), None),
], ids=["torch-oom", "off-the-bus", "ecc", "illegal-address",
        "device-assert", "misaligned", "launch-failure", "resources",
        "build", "no-cuda-kernel", "backend-text", "connection",
        "accel-214", "accel-2", "accel-700", "accel-702"])
def test_cuda_fault_messages(err, cls):
    """A torch error classifies by its type and its cudaError_t alone:
    no text, however it reads, makes a class (a lost card's "fallen off
    the bus" or ECC error reaches torch as a numbered error)."""
    assert PORT.sup.classify_dispatch_error(err) == cls


def _raising(exc, times=1):
    """A seam body that raises ``exc`` on its first ``times`` calls,
    then returns its input XOR 0x5A."""
    left = [times]

    def body(x):
        if left[0]:
            left[0] -= 1
            raise exc
        return x ^ np.uint8(0x5A)
    return body


@pytest.mark.parametrize("exc", [
    PORT.errors.KernelBuildError("nvcc failed"),
    *[PORT.errors.KernelLaunchError(f"CUDA error {c}", code=c)
      for c in NEVER_CODES]],
    ids=["build"] + [f"code{c}" for c in NEVER_CODES])
def test_own_faults_propagate_and_never_demote(exc):
    """A kernel that failed to build, a bad launch configuration and a
    fault of the kernel's own making propagate untouched — on the clean
    path and with a plan armed — and nothing demotes."""
    data = np.arange(16, dtype=np.uint8)
    for armed in (False, True):
        with isolated(PORT, self_verify=False, deadline_s=None) as sup:
            plan = ([PORT.dispatch.DispatchFault("transient", seam="x",
                                                 at=1)] if armed else [])
            with PORT.dispatch.dispatch_faults(plan, seed=0):
                with pytest.raises(type(exc)) as got:
                    sup.dispatch("ops.apply_matrix", _raising(exc),
                                 (data,), host_fn=lambda x: x ^ 0x5A)
            assert got.value is exc
            st = sup.stats()
            assert st["demotions"] == st["retries"] == 0
            assert st["host_completions"] == 0 and not sup.demoted
            assert PORT.fallback.global_policy().engine() == "torch"


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"),
     dict(rung_downshifts=1, demotions=0)),
    (PORT.errors.KernelLaunchError("CUDA error 2", code=2),
     dict(rung_downshifts=1, demotions=0)),
    (PORT.errors.KernelLaunchError("CUDA error 214", code=214),
     dict(rung_downshifts=0, demotions=1)),
], ids=["torch-oom", "code2", "code214"])
def test_real_cuda_faults_take_the_ladder(exc, want):
    """A real out-of-memory error splits the rung; a lost card demotes
    the tier live and the host twin completes; the bytes are the
    unfailed call's."""
    data = np.arange(64, dtype=np.uint8).reshape(4, 16)
    with isolated(PORT, self_verify=False, deadline_s=None) as sup:
        out = sup.dispatch("ops.apply_matrix", _raising(exc), (data,),
                           host_fn=lambda x: x ^ np.uint8(0x5A))
        assert np.array_equal(out, data ^ np.uint8(0x5A))
        st = sup.stats()
        for k, v in want.items():
            assert st[k] == v, (k, st)


def test_oom_split_joins_tensors_on_their_device():
    """A rung split re-joins tensor outputs with torch.cat (the bytes
    stay where they are) and numpy twins' outputs with numpy."""
    x = torch.arange(64, dtype=torch.uint8).reshape(8, 8)
    with isolated(PORT, self_verify=False, deadline_s=None) as sup:
        exc = torch.cuda.OutOfMemoryError("CUDA out of memory")
        out = sup.dispatch("s", _raising(exc), (x,))
        assert isinstance(out, torch.Tensor)
        assert torch.equal(out, x ^ 0x5A)
        assert sup.stats()["rung_downshifts"] == 1


def test_oom_split_frees_the_failed_attempt():
    """What the failed attempt allocated is freed before the halves run:
    its frames, which the error's traceback holds, are dropped (on the
    card the halves need that memory)."""
    import weakref

    class Block:
        pass
    held = []

    def body(x):
        if not held:
            block = Block()         # the failed attempt's allocation
            held.append(weakref.ref(block))
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        assert held[0]() is None, "the failed attempt is still alive"
        return x ^ 0x5A
    x = torch.arange(16, dtype=torch.uint8).reshape(4, 4)
    with isolated(PORT, self_verify=False, deadline_s=None) as sup:
        assert torch.equal(sup.dispatch("s", body, (x,)), x ^ 0x5A)
        assert sup.stats()["rung_downshifts"] == 1


# ----------------------------------------------------------------------
# the card rule: a dispatch on CUDA tensors keeps its work on the card

@pytest.fixture
def on_card(monkeypatch):
    """Every dispatch counts as one on the card: the rule reads where
    the arguments live, and CPU tensors stand in for CUDA ones here."""
    monkeypatch.setattr(PORT.sup, "_on_card", lambda args: True)


@pytest.mark.parametrize("kind,want", [
    ("transient", "transient"),         # the retries run out
    ("oom", "oom"),                     # split down to a batch of one
    ("backend_loss", "backend_loss"),
    ("hang", "backend_loss"),
])
def test_card_failure_raises_and_never_demotes(on_card, kind, want):
    """A failure that would step the tier down raises DeviceDispatchError
    naming the seam and the class: no demotion, no host twin, the tier
    untouched, the failure counted and flight-recorded."""
    x = torch.arange(64, dtype=torch.uint8).reshape(4, 16)
    twin = []
    with isolated(PORT, self_verify=False) as sup:
        with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                kind, seam="ops.apply_matrix", at=1, calls=None)], seed=3):
            with pytest.raises(PORT.errors.DeviceDispatchError) as got:
                sup.dispatch("ops.apply_matrix", lambda v: v ^ 0x5A, (x,),
                             host_fn=lambda v: twin.append(v))
        assert got.value.seam == "ops.apply_matrix"
        assert got.value.kind == want
        assert got.value.__cause__ is not None
        st = sup.stats()
        assert st["card_failures"] == 1
        assert st["demotions"] == st["host_completions"] == 0
        assert not sup.demoted and twin == []
        assert PORT.fallback.global_policy().engine() == "torch"
        assert (st["rung_downshifts"] > 0) == (kind == "oom")
        assert "backend_lost" in triggers(PORT)


def test_card_keeps_retry_and_the_oom_split(on_card):
    """On the card a transient error is retried and an out-of-memory
    error splits the rung (both launch the kernel again); a real lost
    card (cudaError 214) raises."""
    x = torch.arange(64, dtype=torch.uint8).reshape(4, 16)
    with isolated(PORT, self_verify=False, deadline_s=None) as sup:
        for exc in (PORT.errors.TransientBackendError("flaky"),
                    torch.cuda.OutOfMemoryError("CUDA out of memory")):
            out = sup.dispatch("s", _raising(exc), (x,))
            assert torch.equal(out, x ^ 0x5A)
        with pytest.raises(PORT.errors.DeviceDispatchError) as got:
            sup.dispatch("s", _raising(PORT.errors.KernelLaunchError(
                "CUDA error 214", code=214)), (x,),
                host_fn=lambda v: v ^ 0x5A)
        assert got.value.kind == "backend_loss"
        st = sup.stats()
        assert st["retries"] == 1 and st["rung_downshifts"] == 1
        assert st["card_failures"] == 1 and st["demotions"] == 0


def test_card_corruption_caught_raises(on_card):
    """Self-verify on the card checks the output against the numpy twin
    run on host copies of the inputs; a mismatch raises: neither the
    corrupted bytes nor the host's are returned."""
    with isolated(PORT) as sup:
        call = _fused_seam(PORT)
        control = call()
        with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                "corrupt", seam="engine.fused_repair", at=1, calls=1)],
                seed=4):
            with pytest.raises(PORT.errors.DeviceDispatchError) as got:
                call()
        assert got.value.kind == "corrupt"
        st = sup.stats()
        assert st["verify_failures"] == 1 and st["card_failures"] == 1
        assert st["demotions"] == st["host_completions"] == 0
        assert "output_corruption" in triggers(PORT)
        assert same_bytes(call(), control)      # verified clean again
        assert sup.stats()["verified_clean"] >= 2


def test_ragged_oom_split_cuts_the_mask_with_the_pool():
    """A rung split of a ragged dispatch cuts the page pool and its mask
    alike, so each half applies its own pages' mask."""
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    ms = matrix_to_static(_mk_ec(PORT).matrix)
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.integers(0, 256, (6, 4, 512), np.uint8))
    mask = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.uint8)
    want = gf_kernels.apply_matrix_best_ragged(pool, ms, mask)
    with isolated(PORT, self_verify=False, deadline_s=None) as sup:
        with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                "oom", seam="ops.apply_matrix_ragged", at=1, calls=1)],
                seed=1):
            got = gf_kernels.apply_matrix_best_ragged(pool, ms, mask)
        assert torch.equal(got, want)
        assert sup.stats()["rung_downshifts"] == 1


# ----------------------------------------------------------------------
# one fused repair, one supervised dispatch (the nested-seam mark)

@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
], ids=["rs", "cauchy", "shec", "lrc"])
def test_one_fused_repair_is_one_supervised_dispatch(plugin, profile):
    def run(W):
        with isolated(W, self_verify=False, deadline_s=None) as sup:
            kw = {"device": "cpu"} if W is PORT else {}
            ec = W.registry.ErasureCodePluginRegistry.instance().factory(
                plugin, dict(profile), **kw)
            n = ec.get_chunk_count()
            avail = tuple(range(1, n))
            chunk = ec.get_chunk_size(ec.get_data_chunk_count() * 1024)
            x = np.random.default_rng(3).integers(
                0, 256, (2, len(avail), chunk), np.uint8)
            plan = W.dispatch.DispatchFaultPlan([], seed=0)
            prev = W.dispatch.arm_plan(plan)
            try:
                W.engine.fused_repair_call(ec, avail, (0,))(_dev(W, x))
            finally:
                W.dispatch.arm_plan(prev)
            return {"dispatches": sup.stats()["dispatches"],
                    "calls": plan.summary()["calls"]}
    res = both(run)
    assert res == {"dispatches": 1, "calls": {"engine.fused_repair": 1}}


def test_clean_path_error_enters_the_ladder_with_reference_counts():
    """With nothing armed the port's clean path is the call alone; a
    transient error there still costs one retry and one backoff sleep,
    as in the reference."""
    def run(W):
        with isolated(W, self_verify=False, deadline_s=None,
                      promote_after=3, probe_every=4) as sup:
            data = np.arange(16, dtype=np.uint8)
            out = sup.dispatch("s", _raising(
                W.errors.TransientBackendError("flaky")), (data,))
            assert np.array_equal(out, data ^ np.uint8(0x5A))
            return {"stats": sup.stats(), "clock": timeline(sup)}
    res = both(run)
    assert res["stats"]["retries"] == 1 and res["stats"]["dispatches"] == 1
    assert res["clock"]["sleeps"] == [0.002]


def test_live_tier_on_the_ops_seams():
    """A persistent loss at ``ops.apply_matrix_packed`` and
    ``ops.apply_matrix_ragged`` demotes the tier and completes on the
    numpy twin, byte for byte; the packed and ragged entries route
    through their own seams."""
    from ceph_tpu_torch.ops import gf_kernels
    from ceph_tpu_torch.ops.torch_ops import matrix_to_static
    ec = _mk_ec(PORT)
    ms = matrix_to_static(ec.matrix)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (3, 4, 1024), np.uint8))
    pool = torch.from_numpy(rng.integers(0, 256, (6, 4, 512), np.uint8))
    mask = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.uint8)
    packed = gf_kernels.pack_chunks(x)
    want_p = gf_kernels.apply_matrix_packed_best(packed, ms)
    want_r = gf_kernels.apply_matrix_best_ragged(pool, ms, mask)
    for seam, call, want in (
            ("ops.apply_matrix_packed",
             lambda: gf_kernels.apply_matrix_packed_best(packed, ms),
             want_p),
            ("ops.apply_matrix_ragged",
             lambda: gf_kernels.apply_matrix_best_ragged(pool, ms, mask),
             want_r)):
        with isolated(PORT) as sup:
            with PORT.dispatch.dispatch_faults([PORT.dispatch.DispatchFault(
                    "backend_loss", seam=seam, at=1, calls=None)],
                    seed=1) as plan:
                got = call()
                assert plan.summary()["calls"] == {seam: 1}
            assert torch.equal(got, want)
            st = sup.stats()
            assert st["demotions"] == 1 and st["host_completions"] == 1


# ----------------------------------------------------------------------
# the bench's device-chaos row and the selftest

def _device_chaos(W, device, batch=2, size=4096):
    with isolated(W, self_verify=None, deadline_s=None, promote_after=3,
                  probe_every=4) as sup:
        mod = importlib.import_module(
            f"{W.name}.bench.erasure_code_benchmark")
        bench = mod.ErasureCodeBench()
        bench.setup(["-p", "jerasure", "-P", "technique=reed_sol_van",
                     "-P", "k=4", "-P", "m=2", "-s", str(size),
                     "--workload", "device-chaos", "--device", device,
                     "--batch", str(batch), "--iterations", "1", "-e",
                     "1"])
        res = bench.run()
        return {k: res[k] for k in ("workload", "verified",
                                    "faults_fired", "supervisor",
                                    "demoted_at_end", "erasures")} | {
            "stats": sup.stats(), "triggers": triggers(W)}


def test_bench_device_chaos_workload_host():
    res = both(lambda W: _device_chaos(W, "host"))
    assert res["workload"] == "device-chaos" and res["verified"] is True
    assert res["faults_fired"] >= 2
    sv = res["supervisor"]
    assert sv["retries"] >= 1 and sv["demotions"] >= 1
    assert sv["repromotions"] >= 1
    assert res["demoted_at_end"] is False


def test_bench_device_chaos_workload_on_the_device_tier():
    """--device cpu (the port's torch tier) against the reference's
    --device jax on the CPU: the fused-repair seam's fault script (8
    objects, 4 patterns) gives the same counts."""
    def run(W):
        return _device_chaos(W, "cpu" if W is PORT else "jax", batch=8,
                             size=2048)
    res = both(run)
    sv = res["supervisor"]
    # transient, oom, the loss at call 5 and (polled at the floor, where
    # the host twin completes) at call 6
    assert res["faults_fired"] == 4
    assert sv["retries"] == 1 and sv["rung_downshifts"] == 1
    assert sv["demotions"] == 1 and sv["host_completions"] >= 1
    assert sv["repromotions"] == 1 and res["demoted_at_end"] is False


def test_bench_device_chaos_requeues_on_the_card(on_card):
    """On the card the fault script's loss raises at each of its two
    calls and the pass is re-queued: the heal is byte-identical, nothing
    demotes and no host twin runs."""
    res = _device_chaos(PORT, "cpu", batch=8, size=2048)
    sv = res["supervisor"]
    assert res["verified"] is True and res["faults_fired"] == 4
    assert sv["retries"] == 1 and sv["rung_downshifts"] == 1
    assert sv["card_failures"] == 2
    assert sv["demotions"] == sv["host_completions"] == 0
    assert sv["repromotions"] == 0 and res["demoted_at_end"] is False


def test_supervisor_selftest_green():
    st = _common(PORT.sup.supervisor_selftest(), PORT)
    want = _common(REF.sup.supervisor_selftest(), REF)
    assert st == want
    assert st["repromotions"] >= 1 and not st["demoted"]
