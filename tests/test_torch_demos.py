"""The port's demos and examples (``ceph_tpu_torch.tools``: scrub_demo,
recovery_demo, serve_demo, scenario_demo, tenant_week_demo,
cluster_demo, device_chaos_demo, host_chaos_demo,
cluster_lifecycle_demo, failure_recovery_demo) against the reference's
``tools/*.py`` and ``examples/*.py`` on the CPU.

Each reference tool is loaded by path and run in-process (its
``main(argv)``; ``examples/failure_recovery_demo.py`` runs at import);
the port's ``main(argv)`` runs with ``--device cpu``, or ``--device
host`` where the reference's demo runs the host executor.  Each package
starts from fresh process-global state (``fresh``: policy, supervisor,
flight recorder, pattern cache, no plane, no armed fault plan).  The rc
must be equal, and the JSON key for key or the text line for line; each
test names the fields it leaves out.

The device-executor chaos demos serve the rs k=4 m=2 codec only here
(``rs_only``, the same cut on both sides): the reference's device
executor compiles each shec and clay pattern for seconds.  The full mix
runs on the card in ``chip_smoke.py``'s phase 12.  ``--kill-one`` runs
the port alone (two worker processes, every wait under a timeout).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import pytest

import ceph_tpu.utils.log  # noqa: F401  (bind stderr outside capsys)
import ceph_tpu_torch.utils.log  # noqa: F401
from test_torch_supervisor import PORT, REF

ROOT = Path(__file__).resolve().parents[1]
HOSTS = {W.name: importlib.import_module(f"{W.name}.chaos.hosts")
         for W in (PORT, REF)}


def ref_tool(rel: str):
    name = "_reftool_" + Path(rel).stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def port_tool(name: str):
    return importlib.import_module(f"ceph_tpu_torch.tools.{name}")


@contextmanager
def fresh(W):
    """Process-global state as a new process has it; restored on exit."""
    prev_pol = W.fallback.set_global_policy(W.fallback.FallbackPolicy())
    prev_sup = W.sup.set_global_supervisor(W.sup.DispatchSupervisor())
    prev_rec = W.recorder.set_global_flight_recorder(
        W.recorder.FlightRecorder())
    prev_cache = W.engine.set_global_pattern_cache(W.engine.PatternCache())
    prev_plane = W.plane.set_data_plane(None)
    W.dispatch.arm_plan(None)
    HOSTS[W.name].arm_host_plan(None)
    try:
        yield
    finally:
        W.fallback.set_global_policy(prev_pol)
        W.sup.set_global_supervisor(prev_sup)
        W.recorder.set_global_flight_recorder(prev_rec)
        W.engine.set_global_pattern_cache(prev_cache)
        W.plane.set_data_plane(prev_plane)
        W.dispatch.arm_plan(None)
        HOSTS[W.name].arm_host_plan(None)


def call(capsys, W, main, argv):
    """(rc, stdout) of an in-process ``main(argv)`` under ``fresh(W)``."""
    capsys.readouterr()
    with fresh(W):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, capsys.readouterr().out


def both(capsys, ref_rel, port_name, argv, port_extra=("--device", "cpu")):
    R, P = ref_tool(ref_rel), port_tool(port_name)
    return (call(capsys, REF, R.main, list(argv)),
            call(capsys, PORT, P.main, list(argv) + list(port_extra)))


def pop_path(d: dict, path: str):
    """Drop ``a/b/c`` from a nested dict (where present)."""
    *head, last = path.split("/")
    for k in head:
        d = d.get(k, {})
    d.pop(last, None)


# -- scrub_demo, recovery_demo ----------------------------------------------

@pytest.mark.parametrize("argv,rc", [
    (["--json"], 0), ([], 0), (["--erasures", "3"], 2),
    (["--erasures", "3", "--json"], 2),
    (["--erasures", "0", "--truncate", "--transient", "2", "--json"], 0),
    (["--truncate", "--zero-stripe", "--json"], 2),
    (["--plugin", "isa", "--erasures", "2", "--corruptions", "0"], 0),
    (["--plugin", "nope"], 1)],
    ids=["json", "text", "over_m", "over_m_json", "faults", "faults_over_m",
         "isa", "bad_plugin"])
def test_scrub_demo_matches_reference(argv, rc, capsys):
    got_r, got_p = both(capsys, "tools/scrub_demo.py", "scrub_demo", argv)
    assert got_r == got_p and got_p[0] == rc


@pytest.mark.parametrize("argv", [
    ["--json"], [],
    ["--erasures", "1", "--corruptions", "1", "--churn", "3",
     "--crash-site", "writeback.after_write", "--torn", "--json"],
    ["--erasures", "3", "--json"], ["--list-sites"]],
    ids=["json", "text", "crash_torn", "over_m", "sites"])
def test_recovery_demo_matches_reference(argv, capsys):
    got_r, got_p = both(capsys, "tools/recovery_demo.py", "recovery_demo",
                        argv)
    assert got_r == got_p
    assert got_p[0] == (2 if "3" in argv[1:2] else 0)


def test_recovery_demo_host_arm(capsys):
    """``--device host`` (host repairs): the same report but for the two
    counters that say where the decode ran."""
    got_r, got_p = both(capsys, "tools/recovery_demo.py", "recovery_demo",
                        ["--json"], ("--device", "host"))
    jr, jp = json.loads(got_r[1]), json.loads(got_p[1])
    assert jp["report"]["host_batches"] == jr["report"]["device_calls"] > 0
    for k in ("host_batches", "device_calls"):
        pop_path(jr, f"report/{k}")
        pop_path(jp, f"report/{k}")
    assert got_r[0] == got_p[0] == 0 and jr == jp


# -- serve_demo, scenario_demo, tenant_week_demo ----------------------------

@pytest.mark.parametrize("argv,dev", [
    (["--json"], "cpu"), (["--json", "--validate"], "host"),
    (["--erasures", "4", "--json"], "cpu"), ([], "host")],
    ids=["device", "host_validate", "over_m", "text"])
def test_serve_demo_matches_reference(argv, dev, capsys):
    """The reference's demo runs the host executor; the port's device
    executor on CPU tensors reports ``stream_compiles`` (kernel setups
    after warmup, 0), which the host executor leaves null."""
    got_r, got_p = both(capsys, "tools/serve_demo.py", "serve_demo", argv,
                        ("--device", dev))
    assert got_r[0] == got_p[0] == (2 if "4" in argv else 0)
    if "--json" not in argv:
        assert got_r == got_p
        return
    jr, jp = json.loads(got_r[1]), json.loads(got_p[1])
    if dev == "cpu" and "stream_compiles" in jp:
        assert jp.pop("stream_compiles") == 0
        jr.pop("stream_compiles", None)
    assert jr == jp


SCENARIO_EXECUTOR = ("report/executor", "report/slo/stream_compiles",
                     "report/recovery/device_calls",
                     "report/recovery/host_batches")


@pytest.mark.parametrize("argv", [["--json"], ["--erasures", "4", "--json"],
                                  ["--no-arbiter", "--requests", "48"]],
                         ids=["day", "over_m", "control_text"])
def test_scenario_demo_matches_reference(argv, capsys):
    """The port's day on the device executor (CPU tensors) against the
    reference's host executor: equal but for the fields that name the
    executor (``SCENARIO_EXECUTOR``); the text of the host arm line for
    line."""
    dev = "cpu" if "--json" in argv else "host"
    got_r, got_p = both(capsys, "tools/scenario_demo.py", "scenario_demo",
                        argv, ("--device", dev))
    assert got_r[0] == got_p[0] == (2 if "4" in argv else 0)
    if dev == "host":
        assert got_r == got_p
        return
    jr, jp = json.loads(got_r[1]), json.loads(got_p[1])
    assert jp["report"]["executor"] == "device"
    for path in SCENARIO_EXECUTOR:
        pop_path(jr, path)
        pop_path(jp, path)
    assert jr == jp


def test_tenant_week_demo_matches_reference(capsys):
    """The default small week: the host arm's JSON equal to the
    reference's (whose demo runs the host executor), every gate on."""
    got_r, got_p = both(capsys, "tools/tenant_week_demo.py",
                        "tenant_week_demo", ["--json"], ("--device", "host"))
    assert got_r == got_p and got_p[0] == 0
    assert all(json.loads(got_p[1])["gates"].values())


# -- cluster_demo -----------------------------------------------------------

CLUSTER = ["--osds", "120", "--pgs", "128", "--events", "1", "--objects",
           "1", "--json"]
# fields that name the placement engine, and the heal's two counters
# that say where its decodes ran
CLUSTER_ENGINE = ("storm/engine", "balance/engine")
CLUSTER_HEAL = ("rateless/recovery/device_calls",
                "rateless/recovery/host_batches")


@pytest.mark.parametrize("extra,dev,rc", [
    ([], "cpu", 0), (["--erasures", "3"], "host", 2)],
    ids=["heal", "over_m"])
def test_cluster_demo_matches_reference(extra, dev, rc, capsys):
    """The reference's demo on its host placement engine (no jit
    compiles) against the port's bulk evaluator on CPU tensors: equal
    but for the engine names.  The reference's ``--device host`` heal
    is the port's ``host`` (equal counters); on ``cpu`` the port's heal
    runs the fused path, the reference's ``jax`` (the heal's
    device/host counters swap)."""
    R, P = ref_tool("tools/cluster_demo.py"), port_tool("cluster_demo")
    rc_r, out_r = call(capsys, REF, R.main, CLUSTER + extra
                       + ["--engine", "host"])
    rc_p, out_p = call(capsys, PORT, P.main, CLUSTER + extra
                       + ["--engine", "bulk", "--device", dev])
    assert rc_r == rc_p == rc
    jr, jp = json.loads(out_r), json.loads(out_p)
    assert jr["storm"]["engine"] == "host" and jp["storm"]["engine"] == "bulk"
    drop = CLUSTER_ENGINE + (CLUSTER_HEAL if dev == "cpu" else ())
    for path in drop:
        pop_path(jr, path)
        pop_path(jp, path)
    assert jr == jp


# -- device_chaos_demo, host_chaos_demo -------------------------------------

@pytest.fixture
def rs_only(monkeypatch):
    """Cut each chaos demo's day to the rs k=4 m=2 codec (both sides)."""
    def cut(mod):
        real = mod.default_scenario

        def scenario(**kw):
            base = real(**kw)
            return replace(base, traffic=replace(
                base.traffic, codecs=[base.traffic.codecs[0]]))
        monkeypatch.setattr(mod, "default_scenario", scenario)
    for rel, name in (("tools/device_chaos_demo.py", "device_chaos_demo"),
                      ("tools/host_chaos_demo.py", "host_chaos_demo")):
        cut(ref_tool(rel))
        cut(port_tool(name))


CHAOS = ["--requests", "12", "--objects", "1", "--json"]


def _chaos_equal(got_r, got_p):
    """The JSON equal but for ``slo.stream_compiles`` (the reference's
    jax compiles after warmup, the port's kernel setups: 0 here)."""
    jr, jp = json.loads(got_r[1]), json.loads(got_p[1])
    assert jp["report"]["slo"].pop("stream_compiles", 0) == 0
    jr["report"]["slo"].pop("stream_compiles", None)
    assert jr == jp
    return jp


@pytest.mark.parametrize("extra,rc", [
    ([], 0), (["--fault", "transient", "--corrupt"], 0),
    (["--erasures", "4"], 2)], ids=["loss", "transient_corrupt", "over_m"])
def test_device_chaos_demo_matches_reference(extra, rc, rs_only, capsys):
    """On CPU tensors the port demotes, completes on the numpy twin and
    re-promotes as the reference does."""
    got_r, got_p = both(capsys, "tools/device_chaos_demo.py",
                        "device_chaos_demo", CHAOS + extra)
    assert got_r[0] == got_p[0] == rc
    out = _chaos_equal(got_r, got_p)
    if rc == 0:
        assert out["gates"] and all(out["gates"].values())


def test_host_chaos_demo_matches_reference(rs_only, capsys, monkeypatch):
    """A plane of 8 members on both sides (the reference's 8 forced CPU
    devices, the port's ``CEPH_TPU_TORCH_VIRTUAL_DEVICES=8``)."""
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "8")
    got_r, got_p = both(capsys, "tools/host_chaos_demo.py",
                        "host_chaos_demo", CHAOS)
    assert got_r[0] == got_p[0] == 0
    out = _chaos_equal(got_r, got_p)
    assert all(out["gates"].values())


def test_host_chaos_demo_kill_one(capsys):
    """Two real worker processes on 4 virtual CPU members each; the
    victim is SIGKILLed mid-stream and the survivor quarantines its
    host.  The port alone (the reference's workers run jax); the demo
    bounds every wait, and the test bounds the whole run."""
    import threading
    P = port_tool("host_chaos_demo")
    result = {}
    t = threading.Thread(target=lambda: result.update(rc=P.main(
        ["--kill-one", "--json", "--device", "cpu", "--batches", "6"])),
        daemon=True)
    t.start()
    t.join(timeout=240)
    assert not t.is_alive(), "kill-one outlived 240 s"
    out = json.loads(capsys.readouterr().out)
    assert result["rc"] == 0, out
    assert all(out["gates"].values()) and out["victim_returncode"] == -9


# -- the examples -----------------------------------------------------------

def test_cluster_lifecycle_demo_matches_reference(capsys):
    R = ref_tool("examples/cluster_lifecycle_demo.py")
    P = port_tool("cluster_lifecycle_demo")
    got_r = call(capsys, REF, lambda argv: R.main(), None)
    got_p = call(capsys, PORT, P.main, ["--device", "cpu"])
    assert got_r == got_p and got_p[0] == 0
    assert got_p[1].splitlines()[-1] == "lifecycle demo OK"


def test_failure_recovery_demo_matches_reference(capsys):
    """The reference's example runs at import: executing its module is
    its run."""
    capsys.readouterr()
    with fresh(REF):
        spec = importlib.util.spec_from_file_location(
            "_refex_failure_recovery_demo",
            ROOT / "examples/failure_recovery_demo.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    want = capsys.readouterr().out
    rc, got = call(capsys, PORT, port_tool("failure_recovery_demo").main,
                   ["--device", "cpu"])
    assert rc == 0 and got == want and want.splitlines()[-1] == "OK"


@pytest.mark.parametrize("name", [
    "scrub_demo", "recovery_demo", "serve_demo", "scenario_demo",
    "tenant_week_demo", "cluster_demo", "device_chaos_demo",
    "host_chaos_demo", "cluster_lifecycle_demo", "failure_recovery_demo"])
def test_demos_need_a_card_by_default(name, capsys):
    """No flag: the card, and ``NoDeviceError`` without one."""
    from ceph_tpu_torch.utils.errors import NoDeviceError
    with pytest.raises(NoDeviceError), fresh(PORT):
        port_tool(name).main(["--kill-one"] if name == "host_chaos_demo"
                             else [])
