"""The port's repo-root tools (``ceph_tpu_torch.tools``: bulk_crush_row,
bench_diff, perf_dump, trace_view, replay_bisect) against the
reference's ``tools/*.py`` on the CPU.

Each reference tool is loaded by path and its ``main(argv)`` called
in-process (a subprocess would import jax again), from fresh
process-global state (tests/test_torch_demos.py's helpers); the port's
runs with
``--device cpu`` (or ``--device host``, the host arm, where the
reference's tool runs the host executor or host repairs).  The rc must
be equal, and the JSON key for key or the text line for line; each test
names the fields it leaves out (seconds, rates, host timings) and the
by-design differences it maps (the reference's "xla" tier is the
port's "torch").  The port's batcher jitter seam is held in
tests/test_torch_serve.py.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_demos import PORT, REF, ROOT, fresh, port_tool, ref_tool


def call(capsys, main, argv):
    """(rc, stdout, stderr) of an in-process ``main(argv)``, both
    packages' process-global state fresh (``fresh``): a fallback policy
    logs its tier once a process, and pattern caches count builds."""
    capsys.readouterr()
    with fresh(REF), fresh(PORT):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


# -- bulk_crush_row ---------------------------------------------------------

@pytest.mark.parametrize("ec", [False, True], ids=["firstn", "ec_indep"])
def test_bulk_crush_row_mappings_and_line(ec, capsys, monkeypatch):
    """At n = 4096: the port's ``run(ec, n, "cpu")`` maps every x as the
    reference's ``bulk_do_rule`` does in its tool's own sweep, on the
    same map and rule; the printed lines have the same keys, metric,
    unit and n (``value`` and ``seconds`` are a rate and a time, left
    out).  The reference's tool runs at n through its module's numpy,
    shimmed so that ``np.arange(1_000_000)`` yields n; its sweeps are
    recorded through a wrapper of its ``bulk`` module."""
    from ceph_tpu.crush import bulk as ref_bulk

    n = 4096
    R, P = ref_tool("tools/bulk_crush_row.py"), port_tool("bulk_crush_row")
    swept = []

    def record(*args, **kw):
        out = ref_bulk.bulk_do_rule(*args, **kw)
        swept.append(np.asarray(out[0]))
        return out
    monkeypatch.setattr(R, "np", SimpleNamespace(
        arange=lambda m: np.arange(min(m, n))))
    monkeypatch.setattr(R, "bulk", SimpleNamespace(
        CompiledCrushMap=ref_bulk.CompiledCrushMap, bulk_do_rule=record))
    monkeypatch.setattr(sys, "argv", ["bulk_crush_row.py"]
                        + (["--ec"] if ec else []))
    rc_r, out_r, _ = call(capsys, lambda argv: R.main(), None)
    monkeypatch.setattr(P, "SWEEP_X", n)
    rc_p, out_p, _ = call(capsys, P.main,
                          (["--ec"] if ec else []) + ["--device", "cpu"])
    assert rc_r == rc_p == 0
    lr, lp = json.loads(out_r), json.loads(out_p)
    assert sorted(lr) == sorted(lp)
    for k in ("value", "seconds"):
        assert lp[k] > 0
        lr.pop(k), lp.pop(k)
    assert lr == lp and lp["n"] == n

    row = P.run(ec, n=n, device="cpu")
    assert len(swept) == 2 and np.array_equal(swept[0], swept[1])
    assert row["mappings"].shape == swept[1].shape == (n, 6 if ec else 3)
    assert np.array_equal(np.asarray(row["mappings"]), swept[1])


def test_bulk_crush_row_needs_a_card_by_default():
    from ceph_tpu_torch.utils.errors import NoDeviceError
    with pytest.raises(NoDeviceError):
        port_tool("bulk_crush_row").run(False, n=16)


# -- bench_diff -------------------------------------------------------------

FIXTURES = sorted(ROOT.glob("BENCH_r*.json")) + [ROOT / "BENCH_LAST_GOOD.json"]


def _fixture_dir(tmp_path, extra: dict = None, candidate: dict = None,
                 fixtures: bool = True):
    """A trajectory directory of the repo's BENCH_* records, used as
    parsing fixtures only (they are the TPU's records, not the port's)."""
    for f in FIXTURES if fixtures else ():
        (tmp_path / f.name).write_text(f.read_text())
    for name, rec in (extra or {}).items():
        (tmp_path / name).write_text(json.dumps(rec))
    if candidate is not None:
        (tmp_path / "cand.json").write_text(json.dumps(candidate))
    return tmp_path


@pytest.mark.parametrize("argv", [
    [], ["--json"], ["--floor", "headline=0.01", "--json"],
    ["--floor", "decode=0.5"], ["--floor", "bogus"],
    ["--floor", "headline=x"]], ids=["text", "json", "tight", "loose",
                                     "bad_spec", "bad_frac"])
def test_bench_diff_matches_reference(argv, tmp_path, capsys):
    d = _fixture_dir(tmp_path)
    R, P = ref_tool("tools/bench_diff.py"), port_tool("bench_diff")
    got_r = call(capsys, R.main, ["--repo", str(d)] + argv)
    got_p = call(capsys, P.main, ["--repo", str(d)] + argv)
    assert got_r[0] == got_p[0]
    assert got_r[1] == got_p[1]
    if got_r[0] == 2:       # usage errors: argparse's text, same prog
        assert got_r[2].splitlines()[-1].split(": ", 1)[1] == \
            got_p[2].splitlines()[-1].split(": ", 1)[1]
    else:
        assert got_r[2] == got_p[2]


def test_bench_diff_series_equal_on_every_fixture():
    R, P = ref_tool("tools/bench_diff.py"), port_tool("bench_diff")
    traj_r = R.load_trajectory(str(ROOT))
    traj_p = P.load_trajectory(str(ROOT))
    assert traj_r == traj_p and traj_r
    for _, rec in traj_r:
        assert R.extract_series(rec) == P.extract_series(rec)


def test_bench_diff_empty_and_default_dirs(tmp_path, capsys):
    """No trajectory: rc 3; the port's default directory is its own
    (``bench_records/``), never the repo root's TPU records."""
    R, P = ref_tool("tools/bench_diff.py"), port_tool("bench_diff")
    for argv in (["--repo", str(tmp_path)], ["--repo", str(tmp_path),
                                            "--json"]):
        assert call(capsys, R.main, argv) == call(capsys, P.main, argv)
    assert Path(P.REPO).name == "bench_records"
    assert Path(P.REPO).resolve() != ROOT


def _host_chaos_record(value: float, gbps: float) -> dict:
    return {"metric": "encode_gbps", "value": value,
            "git_sha": f"sha{value}", "timestamp": f"t{value}",
            "host_chaos_rows": {
                "rs_k4_m2_host_chaos": {"gbps": gbps, "lat_p50_ms": 1.0},
                "zero": {"gbps": 0.0}}}


@pytest.mark.parametrize("cur", [0.50, 0.40, 1.80],
                         ids=["within_floor", "regression", "improvement"])
def test_bench_diff_host_chaos_category(cur, tmp_path, capsys):
    """The host-chaos category: ``host_chaos_rows`` become
    ``host_chaos:<row>`` series (a zero row is no sample) under the
    category's 0.55 floor — a drop past it is a regression (rc 4), as in
    the reference."""
    R, P = ref_tool("tools/bench_diff.py"), port_tool("bench_diff")
    assert P.FLOORS["host_chaos"] == R.FLOORS["host_chaos"] == 0.55
    prior = _host_chaos_record(100.0, 1.0)
    assert P.extract_series(prior) == R.extract_series(prior) == {
        "headline": 100.0, "host_chaos:rs_k4_m2_host_chaos": 1.0}
    d = _fixture_dir(tmp_path, {"BENCH_r90.json": {"parsed": prior}},
                     _host_chaos_record(101.0, cur), fixtures=False)
    argv = ["--repo", str(d), "--candidate", str(d / "cand.json"),
            "--json"]
    got_r = call(capsys, R.main, argv)
    got_p = call(capsys, P.main, argv)
    assert got_r == got_p
    rep = json.loads(got_p[1])
    row = next(r for r in rep["rows"]
               if r["row"] == "host_chaos:rs_k4_m2_host_chaos")
    status = {0.50: "ok", 0.40: "regression", 1.80: "improvement"}[cur]
    assert row["status"] == status and row["noise_floor"] == 0.55
    assert got_p[0] == (4 if status == "regression" else 0)


# -- perf_dump --------------------------------------------------------------

# the reference's tier names -> the port's
TIERS = {"xla": "torch", "pallas": "cuda"}
# series only one package has, by design: the port dispatches the ops
# tier through ``ops_apply_matrix`` where the reference inlines it; the
# port's profiler costs are analytic (the reference's come from XLA)
PORT_ONLY = ("ops_apply_matrix_",)
CAPTURES = "profiler_captures{"


def _norm_series(name: str) -> str:
    """A series name (dump or Prometheus form) with tiers mapped."""
    for a, b in TIERS.items():
        for key in ("engine", "tier"):
            name = name.replace(f"{key}={a}", f"{key}={b}")
            name = name.replace(f'{key}="{a}"', f'{key}="{b}"')
    return name


# clay's batch encode runs through the matrix codes' host rule in the
# port, where the reference's clay counts no host call (ROADMAP, Queue
# C's deliberate differences): a stream that serves clay counts more
# host calls and bytes, the same bytes out
CLAY_COUNTED = ("ec_host_", "ec_apply_calls{path=host}",
                "ec_apply_seconds{path=host}")


def _norm_dump(dump: dict, drop: tuple = ()) -> dict:
    """A perf dump in comparable form: the perf-counter registry under
    one name, tier names mapped, the port-only and source-labelled
    profiler series and the ``drop`` prefixes dropped, events' engines
    mapped."""
    out = {}
    for sec, body in dump.items():
        if sec in ("ceph_tpu", "ceph_tpu_torch"):
            sec = "perf"
            body = {k: v for k, v in body.items()
                    if not k.startswith(drop)}
        if sec == "ceph_tpu_telemetry":
            norm = {}
            for k, v in body.items():
                if k.startswith(PORT_ONLY + (CAPTURES,) + drop):
                    continue
                if k == "__events__":
                    v = [dict(e, engine=TIERS.get(e.get("engine"),
                                                  e.get("engine")))
                         if "engine" in e else e for e in v]
                norm[_norm_series(k)] = v
            body = norm
        out[sec] = body
    return out


@pytest.mark.parametrize("argv,device", [
    (["--scenario", "recovery-churn", "--fake-clock", "--validate"],
     "cpu"),
    (["--scenario", "repair", "--fake-clock", "--validate",
      "--format", "both"], "cpu"),
    (["--scenario", "unrecoverable", "--fake-clock", "--flight-recorder",
      "--validate"], "cpu"),
    (["--scenario", "traced-day", "--fake-clock", "--validate",
      "--requests", "24"], "host"),
], ids=["recovery_churn", "repair_prom", "unrecoverable", "traced_day"])
def test_perf_dump_fake_clock_matches_reference(argv, device, capsys):
    """Under --fake-clock the dumps are deterministic: the port's equals
    the reference's after the tier-name map (``_norm_dump``); the
    Prometheus text of ``--format both`` is compared series by series
    the same way.  The traced day runs the host executor on both sides
    (the reference's tool does)."""
    R, P = ref_tool("tools/perf_dump.py"), port_tool("perf_dump")
    rc_r, out_r, err_r = call(capsys, R.main, argv)
    rc_p, out_p, err_p = call(capsys, P.main, argv + ["--device", device])
    assert rc_r == rc_p == 0, (err_r[-500:], err_p[-500:])
    jr = json.loads(out_r.split("\n# ")[0].splitlines()[0])
    jp = json.loads(out_p.split("\n# ")[0].splitlines()[0])
    drop = CLAY_COUNTED if "traced-day" in argv else ()
    assert _norm_dump(jr, drop) == _norm_dump(jp, drop)
    if "both" in argv:
        def prom(text):
            return sorted(_norm_series(ln) for ln in text.splitlines()[1:]
                          if ln and not any(s in ln for s in
                                            PORT_ONLY + ("profiler_captures",
                                                         "ops_apply_matrix")))
        assert prom(out_r) == prom(out_p)


def test_perf_dump_real_clock_both_validates(capsys):
    """The real clock: rc 0 and a schema-valid dump on both sides with
    the same series names (values there are host times, left out); the
    port's dump carries ``kernel_setups`` where the reference's compile
    monitor would be."""
    R, P = ref_tool("tools/perf_dump.py"), port_tool("perf_dump")
    argv = ["--scenario", "both", "--validate"]
    rc_r, out_r, _ = call(capsys, R.main, argv)
    rc_p, out_p, _ = call(capsys, P.main, argv + ["--device", "cpu"])
    assert rc_r == rc_p == 0
    jr, jp = _norm_dump(json.loads(out_r)), _norm_dump(json.loads(out_p))
    assert sorted(jr) == sorted(jp)
    tel_r = {k for k in jr["ceph_tpu_telemetry"]
             if "compile" not in k and "__events__" != k}
    tel_p = set(jp["ceph_tpu_telemetry"]) - {"__events__"}
    assert "kernel_setups" in tel_p
    assert tel_r == tel_p - {"kernel_setups"}
    assert jr["perf"].keys() == jp["perf"].keys()


def test_perf_dump_profile_filtered_and_coverage_gate(capsys, monkeypatch):
    """``--profile`` over one entry on both sides: rc 0, one row of that
    name.  An unfiltered sweep whose device entry makes no row is rc 1
    (the port's sweep stubbed to lose one)."""
    R, P = ref_tool("tools/perf_dump.py"), port_tool("perf_dump")
    argv = ["--scenario", "none", "--profile", "--profile-filter",
            "jerasure.encode_chunks_jax", "--fake-clock", "--validate"]
    rc_r, out_r, _ = call(capsys, R.main, argv)
    rc_p, out_p, _ = call(capsys, P.main, argv + ["--device", "cpu"])
    assert rc_r == rc_p == 0
    names = [sorted({r["name"] for r in json.loads(o)["profile"]["rows"]})
             for o in (out_r, out_p)]
    assert names[0] == names[1] == ["jerasure.encode_chunks_jax"]

    from ceph_tpu_torch import telemetry
    real = telemetry.profile_entrypoints

    def lose_one(filters=(), **kw):
        rows, failed = real(filters=("jerasure.encode_chunks_jax",), **kw)
        return rows, failed
    monkeypatch.setattr(telemetry, "profile_entrypoints", lose_one)
    rc, _, err = call(capsys, P.main, ["--scenario", "none", "--profile",
                                       "--device", "cpu"])
    assert rc == 1 and "no attribution row" in err


def test_perf_dump_check_overhead_keys():
    """Both sides report the interleaved on/off verdict with the same
    keys (``check_overhead`` at one repeat a series, the CLI's five cost
    a minute here); the port adds both series and its device.  The
    times are host times (left out); the threshold is set so that noise
    cannot fail the test."""
    R, P = ref_tool("tools/perf_dump.py"), port_tool("perf_dump")
    jr = R.check_overhead(1000.0, reps=1)
    jp = P.check_overhead(1000.0, reps=1, device="cpu")
    assert set(jp) == set(jr) | {"enabled_series_s", "disabled_series_s",
                                 "device"}
    assert len(jp["enabled_series_s"]) == len(jp["disabled_series_s"]) == 1
    assert min(jp["enabled_series_s"]) == jp["enabled_s"]
    for k in ("traced", "threshold_pct", "ok"):
        assert jr[k] == jp[k]


def test_perf_dump_needs_a_card_by_default(capsys):
    from ceph_tpu_torch.utils.errors import NoDeviceError
    with pytest.raises(NoDeviceError):
        port_tool("perf_dump").main(["--scenario", "repair"])


# -- trace_view -------------------------------------------------------------

def test_trace_view_check_and_summary(tmp_path, capsys):
    """``--run-scenario --check`` and the summary: the same rc and the
    same text; the dump (``--json``) and the Chrome timeline equal the
    reference's.  The port runs the host executor (``--device host``),
    as the reference's tool does.  The device executor on CPU tensors
    gives the same traces but for the two fields that name the executor
    (a fire's ``executor``, the ``program`` event's ``series``)."""
    R, P = ref_tool("tools/trace_view.py"), port_tool("trace_view")
    base = ["--run-scenario", "--requests", "32"]
    for argv in (base + ["--check"], base + ["--top", "3"]):
        got_r = call(capsys, R.main, argv)
        got_p = call(capsys, P.main, argv + ["--device", "host"])
        assert got_r[:2] == got_p[:2] and got_r[0] == 0
    files = {}
    for side, main, extra in (("ref", R.main, []),
                              ("host", P.main, ["--device", "host"]),
                              ("cpu", P.main, ["--device", "cpu"])):
        js, ch = tmp_path / f"{side}.json", tmp_path / f"{side}.trace"
        rc, _, _ = call(capsys, main, base + ["--json", str(js),
                                              "--chrome", str(ch)] + extra)
        assert rc == 0
        files[side] = (js.read_text(), ch.read_text())
    assert files["ref"] == files["host"]

    def executor_free(text):
        dump = json.loads(text)
        for tr in dump["traces"]:
            for ev in tr["events"]:
                ev.pop("executor", None)
                if ev["name"] == "program":
                    ev.pop("series")
        return dump
    assert executor_free(files["host"][0]) == executor_free(files["cpu"][0])
    # the file mode reads the dump back
    assert call(capsys, R.main, [str(tmp_path / "ref.json"), "--check"]) \
        == call(capsys, P.main, [str(tmp_path / "host.json"), "--check"])


def test_trace_view_usage_errors(tmp_path, capsys):
    R, P = ref_tool("tools/trace_view.py"), port_tool("trace_view")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nothing": 1}))
    for argv in ([], [str(bad)]):
        rc_r, out_r, _ = call(capsys, R.main, argv)
        rc_p, out_p, _ = call(capsys, P.main, argv)
        assert rc_r == rc_p != 0 and out_r == out_p


# -- replay_bisect ----------------------------------------------------------

def test_replay_bisect_jitter_localized_as_reference(capsys):
    """One day of the week run twice, run B under --inject-jitter: both
    packages localize the divergence to the same checkpoint (label,
    index, probes, payloads).  The reference's week runs the host
    executor; the port's the device executor on CPU tensors
    (``--device cpu``), whose dispatch log equals it."""
    R, P = ref_tool("tools/replay_bisect.py"), port_tool("replay_bisect")
    argv = ["--days", "1", "--day-s", "3", "--json", "--inject-jitter"]
    rc_r, out_r, _ = call(capsys, R.main, argv)
    rc_p, out_p, _ = call(capsys, P.main, argv + ["--device", "cpu"])
    assert rc_r == rc_p == 0
    vr, vp = json.loads(out_r), json.loads(out_p)
    assert vr == vp and vp["identical"] is False
    assert vp["divergence"]["label_a"].startswith("dispatch[")


def test_replay_bisect_clean_matches_reference_text(capsys):
    """Without a hook the two runs are identical (rc 0), the text line
    for line as the reference's (the port's host arm)."""
    R, P = ref_tool("tools/replay_bisect.py"), port_tool("replay_bisect")
    argv = ["--days", "1", "--day-s", "2"]
    got_r = call(capsys, R.main, argv)
    got_p = call(capsys, P.main, argv + ["--device", "host"])
    assert got_r == got_p and got_p[0] == 0
    assert "deterministic" in got_p[1]
