"""The port's ``ceph_erasure_code`` tool (``ceph_tpu_torch.bench.
erasure_code_tool``) and critical-path analyzer (``ceph_tpu_torch.
telemetry.analyzer``), held to the reference's on the CPU: the tool's
output and exit codes, and the analyzer's decomposition, tail shares,
report and timeline on seeded trace dumps."""

import json

import pytest

from ceph_tpu.bench import erasure_code_tool as ref_tool
from ceph_tpu.telemetry import analyzer as ref_analyzer
from ceph_tpu_torch.bench import erasure_code_tool as port_tool
from ceph_tpu_torch.telemetry import analyzer as port_analyzer


@pytest.mark.parametrize("argv,rc", [
    (["--plugin_exists", "jerasure"], 0),
    (["--plugin_exists", "clay"], 0),
    (["--plugin_exists", "nosuchplugin"], 1),
    (["--plugin", "jerasure", "-P", "k=4", "-P", "m=2",
      "-P", "technique=reed_sol_van"], 0),
    (["--plugin", "jerasure", "-P", "k=4", "-P", "m=2", "--all"], 0),
    (["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2",
      "--all"], 0),
    (["--plugin", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5",
      "--all"], 0),
    (["--plugin", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3",
      "--all"], 0),
    (["--plugin", "isa", "-P", "k=8", "-P", "m=3",
      "-P", "technique=cauchy", "--all"], 0),
    (["--plugin", "jerasure", "-P", "k=1", "-P", "m=2"], 1),
])
def test_tool_equals_the_reference(capsys, argv, rc):
    """The same exit code and standard output; a failure names the
    plugin and profile on standard error on both sides."""
    assert port_tool.main(argv + ["--device", "cpu"]) == rc
    port = capsys.readouterr()
    assert ref_tool.main(argv) == rc
    ref = capsys.readouterr()
    assert port.out == ref.out
    if rc:
        assert port.err.split(":")[0] == ref.err.split(":")[0]


def test_tool_runs_on_the_card_unless_asked():
    """Without --device the code is made for the card: on a host
    without one, initialization fails as a profile error would."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_tool.main(["--plugin", "jerasure", "-P", "k=4",
                           "-P", "m=2"]) == 1


def _reference_dump(seed, n_requests):
    """A seeded trace dump of the reference's composed scenario (client
    traffic, background recovery and scrub, QoS decisions) on a
    FakeClock, host executor."""
    from ceph_tpu.scenario.runner import run_scenario
    from ceph_tpu.scenario.spec import default_scenario
    from ceph_tpu.serve import throughput_service_model
    from ceph_tpu.telemetry import tracing
    from ceph_tpu.utils.retry import FakeClock
    clock = FakeClock()
    coll = tracing.TraceCollector(clock=clock, seed=seed)
    prev = tracing.install(coll)
    try:
        run_scenario(default_scenario(seed=seed, n_requests=n_requests,
                                      damaged_objects=3, storm_events=4),
                     clock=clock, executor="host",
                     service_model=throughput_service_model())
    finally:
        tracing.install(prev)
    return coll.to_dict()


def _port_dump(seed, n_requests):
    """A seeded trace dump of the port's serving stream on a FakeClock,
    host executor."""
    from ceph_tpu_torch.serve import (default_spec, run_serving_scenario,
                                      throughput_service_model)
    from ceph_tpu_torch.telemetry import tracing
    from ceph_tpu_torch.utils.retry import FakeClock
    clock = FakeClock()
    coll = tracing.TraceCollector(clock=clock, seed=seed)
    prev = tracing.install(coll)
    try:
        run_serving_scenario(
            default_spec(seed=seed, n_requests=n_requests, stripe_size=4096),
            clock=clock, executor="host",
            service_model=throughput_service_model())
    finally:
        tracing.install(prev)
    return coll.to_dict()


@pytest.mark.parametrize("make_dump,seed", [
    (_reference_dump, 3), (_reference_dump, 11), (_port_dump, 5),
    (_port_dump, 42)])
def test_analyzer_equals_the_reference(make_dump, seed):
    """decompose_all, tail_attribution, tail_shares, analyze and
    chrome_trace equal the reference's on the same dump; the segments
    sum exactly to each trace's end-to-end time."""
    dump = json.loads(json.dumps(make_dump(seed, 48)))
    rows = port_analyzer.decompose_all(dump)
    assert rows and rows == ref_analyzer.decompose_all(dump)
    for row in rows:
        assert sum(row["segments"].values()) == row["end_to_end_ns"]
    for label in ("p50", "p99", "p999"):
        assert port_analyzer.tail_shares(rows, label) == \
            ref_analyzer.tail_shares(rows, label)
    assert port_analyzer.tail_attribution(rows) == \
        ref_analyzer.tail_attribution(rows)
    assert json.dumps(port_analyzer.analyze(dump), sort_keys=True) == \
        json.dumps(ref_analyzer.analyze(dump), sort_keys=True)
    assert json.dumps(port_analyzer.chrome_trace(dump), sort_keys=True) == \
        json.dumps(ref_analyzer.chrome_trace(dump), sort_keys=True)


def test_analyzer_on_an_empty_dump():
    from ceph_tpu_torch.telemetry.tracing import TraceCollector
    dump = TraceCollector(seed=1).to_dict()
    assert port_analyzer.decompose_all(dump) == []
    assert port_analyzer.tail_shares([], "p99") == \
        ref_analyzer.tail_shares([], "p99")
