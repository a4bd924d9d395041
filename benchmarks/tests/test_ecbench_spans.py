"""The program's own spans and counts in each cell: a traced run on the
CPU (its profiler session arms the program's span sites) reports every
span-read metric of the cell, and as many root spans as it attempted
requests; an untraced run arms nothing and reports none of them."""

import time

import pytest
import torch

from ceph_tpu_torch.telemetry.spans import global_tracer
from yardstick import harness, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = {m["name"] for m in BENCH["per_layer"]
                if m["source"] == "program_span"
                or m["name"].startswith(("host_syncs_per_request.",
                                         "crush_residue_lanes."))}
ROOT = {"encode": "codec.encode", "decode": "codec.decode",
        "remap": "osdmap.pg_to_up_bulk"}


def _run(name, tiny, trace):
    global_tracer().reset()
    return harness.run_cell(tiny(spec.cell(name)), 2**31 + 211, 0.3, trace,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_program_spans(name, tiny):
    run, line = _run(name, tiny, True)
    assert line["correct"]
    want = {m["name"] for m in spec.cell(name).per_layer} & SPAN_METRICS
    assert len(want) >= 3
    assert want <= set(line["metrics"])
    for m in want:
        assert line["metrics"][m]["value"] >= 0
    totals = global_tracer().totals()
    assert totals[ROOT[run.op]]["count"] == line["attempted"]
    syncs = [line["metrics"][m]["value"] for m in want
             if m.startswith("host_syncs_per_request.")]
    assert len(syncs) == 1
    # the codec paths note no host sync; an epoch notes its syncs
    assert (syncs[0] > 0) == (run.op == "remap")


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_none(name, tiny):
    run, line = _run(name, tiny, False)
    assert line["correct"]
    assert global_tracer().totals() == {}
    for m in spec.cell(name).per_layer:
        if m["name"] in SPAN_METRICS:
            assert spec.reader(m["name"])(run) is None
    assert not set(line["metrics"]) & SPAN_METRICS
