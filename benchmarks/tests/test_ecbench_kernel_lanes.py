"""crush_kernel_lanes_pct.remap on the CPU: a traced remap run reads
nothing where the bulk evaluator's rule kernel did not run (a CPU map
takes the eager tier), 100 where its first rung went through the kernel's
wrapper (forced onto the CPU, where the wrapper runs its plain version),
and an untraced run reads nothing."""

import time

import pytest
import torch

from ceph_tpu_torch.crush import bulk
from ceph_tpu_torch.ops import crush_kernels
from ceph_tpu_torch.telemetry.spans import global_tracer
from yardstick import harness, spec

CELL = "rs_k8_m3.remap"
METRIC = "crush_kernel_lanes_pct.remap"


def _run(tiny, trace):
    global_tracer().reset()
    return harness.run_cell(tiny(spec.cell(CELL)), 2**31 + 223, 0.3, trace,
                            torch.device("cpu"), time.perf_counter())


def test_the_metric_is_declared_for_the_remap_cell():
    (entry,) = [m for m in spec.load_benchmark()["per_layer"]
                if m["name"] == METRIC]
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "crush_mappings_per_s"
    assert entry["layer"] == "bulk evaluator"
    assert METRIC in {m["name"] for m in spec.cell(CELL).per_layer}


@pytest.mark.parametrize("trace", [True, False])
def test_the_eager_tier_reads_nothing(tiny, trace):
    run, line = _run(tiny, trace)
    assert line["correct"]
    assert spec.reader(METRIC)(run) is None
    assert METRIC not in line["metrics"]


def test_the_kernels_first_rung_reads_every_lane(tiny, monkeypatch):
    monkeypatch.setattr(bulk, "_rule_kernel", crush_kernels.kernel_rule)
    run, line = _run(tiny, True)
    assert line["correct"]
    assert line["metrics"][METRIC]["value"] == 100.0
    assert line["metrics"]["crush_residue_lanes.remap"]["value"] == 0
    counts = global_tracer().totals()["crush.rung"]["counts"]
    assert counts["kernel_flagged"] == 0
