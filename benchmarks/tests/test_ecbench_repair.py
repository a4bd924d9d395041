"""The clay repair cell (``kinds/ec_repair.py``) and its plain reference
(``yardstick/clay.py``) on the CPU at tiny sizes: clean runs read
``correct``, every control and fault does not, the traced run reports
the cell's program metrics, a program without the repair entry fails
before anything is staged, and the reference agrees with the program
and with the cell's cost arithmetic."""

import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.telemetry.spans import global_tracer
from yardstick import costs, faults, harness, spec
from yardstick.clay import Clay
from yardstick.kinds import ec_repair

CELL = "clay_k8_m4_d11.repair_hbm"
PROFILE = {"plugin": "clay", "k": "8", "m": "4", "d": "11",
           "scalar_mds": "jerasure", "technique": "reed_sol_van"}


def _run(tiny, trace=False, fault=None, seed=2**31 + 401):
    global_tracer().reset()
    return harness.run_cell(tiny(spec.cell(CELL)), seed, 0.3, trace,
                            torch.device("cpu"), time.perf_counter(), fault)


def test_config_states_the_profile():
    cell = spec.cell(CELL)
    assert cell.config["profile"] == PROFILE
    assert cell.config["reduced"] == []
    assert cell.traffic["kind"] == "ec_repair"
    assert {m["name"] for m in cell.end_to_end} == {"degraded_read_gbps",
                                                    "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_clean_run_is_correct(trace, tiny):
    run, line = _run(tiny, trace)
    assert line["correct"], line["compared"]
    assert line["compared"]["mismatched_bytes"]["value"] == 0
    assert run.sampled > 0 and line["attempted"] > 0
    assert run.bound_by == "bytes"
    if trace:
        m = line["metrics"]
        assert m["repair_read_bytes_per_stripe.repair"]["value"] == 360448
        assert m["host_syncs_per_request.repair"]["value"] == 0
        for name in ("codec_self_ms.repair", "repair_plan_ms.repair",
                     "launches_per_request.repair"):
            assert m[name]["value"] >= 0
        assert global_tracer().totals()["clay.repair_plan"]["count"] == \
            line["attempted"]
    else:
        assert set(line["metrics"]) == {"degraded_read_gbps", "setup_s"}


@pytest.mark.parametrize("fault", faults.EC_FAULTS)
def test_controls_and_faults_read_incorrect(fault, tiny):
    _, line = _run(tiny, fault=fault)
    assert line["correct"] is False
    assert line["compared"]["mismatched_bytes"]["value"] > 0


def test_unknown_fault_is_refused(tiny):
    with pytest.raises(ValueError):
        _run(tiny, fault="nonesuch")


class _WithoutRepair:
    """The program's clay code as a commit without the repair entry has
    it: decode_chunks_torch takes no chunk_size."""

    def __init__(self, code):
        self.code = code

    def __getattr__(self, name):
        return getattr(self.code, name)

    def decode_chunks_torch(self, chunks, available, erased):
        return self.code.decode_chunks_torch(chunks, available, erased)


def test_without_the_repair_entry_it_fails_before_staging(tiny,
                                                          monkeypatch):
    real = ec_repair._codec
    monkeypatch.setattr(ec_repair, "_codec",
                        lambda p, d: _WithoutRepair(real(p, d)))

    def staged(*args):
        raise AssertionError("the reference encode ran")

    monkeypatch.setattr(Clay, "encode", staged)
    with pytest.raises(RuntimeError, match="no sub-chunk repair"):
        _run(tiny)


def test_reference_agrees_with_the_program():
    from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
    args = {k: v for k, v in PROFILE.items() if k != "plugin"}
    code = ErasureCodePluginRegistry.instance().factory("clay", args,
                                                        device="cpu")
    ref = Clay.from_profile(PROFILE)
    chunk = code.get_chunk_size(1 << 20)
    assert chunk == 131072 and chunk // ref.sub == 2048
    gen = torch.Generator().manual_seed(3)
    data = torch.randint(0, 256, (2, 8, 64 * 16), dtype=torch.uint8,
                         generator=gen)
    full = torch.cat([data, ref.encode(data)], dim=1)
    assert torch.equal(full[:, 8:], code.encode_chunks_torch(data))
    for lost in range(12):
        assert code.minimum_to_decode({lost}, set(range(12)) - {lost}) \
            == ec_repair._plan_of(ref, lost)
        reads = full[:, list(ref.helpers(lost))].reshape(2, 11, 64, 16)[
            :, :, ref.repair_planes(lost)].reshape(2, 11, -1)
        assert torch.equal(ref.repair(reads, lost)[:, 0], full[:, lost])


def test_cost_of_a_request():
    """At 2048 stripes of 131,072-byte chunks each repair moves 240
    sub-chunk rows of 2048 B a stripe and is bytes-bound at 0.3005 ms."""
    ref = Clay.from_profile(PROFILE)
    for lost in range(12):
        mat = ref.repair_composite(lost)
        assert mat.shape == (64, 176) and np.count_nonzero(mat) == 944
        cost = costs.gf_apply_cost(2048, 176, 64, 2048, mat)
        assert cost["bytes"] == 2048 * 240 * 2048
        t, by = costs.roofline_s(cost)
        assert by == "bytes" and t * 1e3 == pytest.approx(0.30049, abs=1e-5)
        assert 2000 < costs.gf_op_floor(mat) < 4000
