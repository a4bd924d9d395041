"""The comparison that decides ``correct`` fails where it should: each
cell runs clean, under its control (the plain reference in the
program's place with one guarantee broken) and under each fault planted
in the timed path, at a size the CPU holds, with the harness's look for
a card skipped."""

import pytest
import torch

from yardstick import faults, harness, spec

EC_CELLS = ["rs_k8_m3.write_hbm", "shec_k6_m3_c2.degraded_read_hbm",
            "rs_k8_m3.degraded_read_hbm"]
CASES = ([(c, None) for c in EC_CELLS + ["rs_k8_m3.remap"]]
         + [(c, f) for c in EC_CELLS for f in faults.EC_FAULTS]
         + [("rs_k8_m3.remap", f) for f in faults.REMAP_FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_correct_only_without_a_fault(name, fault, tiny):
    cell = tiny(spec.cell(name))
    if name == "rs_k8_m3.remap" and fault == "alter":
        cell.traffic["sample_pgs"] = 32   # every 64th pg is altered
    _, line = harness.run_cell(cell, 2**31 + 77, 0.3, False,
                               torch.device("cpu"), 0.0, fault)
    assert line["correct"] is (fault is None), line["compared"]
    assert line["attempted"] > 0
    assert list(line)[-1] == "compared"


def test_unknown_fault_is_refused(tiny):
    with pytest.raises(ValueError):
        harness.run_cell(tiny(spec.cell("rs_k8_m3.write_hbm")), 1, 0.1,
                         False, torch.device("cpu"), 0.0, "nonesuch")
