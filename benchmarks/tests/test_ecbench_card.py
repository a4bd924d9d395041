"""Every cell at a tiny size on the card, through the card's own path
(CUDA events, the profiler's device trace); skips without one."""

import pytest
import torch

from yardstick import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for trace in (False, True):
        _, line = harness.run_cell(tiny(spec.cell(name)), 2**31 + 3, 0.5,
                                   trace, torch.device("cuda", 0), 0.0)
        assert line["correct"], line["compared"]
        assert line["device"]["platform"] == "gpu"
        if trace:
            assert line["device"]["busy_s"] > 0
