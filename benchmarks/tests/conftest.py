"""The benchmark's own tests, on the CPU at tiny sizes:

    python -m pytest benchmarks/tests -q

Cases that need the card carry the ``cuda`` marker and skip here."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(HERE), HERE]
# several test workers share the host's cores
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips (with a reason) where "
        "torch.cuda.is_available() is False")


def shrink(cell):
    """The cell at a size a CPU test holds: 4 stripes a request, 2
    slabs, a 24-OSD cluster with a 64-PG pool."""
    cell.traffic.update(stripes_per_request=4, sample_requests=3)
    if "slabs" in cell.traffic:
        cell.traffic["slabs"] = 2
    if cell.traffic["kind"] == "osdmap_churn":
        cell.config["cluster"].update(hosts=12, osds_per_host=2)
        cell.config["cluster"]["pool"]["pg_num"] = 64
        cell.traffic.update(sample_pgs=8, sample_epochs=3, max_down=1)
    return cell


@pytest.fixture
def tiny():
    return shrink
