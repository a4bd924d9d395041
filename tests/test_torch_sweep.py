"""The port's benchmark sweep (``ceph_tpu_torch.bench.sweep``) against
the reference's ``ceph_tpu.bench.sweep``, on the CPU: one JSON line per
grid cell, the same cells, the same soft-failed cells with the same
error texts.  A failure of the device is never soft: it propagates."""

from __future__ import annotations

import json

import pytest
import torch

from ceph_tpu.bench import sweep as ref_sweep
from ceph_tpu_torch.bench import sweep as port_sweep
from ceph_tpu_torch.utils.errors import (DeviceDispatchError,
                                         KernelLaunchError, NoDeviceError)

SMALL = ["--size", "16384", "--iterations", "1", "--batch", "2"]


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def _cells(lines):
    """The cells without their measurements."""
    return [{k: v for k, v in c.items()
             if k not in ("gbps", "seconds", "total_bytes")}
            for c in lines]


@pytest.mark.parametrize("argv", [
    ["--plugin", "jerasure", "--plugin", "lrc", "--km", "4,2"],
    ["--plugin", "lrc", "--km", "8,3", "--workload", "encode"],
    ["--plugin", "jerasure", "--km", "8,3", "--workload", "encode"],
    ["--plugin", "shec", "--plugin", "isa", "--km", "4,2", "--km", "8,4",
     "--workload", "decode"],
])
def test_grid_equals_reference(capsys, argv):
    """Host cells and CPU-tensor cells: the reference's lines (its host
    grid), the same soft failures with the same text; every other cell
    carries its measurement."""
    assert ref_sweep.main(argv + SMALL) == 0
    ref = _lines(capsys)
    for device in ("host", "cpu"):
        assert port_sweep.main(argv + SMALL + ["--device", device]) == 0
        port = _lines(capsys)
        assert _cells(port) == _cells(ref)
        assert [("gbps" in c) for c in port] == [("gbps" in c) for c in ref]
        assert [c.get("total_bytes") for c in port] == \
            [c.get("total_bytes") for c in ref]


def test_grid_shape_and_soft_failures(capsys):
    assert port_sweep.main(["--plugin", "jerasure", "--plugin", "lrc",
                            "--km", "4,2", "--device", "cpu"] + SMALL) == 0
    lines = _lines(capsys)
    # 4 jerasure techniques + lrc, x encode/decode
    assert len(lines) == 10 and all("gbps" in c for c in lines)
    assert {c["workload"] for c in lines} == {"encode", "decode"}
    assert port_sweep.main(["--plugin", "lrc", "--km", "8,3", "--workload",
                            "encode", "--device", "cpu"] + SMALL) == 0
    lines = _lines(capsys)
    assert len(lines) == 1 and "error" in lines[0]
    assert port_sweep.DEFAULT_GRID == ref_sweep.DEFAULT_GRID
    assert port_sweep.DEFAULT_KM == ref_sweep.DEFAULT_KM


def test_default_device_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        port_sweep.main(["--plugin", "jerasure", "--km", "4,2"] + SMALL)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("exc,soft", [
    (KernelLaunchError("launch failed", code=700), False),
    (DeviceDispatchError("engine.serve-encode", "backend_loss", "lost"),
     False),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("k=8 must be <= w=7"), True),
    (RuntimeError("profile rejected"), True),
])
def test_only_profile_errors_soft_fail(monkeypatch, capsys, exc, soft):
    def boom(self):
        raise exc
    monkeypatch.setattr(port_sweep.ErasureCodeBench, "run", boom)
    argv = ["--plugin", "isa", "--km", "4,2", "--workload", "encode",
            "--device", "cpu"] + SMALL
    if soft:
        assert port_sweep.main(argv) == 0
        lines = _lines(capsys)
        assert len(lines) == 2
        assert all(c["error"] == f"{type(exc).__name__}: {exc}"
                   for c in lines)
    else:
        with pytest.raises(type(exc)):
            port_sweep.main(argv)
