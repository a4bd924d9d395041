"""Port parity, the dense GF(2^w) kernel's data on clay k=8 m=4 d=11's
(64, 704) parity repair: its row program through the numpy interpreter
of tests/test_torch_dense.py (which mirrors the kernel's walk) against
ceph_tpu's Pallas kernel in interpret mode and its numpy region ops.
A file of its own: the reference's interpret-mode compile of 1568
coefficients takes about two minutes, which runs beside the other files.
"""

import numpy as np

from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops.gf_kernels import (
    BY_VALUE_MAX_PROG, dense_geometry, dense_program)
from test_torch_dense import _data, _pallas, interpret


def test_clay_repair_program_matches_pallas_and_regionops():
    """Clay k=8 m=4 d=11's (64, 704) repair of chunk 8: 512 of its 704
    columns nonzero, a row block per row, its nonzero columns in tiles;
    the program goes to the kernel through a device buffer."""
    clay = ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": "8", "m": "4", "d": "11"}, device="cpu")
    avail = tuple(i for i in range(12) if i != 8)
    mat, ms = clay._decode_composite(avail, (8,))
    assert mat.shape == (64, 704)
    assert int(np.count_nonzero(mat.any(axis=0))) == 512
    prog = dense_program(ms, 8)
    assert len(prog) > BY_VALUE_MAX_PROG
    assert dense_geometry(64, 704)[:2] == (64, 1)
    data = _data(8, (1, 704, 256))
    got = interpret(prog, data, 64, 8)
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))
    assert np.array_equal(got[..., :128], _pallas(mat, data[..., :128],
                                                  rows=16))
