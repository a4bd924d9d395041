"""Sharded erasure-code compute and sharded bulk CRUSH of the port
(``ceph_tpu_torch.parallel``) against the reference's
(``tests/test_parallel.py``) on the CPU: the reference on its 8 forced
CPU devices, the port on 8 virtual CPU members
(``CEPH_TPU_TORCH_VIRTUAL_DEVICES=8``), the same seeded inputs, byte
for byte (CRUSH: lane for lane)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.matrices.jerasure import \
    reed_sol_vandermonde_coding_matrix as ref_rs
from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.parallel import make_mesh as ref_make_mesh
from ceph_tpu.parallel import sharded_encode as ref_sharded_encode
from ceph_tpu.parallel import sharded_roundtrip_step as ref_roundtrip
from ceph_tpu_torch.matrices.jerasure import \
    reed_sol_vandermonde_coding_matrix
from ceph_tpu_torch.parallel import (make_mesh, sharded_encode,
                                     sharded_roundtrip_step)
from ceph_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV
from ceph_tpu_torch.utils.shard import last_partition


@pytest.fixture(autouse=True)
def eight_members(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape == {"stripe": 2, "chunk": 4}
    mesh = make_mesh(8, tp=2)
    assert mesh.shape == {"stripe": 4, "chunk": 2}
    assert mesh.members("stripe") == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        make_mesh(9)  # more than available devices


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_encode_matches_reference(tp):
    k, m, c = 8, 3, 256
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(8, k, c), dtype=np.uint8)
    matrix = reed_sol_vandermonde_coding_matrix(k, m, 8)
    parity = sharded_encode(make_mesh(8, tp=tp), data, matrix).numpy()
    assert last_partition() == [8 // (8 // tp)] * (8 // tp)
    ref = np.asarray(ref_sharded_encode(ref_make_mesh(8, tp=tp), data,
                                        ref_rs(k, m, 8)))
    np.testing.assert_array_equal(parity, ref)
    np.testing.assert_array_equal(
        parity, ref_regionops.matrix_encode(data, ref_rs(k, m, 8), 8))


def test_sharded_encode_pads_a_non_dividing_batch():
    data = np.random.default_rng(2).integers(0, 256, (5, 8, 512),
                                             dtype=np.uint8)
    matrix = reed_sol_vandermonde_coding_matrix(8, 3, 8)
    parity = sharded_encode(make_mesh(8, tp=2), torch.from_numpy(data),
                            matrix)
    assert parity.shape == (5, 3, 512)
    np.testing.assert_array_equal(
        parity.numpy(), ref_regionops.matrix_encode(data, ref_rs(8, 3, 8),
                                                    8))


def test_sharded_roundtrip():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(4, 8, 512), dtype=np.uint8)
    decoded, parity = sharded_roundtrip_step(make_mesh(8), data, m=3)
    np.testing.assert_array_equal(decoded.numpy(), data)
    assert tuple(parity.shape) == (4, 3, 512)
    ref_dec, ref_par = ref_roundtrip(ref_make_mesh(8), data, m=3)
    np.testing.assert_array_equal(parity.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(decoded.numpy(), np.asarray(ref_dec))


def _crush_mesh():
    from ceph_tpu_torch.parallel.sharded_crush import default_crush_mesh
    mesh = default_crush_mesh(kind="cpu")
    assert mesh.shape == {"x": 8}
    return mesh


def test_sharded_bulk_crush_matches_host():
    """The x sweep sharded over 8 members equals the host mapper and
    the single-device bulk sweep (an odd N pads by repetition)."""
    from ceph_tpu_torch.crush import CrushBuilder, crush_do_rule
    from ceph_tpu_torch.crush.bulk import bulk_do_rule
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.parallel.sharded_crush import sharded_bulk_do_rule

    b = CrushBuilder()
    root = b.build_two_level(5, 3)
    b.add_simple_rule(0, root, "host", firstn=True)
    b.add_simple_rule(1, root, "host", firstn=False)
    for ruleno in (0, 1):
        out, cnt = sharded_bulk_do_rule(_crush_mesh(), b.map, ruleno,
                                        np.arange(301), 3, device="cpu")
        assert out.shape == (301, 3)
        one, _ = bulk_do_rule(b.map, ruleno, np.arange(301), 3,
                              device="cpu", mesh=0)
        np.testing.assert_array_equal(out, one)
        for x in range(301):
            ref = crush_do_rule(b.map, ruleno, x, 3)
            ref = ref + [CRUSH_ITEM_NONE] * (3 - len(ref))
            assert list(out[x]) == ref, (ruleno, x)


def _chained(W):
    import importlib
    crush = importlib.import_module(f"{W}.crush")
    types = importlib.import_module(f"{W}.crush.types")
    b = crush.CrushBuilder()
    b.add_type(1, "host")
    b.add_type(2, "rack")
    b.add_type(3, "root")
    racks = []
    d = 0
    for _ in range(3):
        hosts = []
        for _ in range(2):
            hosts.append(b.add_bucket("straw2", "host", [d, d + 1]))
            d += 2
        racks.append(b.add_bucket("straw2", "rack", hosts))
    root = b.add_bucket("straw2", "root", racks)
    b.add_rule(0, [crush.step_take(root), crush.step_choose_indep(0, 2),
                   crush.step_chooseleaf_indep(1, 1), crush.step_emit()])
    args = {root: types.ChooseArg(weight_set=[[0x8000, 0x20000,
                                               0x10000]])}
    return crush, b, args


def test_sharded_bulk_crush_chained_and_choose_args():
    """A chained indep rule with a choose_args weight set: the port's
    sharded sweep equals the reference's sharded sweep, lane for lane,
    and the host mapper."""
    import jax
    from jax.sharding import Mesh
    from ceph_tpu.parallel.sharded_crush import \
        sharded_bulk_do_rule as ref_sharded
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.parallel.sharded_crush import sharded_bulk_do_rule

    crush, b, args = _chained("ceph_tpu_torch")
    out, cnt = sharded_bulk_do_rule(_crush_mesh(), b.map, 0,
                                    np.arange(160), 3, choose_args=args,
                                    device="cpu")
    for x in range(160):
        ref = crush.crush_do_rule(b.map, 0, x, 3, choose_args=args)
        ref = ref + [CRUSH_ITEM_NONE] * (3 - len(ref))
        assert list(out[x]) == ref, x
    _, rb, rargs = _chained("ceph_tpu")
    ref_out, ref_cnt = ref_sharded(Mesh(np.array(jax.devices()), ("x",)),
                                   rb.map, 0, np.arange(160), 3,
                                   choose_args=rargs)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    np.testing.assert_array_equal(cnt, np.asarray(ref_cnt))


def test_sharded_bench_child_partitions():
    """The port's tools/sharded_bench.py child at a tiny size: sane
    numbers and the per-member stripe partition exactly 1/N."""
    import ceph_tpu_torch.tools.sharded_bench as sb

    old = (sb.LANES, sb.ENC_BATCH, sb.ENC_LOOP, sb.ENC_CHUNK)
    sb.LANES, sb.ENC_BATCH, sb.ENC_LOOP, sb.ENC_CHUNK = 4096, 4, 2, 4096
    try:
        row = sb.child(2, "cpu")
    finally:
        sb.LANES, sb.ENC_BATCH, sb.ENC_LOOP, sb.ENC_CHUNK = old
    assert row["n_devices"] == 2 and row["physical_devices"] == 1
    assert row["crush_mappings_per_s"] > 0
    assert row["encode_gbps"] > 0
    assert row["encode_stripes_per_device"] == [4, 4]
