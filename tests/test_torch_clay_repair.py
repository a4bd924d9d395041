"""Clay's single-chunk repair on the device surface of the port
(``decode_chunks_torch(planes, helpers, (lost,), chunk_size=C)``), on
the CPU at small sizes.

Every single loss of k=8 m=4 d=11, k=4 m=2 d=5, k=5 m=2 d=6 (one
virtual node) and k=4 m=3 d=5 (a virtual node and an aloof chunk): the
branch's answer equals the benchmark's plain clay reference
(``benchmarks/yardstick/clay.py``), the port's host ``decode()`` on the
same partial buffers, the JAX package's dict repair and the lost chunk,
byte for byte; the reference's encode equals ``encode_chunks_torch``;
the probed repair composite equals the reference's.  The branch refuses
every other partial input, reads the helpers' sub-chunks where they lie
(one apply over a view), and records ``codec.decode`` /
``clay.repair_plan`` with the bytes it reads under ``spans.armed()``.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry

from ceph_tpu_torch.codes.plugins import clay as clay_mod
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.telemetry import spans

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
from yardstick.clay import Clay  # noqa: E402

GEOMETRIES = [(8, 4, 11), (4, 2, 5), (5, 2, 6), (4, 3, 5)]
IDS = ["k8m4d11", "k4m2d5", "k5m2d6-nu1", "k4m3d5-aloof"]
LOSSES = [(g, lost) for g in GEOMETRIES for lost in range(g[0] + g[1])]
SC = 8          # sub-chunk bytes
STRIPES = 3


def _profile(g):
    return {"k": str(g[0]), "m": str(g[1]), "d": str(g[2])}


@functools.lru_cache(maxsize=None)
def _setup(g):
    """(port code, plain reference, (STRIPES, k+m, chunk) stripe)."""
    ec = ErasureCodePluginRegistry.instance().factory(
        "clay", _profile(g), device="cpu")
    ref = Clay(*g)
    chunk = ref.sub * SC
    gen = torch.Generator().manual_seed(sum(g))
    data = torch.randint(0, 256, (STRIPES, g[0], chunk), dtype=torch.uint8,
                         generator=gen)
    return ec, ref, torch.cat([data, ref.encode(data)], dim=1)


def _reads(ref, full, lost, helpers=None):
    """(STRIPES, d, n_rp * SC): the helpers' repair sub-chunks."""
    helpers = ref.helpers(lost) if helpers is None else helpers
    planes = ref.repair_planes(lost)
    b = full.shape[0]
    return full[:, list(helpers)].reshape(b, len(helpers), ref.sub, SC)[
        :, :, planes].reshape(b, len(helpers), -1).contiguous()


@pytest.mark.parametrize("g", GEOMETRIES, ids=IDS)
def test_reference_encode_equals_the_program(g):
    ec, ref, full = _setup(g)
    assert (ref.q, ref.t, ref.nu, ref.sub) == (ec.q, ec.t, ec.nu,
                                               ec.sub_chunk_no)
    data = full[:, :g[0]].contiguous()
    assert torch.equal(ec.encode_chunks_torch(data), full[:, g[0]:])


@pytest.mark.parametrize("g,lost", LOSSES,
                         ids=[f"{IDS[GEOMETRIES.index(g)]}-{lost}"
                              for g, lost in LOSSES])
def test_repair_branch_equals_every_reference(g, lost):
    ec, ref, full = _setup(g)
    n = g[0] + g[1]
    chunk = full.shape[-1]
    need = ec.minimum_to_decode({lost}, set(range(n)) - {lost})
    helpers = ref.helpers(lost)
    assert tuple(sorted(need)) == helpers
    reads = _reads(ref, full, lost)
    got = ec.decode_chunks_torch(reads, helpers, (lost,), chunk_size=chunk)
    assert got.shape == (STRIPES, 1, chunk)
    assert torch.equal(got[:, 0], full[:, lost])
    assert torch.equal(ref.repair(reads, lost), got)
    jax_ec = RefRegistry.instance().factory("clay", _profile(g))
    for s in range(STRIPES):
        bufs = {h: reads[s, i].numpy().tobytes()
                for i, h in enumerate(helpers)}
        want = got[s, 0].numpy().tobytes()
        assert ec.decode({lost}, dict(bufs), chunk)[lost] == want
        assert jax_ec.decode({lost}, dict(bufs), chunk)[lost] == want


@pytest.mark.parametrize("g", GEOMETRIES, ids=IDS)
def test_probed_composite_equals_the_reference(g):
    ec, ref, _ = _setup(g)
    n_rp = ref.sub // ref.q
    for lost in range(g[0] + g[1]):
        mat, static = ec._repair_composite(ref.helpers(lost), lost)
        assert mat.shape == (ref.sub, g[2] * n_rp)
        assert np.array_equal(mat, ref.repair_composite(lost))
        assert np.array_equal(np.asarray(static, dtype=np.int64), mat)
    if g == (8, 4, 11):
        nnz = {int(np.count_nonzero(ec._repair_composite(
            ref.helpers(lost), lost)[0])) for lost in range(12)}
        assert nnz == {944}


def _refusal_cases():
    """(geometry, reads shape or None, available, erased, chunk_size
    offset) of partial inputs the branch refuses."""
    k8, k4m3 = (8, 4, 11), (4, 3, 5)
    h0 = Clay(*k8).helpers(0)
    return [
        ("two losses", k8, None, h0[1:], (0, 1), 0),
        ("no loss", k8, None, h0, (), 0),
        ("lost among available", k8, None, (0,) + h0[1:], (0,), 0),
        ("fewer than d helpers", k8, None, h0[:-1], (0,), 0),
        ("a duplicate helper", k8, None, h0[:-1] + (h0[0],), (0,), 0),
        ("every survivor, more than d", k4m3, None,
         tuple(c for c in range(7) if c != 0), (0,), 0),
        ("a short width", k8, (STRIPES, 11, 16 * SC - 1), h0, (0,), 0),
        ("a helper short", k8, (STRIPES, 10, 16 * SC), h0, (0,), 0),
        ("two dims", k8, (11, 16 * SC), h0, (0,), 0),
        ("chunk_size off the sub-chunks", k8, (STRIPES, 11, 16 * SC), h0,
         (0,), 4),
    ]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_other_partial_inputs_are_refused(case):
    _, g, shape, available, erased, off = case
    ec, ref, full = _setup(g)
    chunk = full.shape[-1] + off
    if shape is None:
        shape = (STRIPES, max(len(available), 1), ref.sub // ref.q * SC)
    x = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="repair|helpers|chunk_size"):
        ec.decode_chunks_torch(x, available, erased, chunk_size=chunk)


def test_shape_refusal_names_the_expected_shape():
    ec, ref, full = _setup((8, 4, 11))
    x = torch.zeros((2, 11, 100), dtype=torch.uint8)
    with pytest.raises(ValueError) as err:
        ec.decode_chunks_torch(x, ref.helpers(3), (3,),
                               chunk_size=full.shape[-1])
    assert "(batch, 11, 16 * chunk_size / 64)" in str(err.value)


@pytest.mark.parametrize("with_size", [False, True])
def test_whole_chunk_calls_are_unchanged(with_size):
    """Whole survivors take the full decode, chunk_size or not."""
    ec, ref, full = _setup((8, 4, 11))
    avail = tuple(c for c in range(12) if c != 2)
    kw = {"chunk_size": full.shape[-1]} if with_size else {}
    got = ec.decode_chunks_torch(full[:, list(avail)].contiguous(), avail,
                                 (2,), **kw)
    assert torch.equal(got[:, 0], full[:, 2])


def test_repair_applies_once_over_a_view(monkeypatch):
    """One apply over (batch, d * n_rp, sc) rows that are the caller's
    buffer, no copy."""
    ec, ref, full = _setup((8, 4, 11))
    reads = _reads(ref, full, 5)
    seen = []
    real = clay_mod.apply_matrix_best

    def spy(x, ms, w=8, mesh=None):
        seen.append((x.data_ptr(), tuple(x.shape), x.is_contiguous(),
                     (len(ms), len(ms[0]))))
        return real(x, ms, w, mesh)

    monkeypatch.setattr(clay_mod, "apply_matrix_best", spy)
    got = ec.decode_chunks_torch(reads, ref.helpers(5), (5,),
                                 chunk_size=full.shape[-1])
    assert torch.equal(got[:, 0], full[:, 5])
    assert seen == [(reads.data_ptr(), (STRIPES, 11 * 16, SC), True,
                     (64, 176))]


def test_repair_spans_and_read_bytes():
    ec, ref, full = _setup((8, 4, 11))
    reads = _reads(ref, full, 9)
    ec.decode_chunks_torch(reads, ref.helpers(9), (9,),
                           chunk_size=full.shape[-1])      # build, unarmed
    tracer = spans.global_tracer()
    tracer.reset()
    with spans.armed():
        ec.decode_chunks_torch(reads, ref.helpers(9), (9,),
                               chunk_size=full.shape[-1])
    totals = tracer.totals()
    assert totals["codec.decode"]["count"] == 1
    assert totals["clay.repair_plan"]["count"] == 1
    assert totals["engine.dispatch"]["count"] == 1
    assert totals["codec.decode"]["counts"] == {
        "repair_read_bytes": STRIPES * 11 * 16 * SC}
    assert tracer.finished[-1].children[0].name == "clay.repair_plan"
    tracer.reset()


def test_whole_chunk_surfaces_have_codec_roots():
    ec, ref, full = _setup((4, 2, 5))
    tracer = spans.global_tracer()
    tracer.reset()
    avail = (0, 2, 3, 4, 5)
    with spans.armed():
        ec.encode_chunks_torch(full[:, :4].contiguous())
        ec.decode_chunks_torch(full[:, list(avail)].contiguous(), avail,
                               (1,))
    totals = tracer.totals()
    assert totals["codec.encode"]["count"] == 1
    assert totals["codec.decode"]["count"] == 1
    assert "clay.repair_plan" not in totals
    assert totals["engine.dispatch"]["count"] == 2
    tracer.reset()
