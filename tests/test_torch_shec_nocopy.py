"""shec's device decodes read the survivors where they lie, on the CPU:
``decode_chunks_torch``, ``decode_chunks_packed_torch`` and
``decode_chunks_ragged_torch`` apply the minimum-read plan's matrix
widened with zero columns over ``available``, with no gather around the
apply.  For shec k=4 m=3 c=2, k=6 m=3 c=2 and k=8 m=4 c=3, every 1- and
2-erasure pattern the plan decodes, on survivors that are a strided
slice of a wider stack and on a contiguous copy of them:

- the bytes equal the reference's ``decode_chunks_jax`` and the port's
  ``decode_chunks_batch`` (the ragged decode: on live pages, dead pages
  zero);
- ``torch.Tensor.index_select`` is never called;
- under ``spans.armed()`` the decode notes ``survivor_copies`` 0.

The widened matrix routes as the plan's own in the engine table.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch.codes.engine import dispatched_matrix_static
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops.gf_kernels import (pack_chunks, select_matrix_engine,
                                           unpack_chunks)
from ceph_tpu_torch.telemetry import spans
from ceph_tpu_torch.telemetry.spans import SpanTracer

PROFILES = {"k4m3c2": {"k": "4", "m": "3", "c": "2"},
            "k6m3c2": {"k": "6", "m": "3", "c": "2"},
            "k8m4c3": {"k": "8", "m": "4", "c": "3"}}
BATCH, CHUNK = 4, 512          # a packed chunk is one 512-byte row


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port code, whole stripes, {(available, erased): the reference's
    decode}) over every 1- and 2-erasure pattern the plan decodes."""
    profile = PROFILES[name]
    ours = ErasureCodePluginRegistry.instance().factory(
        "shec", dict(profile), device="cpu")
    ref = RefRegistry.instance().factory("shec", dict(profile))
    k, n = ref.get_data_chunk_count(), ref.get_chunk_count()
    data = np.random.default_rng(n * 100 + k).integers(
        0, 256, (BATCH, k, CHUNK), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_chunks_batch(data)], axis=1)
    answers = {}
    for e in (1, 2):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            surv = np.ascontiguousarray(full[:, list(avail)])
            try:
                ref.minimum_to_decode(set(erased), set(avail))
            except IOError:
                with pytest.raises(IOError):
                    ours.minimum_to_decode(set(erased), set(avail))
                continue
            want = np.asarray(ref.decode_chunks_jax(surv, avail, erased))
            assert np.array_equal(want, full[:, list(erased)]), erased
            assert np.array_equal(
                ours.decode_chunks_batch(surv, avail, erased), want), erased
            answers[(avail, erased)] = want
    assert answers
    return ours, full, answers


@pytest.fixture
def tracer():
    tr = SpanTracer()
    prev = spans.set_global_tracer(tr)
    try:
        yield tr
    finally:
        spans.set_global_tracer(prev)


def _no_index_select(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("index_select on shec's decode path")
    monkeypatch.setattr(torch.Tensor, "index_select", refuse)
    monkeypatch.setattr(torch, "index_select", refuse)


@pytest.mark.parametrize("layout", ["bytes", "packed", "ragged"])
@pytest.mark.parametrize("name", list(PROFILES))
def test_shec_device_decode_reads_survivors_where_they_lie(
        name, layout, monkeypatch, tracer):
    ours, full, answers = _case(name)
    live = np.array([True, False, True, True])
    mask = torch.from_numpy(live.astype(np.uint8))
    _no_index_select(monkeypatch)
    for (avail, erased), want in answers.items():
        na = len(avail)
        # survivors at every other chunk of a wider stack
        stack = torch.zeros((BATCH, 2 * na + 1, CHUNK), dtype=torch.uint8)
        stack[:, 1::2] = torch.from_numpy(full[:, list(avail)])
        if layout == "packed":
            strided = pack_chunks(stack)[:, 1::2]
        else:
            strided = stack[:, 1::2]
        assert not strided.is_contiguous()
        for surv in (strided, strided.contiguous()):
            with spans.armed(), spans.root("test.decode"):
                if layout == "bytes":
                    got = ours.decode_chunks_torch(surv, avail, erased)
                elif layout == "packed":
                    got = unpack_chunks(ours.decode_chunks_packed_torch(
                        surv, avail, erased))
                else:
                    got = ours.decode_chunks_ragged_torch(surv, mask, avail,
                                                          erased)
            if layout == "ragged":
                assert np.array_equal(got.numpy()[live], want[live]), erased
                assert not got.numpy()[~live].any(), erased
            else:
                assert np.array_equal(got.numpy(), want), erased
    totals = tracer.totals()
    assert totals["test.decode"]["count"] == 2 * len(answers)
    assert totals["test.decode"]["counts"]["survivor_copies"] == 0
    if layout == "bytes":
        assert totals["codec.decode"]["count"] == 2 * len(answers)
        assert totals["codec.decode"]["counts"]["survivor_copies"] == 0


@pytest.mark.parametrize("name", list(PROFILES))
def test_widened_matrix_routes_as_the_plan(name):
    """Zero columns change no route: on the card's table the widened
    matrix of every pattern takes the tier of the plan's own matrix, in
    both layouts; it is the plan's rows in ``erased`` order, its
    nonzero columns the plan's reads, and the matrix a tuned pin keys
    on."""
    ours, _, answers = _case(name)
    cuda = torch.device("cuda")
    for avail, erased in answers:
        plan = ours._plan(avail, erased)
        narrow = ours._plan_static(plan)[1]
        wide = ours._plan_wide(avail, erased)
        assert dispatched_matrix_static(ours, avail, erased) == wide
        assert len(wide) == len(erased) and len(wide[0]) == len(avail)
        cols = [avail.index(c) for c in plan.reads]
        for t, c in enumerate(erased):
            row = narrow[plan.want_order.index(c)]
            assert [wide[t][j] for j in cols] == list(row)
            assert not any(v for j, v in enumerate(wide[t])
                           if j not in cols)
        for packed in (False, True):
            shape = (64, None, 8, 128) if packed else (64, None, 4096)
            tiers = [select_matrix_engine(
                8, cuda, shape=shape[:1] + (len(ms[0]),) + shape[2:],
                matrix_t=ms, packed=packed) for ms in (narrow, wide)]
            assert tiers[0] == tiers[1], (erased, tiers)
