"""The hand-written CUDA kernels against their plain torch versions, on
the card: the GF(2^8) matrix kernel (bytes, packed and the two ragged
wrappers, its table variant above the by-value limit, and a small
serving stream through them), the w=16/32 word kernel, the two
packet-layout bitmatrix kernels (plain and scheduled), the XOR-schedule
kernel (bytes and packed wrappers; the shec, lrc and reed_sol_r6_op
paths that take it; shec's decode and clay's sub-chunk repair at
their benchmark cells' sizes, one launch and no device op but the GF
kernels), the "mxu" row's column-walk kernel (bytes and
packed, column splits, row tiles; the clay paths that take it)
and the roofline tool's copy and fold kernels; and the CRUSH bulk
evaluator and the crushtool / osdmaptool CLIs on the card against their
CPU runs, and its first rung's rule kernel against the host mapper (the
remap cell's map, NONE holes, ties, weight sets, x near 2^32); and the
supervised
dispatch plane (clean launches equal to the unsupervised call's, the
device-chaos row, a lost card raising and the kernel launching after)
and the data plane over 4 virtual members of the card (the mesh tier,
a member quarantine that stays on the card, a width-1 loss raising);
and the cluster plane and the scenarios on the card against their CPU
runs (a churn storm and the balancer on the bulk evaluator against the
host mapper, the simulated production day and tenant week); and the
host syncs the span sites note (telemetry/spans.py) against torch's own
count of synchronising calls, on an epoch of the remap cell's map and
on one RS encode and one shec decode.
Every test here
is marked ``cuda`` and skips (with a reason) where no CUDA device is
present: a CUDA kernel has no CPU mode.

The file imports neither jax nor ceph_tpu (the machine with the card
need not have them); the numpy ground truth is the port's own copy.
On that machine:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Comparisons are exact (``torch.equal``): GF(2^w) and GF(2) math is
integer.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import fallback, regionops
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda, apply_matrix_best,
    apply_matrix_cuda, apply_matrix_cuda_packed, apply_matrix_cuda_words,
    apply_matrix_packed_best,
    apply_matrix_xor_cuda, apply_matrix_xor_cuda_packed, pack_chunks,
    select_matrix_engine, unpack_chunks)
from ceph_tpu_torch.ops.probe_kernels import (
    copy_slab_cuda, copy_slab_torch, fold_slab_cuda, fold_slab_torch)
from ceph_tpu_torch.ops.torch_ops import (
    WORD_DTYPE, apply_bitmatrix_torch, apply_bitmatrix_xor_torch,
    apply_matrix_mxu_torch, apply_matrix_packed_ragged_torch,
    apply_matrix_ragged_torch, apply_matrix_torch, apply_matrix_walk_torch,
    apply_matrix_xor_torch, bitmatrix_to_static, mask_pages,
    matrix_to_static)
from ceph_tpu_torch.ops.xor_schedule import (
    build_schedule, preferred_schedule, probe_bitmatrix_schedule)
from ceph_tpu_torch.utils.errors import KernelLaunchError

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, s, r, c, lead):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0
    data = rng.integers(0, 256, lead + (s, c), dtype=np.uint8)
    return mat, data


@pytest.mark.parametrize("s,r,C,lead", [(8, 3, 131072, (4,)),
                                        (8, 11, 4096 + 4, (2,)),
                                        (3, 1, 4097, ()),
                                        (5, 8, 65536, (2, 3)),
                                        (11, 16, 512, (7,))])
def test_kernel_matches_plain_on_card(cuda_device, s, r, C, lead):
    mat, data = _case(C + r, s, r, C, lead)
    ms = matrix_to_static(mat)
    x = torch.from_numpy(data).to(cuda_device)
    before = apply_matrix_cuda.launches
    got = apply_matrix_cuda(x, ms)
    torch.cuda.synchronize()
    assert apply_matrix_cuda.launches > before
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    assert np.array_equal(got.cpu().numpy(),
                          regionops.matrix_encode(data, mat, 8))
    if C % 512 == 0:
        before = apply_matrix_cuda_packed.launches
        gotp = apply_matrix_cuda_packed(pack_chunks(x), ms)
        torch.cuda.synchronize()
        assert apply_matrix_cuda_packed.launches > before
        assert torch.equal(unpack_chunks(gotp), got)


def test_strided_survivor_slice_on_card(cuda_device):
    mat, data = _case(77, 8, 3, 8192, (3,))
    ms = matrix_to_static(mat)
    x = torch.from_numpy(data).to(cuda_device)
    wide = torch.cat([x, x[:, :3]], dim=1)
    assert torch.equal(apply_matrix_cuda(wide[:, :8, :], ms),
                       apply_matrix_torch(x, ms, 8))
    wide_words = pack_chunks(wide)
    assert torch.equal(
        unpack_chunks(apply_matrix_cuda_packed(wide_words[:, :8], ms)),
        apply_matrix_torch(x, ms, 8))


def test_unmergeable_batch_is_refused(cuda_device):
    x = torch.zeros(4, 6, 3, 256, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        apply_matrix_cuda(x.transpose(0, 1), ((1, 2, 3),))


def test_code_on_card_round_trips(cuda_device):
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"})
    assert ec.device.type == "cuda"
    data = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8, 16384), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert parity.device.type == "cuda"
    assert np.array_equal(parity.cpu().numpy(), regionops.matrix_encode(
        data.cpu().numpy(), ec.matrix, 8))
    full = torch.cat([data, parity], dim=1)
    avail, erased = (1, 2, 3, 5, 6, 7, 9, 10), (0, 4, 8)
    rec = ec.decode_chunks_torch(full[:, list(avail)], avail, erased)
    assert torch.equal(rec, full[:, list(erased)])


@pytest.mark.parametrize("force", ["torch", "numpy"])
def test_forced_plain_tier_refuses_card_tensor(cuda_device, monkeypatch,
                                               force):
    monkeypatch.setenv("CEPH_TPU_ENGINE", force)
    prev = fallback.set_global_policy(None)
    try:
        x = torch.zeros(2, 3, 512, dtype=torch.uint8, device=cuda_device)
        before = apply_matrix_cuda.launches
        with pytest.raises(ValueError, match="CPU tensors"):
            apply_matrix_best(x, ((1, 2, 3),))
        assert apply_matrix_cuda.launches == before
    finally:
        fallback.set_global_policy(prev)


def test_launch_keeps_the_current_device(cuda_device):
    x = torch.zeros(2, 3, 512, dtype=torch.uint8, device=cuda_device)
    cur = torch.cuda.current_device()
    apply_matrix_cuda(x, ((1, 2, 3),))
    assert torch.cuda.current_device() == cur


# -- the w=16/32 word kernel ----------------------------------------------------

@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("s,r,nbytes,lead", [(8, 3, 65536, (4,)),
                                             (5, 9, 4096 + 4, (2,)),
                                             (3, 2, 1028, ())])
def test_word_kernel_matches_plain_on_card(cuda_device, w, s, r, nbytes,
                                           lead):
    rng = np.random.default_rng(w + s + r)
    mat = rng.integers(0, 1 << w, (r, s), dtype=np.uint64)
    mat[0, 0] = 0
    ms = matrix_to_static(mat)
    data = rng.integers(0, 256, lead + (s + 1, nbytes), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device).view(WORD_DTYPE[w])
    view = x[..., :s, :]                          # a strided survivor slice
    before = apply_matrix_cuda_words.launches
    got = apply_matrix_cuda_words(view, ms, w)
    torch.cuda.synchronize()
    assert apply_matrix_cuda_words.launches > before
    assert got.dtype == WORD_DTYPE[w]
    assert torch.equal(got, apply_matrix_torch(view.contiguous(), ms, w))
    words = regionops.words_view(data[..., :s, :], w)
    assert np.array_equal(got.cpu().numpy(),
                          regionops.matrix_encode(words, mat, w))
    assert select_matrix_engine(w, cuda_device) == "cuda"
    assert torch.equal(apply_matrix_best(view, ms, w), got)


# -- the packet-layout bitmatrix kernels ----------------------------------------

def _bitmatrix(rng, r, s, w):
    bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
    bm[0] = 0
    return bm


@pytest.mark.parametrize("w", [6, 7, 8])
@pytest.mark.parametrize("ps", [8, 32, 2048, 12])
@pytest.mark.parametrize("lead", [(3,), ()])
def test_bitmatrix_kernel_matches_plain_on_card(cuda_device, w, ps, lead):
    rng = np.random.default_rng(w * 7 + ps)
    s, r = 5, 2
    bm = _bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    data = rng.integers(0, 256, lead + (s + 2, 2 * w * ps), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    view = x[..., :s, :]
    before = apply_bitmatrix_cuda.launches
    got = apply_bitmatrix_cuda(view, rows, w, ps)
    torch.cuda.synchronize()
    assert apply_bitmatrix_cuda.launches == before + 1
    assert torch.equal(got, apply_bitmatrix_torch(view, rows, w, ps))
    assert np.array_equal(got.cpu().numpy(), regionops.bitmatrix_encode(
        data[..., :s, :], bm, w, ps))


def _code(profile):
    return ErasureCodePluginRegistry.instance().factory("jerasure",
                                                        dict(profile))


@pytest.mark.parametrize("profile,ps", [
    ({"technique": "cauchy_good", "k": "8", "m": "3"}, 2048),
    ({"technique": "cauchy_good", "k": "8", "m": "3"}, 32),
    ({"technique": "cauchy_orig", "k": "4", "m": "2"}, 8),
    ({"technique": "blaum_roth", "k": "6", "w": "6"}, 12),
    ({"technique": "liber8tion", "k": "8"}, 32)])
def test_schedule_kernel_matches_plain_on_card(cuda_device, profile, ps):
    ec = _code(profile)
    k, n, w = ec.k, ec.k + ec.m, ec.w
    rng = np.random.default_rng(k + ps)
    data = rng.integers(0, 256, (3, n, 2 * w * ps), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    mats = [ec.bitmatrix]
    for erased in ((0, n - 1), tuple(range(ec.m))):
        avail = [i for i in range(n) if i not in erased][:k]
        mats.append(regionops.bitmatrix_decode_matrix(
            ec.bitmatrix, k, w, avail, list(erased)))
    for bm in mats:
        sched = probe_bitmatrix_schedule(bitmatrix_to_static(bm), w)
        assert sched is not None
        view = x[:, :k, :]
        before = apply_bitmatrix_xor_cuda.launches
        got = apply_bitmatrix_xor_cuda(view, sched.static, w, ps)
        torch.cuda.synchronize()
        assert apply_bitmatrix_xor_cuda.launches == before + 1
        assert torch.equal(got, apply_bitmatrix_xor_torch(
            view, sched.static, w, ps))
        assert np.array_equal(got.cpu().numpy(), regionops.bitmatrix_encode(
            data[:, :k], bm, w, ps))


def _cauchy_good():
    return _code({"technique": "cauchy_good", "k": "8", "m": "3"})


def _cauchy_decode(ec, erased):
    """(kind, key) of cauchy_good k=8 m=3's decode of ``erased``: the
    schedule when one pays, else the plain rows."""
    avail = tuple(i for i in range(11) if i not in erased)
    _, rows, _, sched = ec._decode_bitmatrix(avail, erased)
    return ("plain", tuple(rows)) if sched is None \
        else ("schedule", sched.static)


def _packet_ref(x, kind, key, w, ps):
    if kind == "plain":
        return apply_bitmatrix_torch(x, key, w, ps)
    return apply_bitmatrix_xor_torch(x, key, w, ps)


def _forced(x, r, w, ps, kind, key, unit, groups):
    """One launch of the packet kernel under a plan of the given unit and
    row groups."""
    dev = x.device
    n, extra = gf_kernels.packet_slots(kind, key, x.shape[-2] * w, w)(groups)
    batch, c = x.shape[0], x.shape[-1]
    plan = gf_kernels._packet_grid(batch * (c // (w * ps)) * (ps // unit),
                                   unit, groups, n, extra,
                                   gf_kernels._device_limits(dev.index))
    out = gf_kernels._packet_launch(x, r, w, ps, kind, key, x.shape[-2] * w,
                                    plan=plan)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("unit", [16, 8, 4, 1])
@pytest.mark.parametrize("groups", [1, 3, 8])
def test_packet_kernel_every_unit_and_group(cuda_device, unit, groups):
    """The cauchy_good encode, plain and scheduled, and its decode (3, 9)
    under every unit width and 1, 3 and 8 row groups, at 4 stripes of 32
    KiB (several units per thread where the grid is small), against the
    plain versions."""
    ec = _cauchy_good()
    rng = np.random.default_rng(unit * 10 + groups)
    ps = 2048
    x = torch.from_numpy(rng.integers(0, 256, (4, 11, 2 * 8 * ps),
                                      dtype=np.uint8)).to(cuda_device)
    cases = [("plain", ec._bitmatrix_static, x[:, :8], 3),
             ("schedule", ec._encode_sched.static, x[:, :8], 3),
             (*_cauchy_decode(ec, (3, 9)), x[:, 1:9], 2)]
    for kind, key, xs, r in cases:
        got = _forced(xs, r, 8, ps, kind, key, unit, groups)
        assert torch.equal(got, _packet_ref(xs, kind, key, 8, ps)), kind


@pytest.mark.parametrize("w,ps", [(7, 32), (6, 8), (8, 12), (5, 3)])
def test_packet_kernel_small_packets_under_forced_plans(cuda_device, w, ps):
    """Random bitmatrices at small packet sizes: every unit the packet
    size allows, 1 and 2 row groups."""
    rng = np.random.default_rng(w * ps)
    s, r = 5, 2
    bm = _bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    sched = probe_bitmatrix_schedule(rows, w)
    x = torch.from_numpy(rng.integers(0, 256, (3, s, 6 * w * ps),
                                      dtype=np.uint8)).to(cuda_device)
    cases = [("plain", rows)] + ([] if sched is None
                                 else [("schedule", sched.static)])
    for unit in (16, 8, 4, 1):
        if ps % unit:
            continue
        for groups in (1, 2):
            for kind, key in cases:
                got = _forced(x, r, w, ps, kind, key, unit, groups)
                assert torch.equal(got, _packet_ref(x, kind, key, w, ps)), \
                    (kind, unit, groups)


@pytest.mark.parametrize("w,ps,s,unit", [(7, 32, 7, 16), (8, 2048, 8, 8),
                                         (8, 12, 7, 4), (5, 3, 7, 1)])
def test_packet_wrappers_take_every_unit_width(cuda_device, w, ps, s, unit):
    """Each unit width through the wrappers, at the packet size (and
    inputs) that select it (64 stripes of s random chunks, 16384 // ps
    blocks each): the plan takes ``unit`` for the plain product, and both
    products equal their plain versions in one launch each."""
    rng = np.random.default_rng(w * ps + unit)
    r = 2
    rows = bitmatrix_to_static(_bitmatrix(rng, r, s, w))
    c = 16384 // ps * w * ps
    x = torch.from_numpy(rng.integers(0, 256, (64, s, c),
                                      dtype=np.uint8)).to(cuda_device)
    plan = gf_kernels.packet_launch_plan(x, r, w, ps, "plain", rows, s * w)
    assert plan.unit == unit, plan
    sched = probe_bitmatrix_schedule(rows, w)
    cases = [("plain", rows, apply_bitmatrix_cuda)]
    if sched is not None:
        cases.append(("schedule", sched.static, apply_bitmatrix_xor_cuda))
    for kind, key, wrapper in cases:
        before = wrapper.launches
        got = wrapper(x, key, w, ps)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got, _packet_ref(x, kind, key, w, ps)), kind


@pytest.mark.parametrize("batch", [4, 64])
def test_packet_plan_spreads_rows_at_small_batches(cuda_device, batch):
    """The plan takes one row group at 64 stripes and more at 4 (the
    units alone do not fill a wave); every sampled cauchy_good decode
    equals the plain version in one launch."""
    ec = _cauchy_good()
    rng = np.random.default_rng(batch)
    full = torch.from_numpy(rng.integers(0, 256, (batch, 11, 131072),
                                         dtype=np.uint8)).to(cuda_device)
    for erased in ((3,), (3, 9), (0, 10), (5, 6, 7), (8, 9, 10)):
        kind, key = _cauchy_decode(ec, erased)
        avail = [i for i in range(11) if i not in erased]
        x = full[:, avail][:, :8]
        r = len(erased)
        plan = gf_kernels.packet_launch_plan(x, r, 8, 2048, kind, key, 64)
        assert (plan.groups == 1) == (batch == 64), plan
        wrapper = apply_bitmatrix_cuda if kind == "plain" \
            else apply_bitmatrix_xor_cuda
        before = wrapper.launches
        got = wrapper(x, key, 8, 2048)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got, _packet_ref(x, kind, key, 8, 2048)), erased


@pytest.mark.parametrize("profile", [
    {"technique": "cauchy_good", "k": "8", "m": "3", "packetsize": "2048"},
    {"technique": "liberation", "k": "7", "w": "7"},
    {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "16"},
    {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "32"}])
def test_bitmatrix_and_word_codes_round_trip_on_card(cuda_device, profile):
    ec = _code(profile)
    assert ec.device.type == "cuda"
    k, n = ec.k, ec.k + ec.m
    c = ec.get_chunk_size(k * 65536)
    data = torch.from_numpy(np.random.default_rng(k).integers(
        0, 256, (2, k, c), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert parity.device.type == "cuda" and parity.shape == (2, ec.m, c)
    host = data.cpu().numpy()
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_chunks_batch(host))
    full = torch.cat([data, parity], dim=1)
    for e in range(1, ec.m + 1):
        for erased in itertools.islice(itertools.combinations(range(n), e),
                                       4):
            avail = tuple(i for i in range(n) if i not in erased)
            rec = ec.decode_chunks_torch(full[:, list(avail)], avail, erased)
            assert torch.equal(rec, full[:, list(erased)]), erased


# -- the XOR-schedule kernel ------------------------------------------------------

R6 = ((1,) * 8, tuple(1 << j for j in range(8)))
LRC_REPAIR = ("xorsched", 7, 1, (("xor", 0, 1), ("xor", 7, 2)), (8,))


def _xor_schedules():
    rng = np.random.default_rng(21)
    out = [("r6-encode", preferred_schedule(R6, 8).static, R6),
           ("lrc-repair", LRC_REPAIR, ((1, 1, 1, 0, 0, 0, 0),))]
    for kind in ("sparse", "monomial", "dense"):
        if kind == "sparse":
            m = rng.integers(0, 256, (3, 6)) * (rng.random((3, 6)) < 0.4)
        elif kind == "monomial":
            m = (1 << rng.integers(0, 8, (3, 6))) * (rng.random((3, 6)) < 0.7)
        else:
            m = rng.integers(0, 256, (2, 5))
        m[0, 0] = 1
        ms = matrix_to_static(m)
        out.append((kind, build_schedule(ms).static, ms))
    return out


@pytest.mark.parametrize("name,static,ms", _xor_schedules(),
                         ids=[c[0] for c in _xor_schedules()])
@pytest.mark.parametrize("C,lead", [(131072, (4,)), (4096 + 4, (3,)),
                                    (8192, ())])
def test_xor_kernel_matches_plain_on_card(cuda_device, name, static, ms, C,
                                          lead):
    """Both XOR wrappers against the plain schedule and the numpy ground
    truth: full width, C % 16 != 0 (4-byte units), no leading batch, and
    a survivor slice whose chunk axis is strided."""
    s = static[1]
    rng = np.random.default_rng(C + s)
    data = rng.integers(0, 256, lead + (s + 1, C), dtype=np.uint8)
    x = torch.from_numpy(data).to(cuda_device)
    view = x[..., :s, :]
    before = apply_matrix_xor_cuda.launches
    got = apply_matrix_xor_cuda(view, static)
    torch.cuda.synchronize()
    assert apply_matrix_xor_cuda.launches == before + 1
    assert torch.equal(got, apply_matrix_xor_torch(view.contiguous(),
                                                   static))
    assert np.array_equal(got.cpu().numpy(), regionops.matrix_encode(
        data[..., :s, :], np.array(ms, dtype=np.int64), 8))
    if C % 512 == 0:
        before = apply_matrix_xor_cuda_packed.launches
        gotp = apply_matrix_xor_cuda_packed(pack_chunks(x)[..., :s, :, :],
                                            static)
        torch.cuda.synchronize()
        assert apply_matrix_xor_cuda_packed.launches == before + 1
        assert torch.equal(unpack_chunks(gotp), got)


def test_xor_kernel_refuses_what_it_cannot_take(cuda_device):
    static = preferred_schedule(R6, 8).static
    buf = torch.zeros(2 * 8 * 512 + 2, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        apply_matrix_xor_cuda(buf[2:].view(2, 8, 512), static)
    n = 800                        # 800 nodes live at once: past the budget

    def chain(first):
        ops = [("xor", 2, 3)]
        for j in range(4, n + 2):
            ops.append(("xor", first + len(ops) - 1, j))
        return ops

    first = 2 + n
    big = ("xorsched", 2, 2, tuple([("xor", 0, 1)] * n + chain(first)
                                   + chain(first + n - 1)),
           (first + n - 2, first + 2 * n - 3))
    before = apply_matrix_xor_cuda.launches
    with pytest.raises(KernelLaunchError):
        apply_matrix_xor_cuda(torch.zeros(1, 2, 64, dtype=torch.uint8,
                                          device=cuda_device), big)
    assert apply_matrix_xor_cuda.launches == before


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "8", "m": "2"})])
def test_composite_codes_round_trip_on_card(cuda_device, plugin, profile):
    """Encode, then every 1- and 2-erasure decode the code can make, in
    both layouts; a decode runs the XOR-schedule kernel exactly where the
    engine table routes its matrix there."""
    ec = ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
    assert ec.device.type == "cuda"
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    data = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, (2, k, 65536), dtype=np.uint8)).to(cuda_device)
    parity = ec.encode_chunks_torch(data)
    assert torch.equal(unpack_chunks(ec.encode_chunks_packed_torch(
        pack_chunks(data))), parity)
    assert np.array_equal(parity.cpu().numpy(),
                          ec.encode_chunks_batch(data.cpu().numpy()))
    full = torch.empty((2, n, 65536), dtype=torch.uint8, device=cuda_device)
    dpos = list(getattr(ec, "data_positions", range(k)))
    full[:, dpos] = data
    full[:, [p for p in range(n) if p not in dpos]] = parity
    scheduled = 0
    for e in (1, 2):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            try:
                ec.minimum_to_decode(set(erased), set(avail))
            except IOError:
                continue
            surv = full[:, list(avail)]
            before = gf_kernels.launch_counts()
            rec = ec.decode_chunks_torch(surv, avail, erased)
            recp = ec.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                                 erased)
            torch.cuda.synchronize()
            after = gf_kernels.launch_counts()
            assert torch.equal(rec, full[:, list(erased)]), erased
            assert torch.equal(unpack_chunks(recp), rec), erased
            ran_xor = after["apply_matrix_xor_cuda"] - before[
                "apply_matrix_xor_cuda"]
            assert ran_xor == after["apply_matrix_xor_cuda_packed"] - \
                before["apply_matrix_xor_cuda_packed"]
            scheduled += ran_xor
    assert scheduled == {"lrc": 29, "shec": 4, "jerasure": 2}[plugin]


def test_shec_decode_reads_survivors_where_they_lie_on_card(cuda_device,
                                                             tmp_path):
    """The shec cell's decode (k=6 m=3 c=2, 174,784-byte chunks, an
    8-survivor slab): every single erasure rebuilds the lost chunk in one
    launch, and the profiler sees no device op but the GF kernels (no
    gather around the apply)."""
    import json
    import re
    ec = ErasureCodePluginRegistry.instance().factory(
        "shec", {"k": "6", "m": "3", "c": "2"}, device=cuda_device)
    chunk = ec.get_chunk_size(1 << 20)
    assert chunk == 174784
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    data = torch.randint(0, 256, (8, 6, chunk), dtype=torch.uint8,
                         device=cuda_device, generator=gen)
    full = torch.cat([data, ec.encode_chunks_torch(data)], dim=1)
    gf = re.compile(r"^(void\s+)?gf[0-9]*_")
    for lost in range(9):
        avail = tuple(c for c in range(9) if c != lost)
        slab = full[:, list(avail)].contiguous()
        ec.decode_chunks_torch(slab, avail, (lost,))          # warm
        torch.cuda.synchronize()
        before = sum(gf_kernels.launch_counts().values())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = ec.decode_chunks_torch(slab, avail, (lost,))
            torch.cuda.synchronize()
        assert sum(gf_kernels.launch_counts().values()) - before == 1
        assert torch.equal(got[:, 0], full[:, lost]), lost
        path = tmp_path / f"decode{lost}.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            ops = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset")]
        assert ops and all(gf.match(n) for n in ops), (lost, ops)


def test_clay_repair_reads_the_helpers_sub_chunks_on_card(cuda_device,
                                                          tmp_path):
    """The clay cell's repair (k=8 m=4 d=11, 131,072-byte chunks): every
    single loss is rebuilt from the 11 helpers' 16 repair sub-chunks in
    one launch, and the profiler sees no device op but the GF kernels
    (no gather or copy around the apply)."""
    import json
    import re
    ec = ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": "8", "m": "4", "d": "11"}, device=cuda_device)
    chunk = ec.get_chunk_size(1 << 20)
    assert chunk == 131072
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    data = torch.randint(0, 256, (64, 8, chunk), dtype=torch.uint8,
                         device=cuda_device, generator=gen)
    full = torch.cat([data, ec.encode_chunks_torch(data)], dim=1)
    gf = re.compile(r"^(void\s+)?gf[0-9]*_")
    for lost in range(12):
        need = ec.minimum_to_decode({lost}, set(range(12)) - {lost})
        helpers = tuple(sorted(need))
        planes = ec._repair_planes(ec._node(lost))
        reads = full[:, list(helpers)].reshape(64, 11, 64, 2048)[
            :, :, planes].reshape(64, 11, -1).contiguous()
        ec.decode_chunks_torch(reads, helpers, (lost,), chunk_size=chunk)
        torch.cuda.synchronize()
        before = sum(gf_kernels.launch_counts().values())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = ec.decode_chunks_torch(reads, helpers, (lost,),
                                         chunk_size=chunk)
            torch.cuda.synchronize()
        assert sum(gf_kernels.launch_counts().values()) - before == 1
        assert torch.equal(got[:, 0], full[:, lost]), lost
        path = tmp_path / f"repair{lost}.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            ops = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset")]
        assert ops and all(gf.match(n) for n in ops), (lost, ops)


# -- the ragged (paged) wrappers -----------------------------------------------

@pytest.mark.parametrize("r,s,p,page,kind", [
    (3, 8, 64, 4096, "scattered"), (11, 8, 16, 4096 + 4, "scattered"),
    (1, 5, 8, 1024, "dead"), (8, 6, 8, 2048, "live"),
    (3, 8, 1, 512, "live")])
def test_ragged_kernel_matches_plain_on_card(cuda_device, r, s, p, page,
                                             kind):
    """Both ragged wrappers against their plain versions and against the
    dense kernel on the masked pool; dead pages zero."""
    rng = np.random.default_rng(r * 1000 + p)
    mat = rng.integers(0, 256, (r, s))
    mat[0, 0] = 0
    ms = matrix_to_static(mat)
    pool = torch.from_numpy(rng.integers(0, 256, (p, s, page),
                                         dtype=np.uint8)).to(cuda_device)
    live = {"scattered": rng.random(p) < 0.5, "dead": np.zeros(p, bool),
            "live": np.ones(p, bool)}[kind]
    mask = torch.from_numpy(live.astype(np.uint8)).to(cuda_device)
    before = gf_kernels.apply_matrix_cuda_ragged.launches
    got = gf_kernels.apply_matrix_cuda_ragged(pool, ms, mask)
    torch.cuda.synchronize()
    assert gf_kernels.apply_matrix_cuda_ragged.launches > before
    assert torch.equal(got, apply_matrix_ragged_torch(pool, ms, mask))
    assert torch.equal(got, apply_matrix_cuda(mask_pages(pool, mask), ms))
    assert not got[~torch.from_numpy(live).to(cuda_device)].any()
    if page % 512 == 0:
        words = pack_chunks(pool)
        before = gf_kernels.apply_matrix_cuda_packed_ragged.launches
        gotp = gf_kernels.apply_matrix_cuda_packed_ragged(words, ms, mask)
        torch.cuda.synchronize()
        assert gf_kernels.apply_matrix_cuda_packed_ragged.launches > before
        assert torch.equal(gotp, apply_matrix_packed_ragged_torch(
            words, ms, mask))
        assert torch.equal(unpack_chunks(gotp), got)


def test_ragged_wrappers_refuse_a_mask_off_the_pool(cuda_device):
    pool = torch.zeros(4, 3, 512, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="device"):
        gf_kernels.apply_matrix_cuda_ragged(
            pool, ((1, 2, 3),), torch.ones(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="pool"):
        gf_kernels.apply_matrix_cuda_ragged(
            pool, ((1, 2, 3),),
            torch.ones(3, dtype=torch.uint8, device=cuda_device))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_stream_on_card(cuda_device, paged):
    """A small mixed stream through the device executor on the card:
    verified against ground truth; the ragged kernel launches on the
    paged run only."""
    from ceph_tpu_torch.serve import (CodecSpec, TrafficSpec,
                                      run_serving_scenario, verify_results)
    codecs = [CodecSpec(f"rs_{s}", "jerasure",
                        {"technique": "reed_sol_van", "k": "4", "m": "2"}, s)
              for s in (4096, 16384)]
    spec = TrafficSpec(seed=5, n_requests=32, codecs=codecs,
                       ladder=(1, 4, 16), paged=paged, page_size=1024,
                       pool_pages=64)
    gf_kernels.reset_launch_counts()
    run = run_serving_scenario(spec)
    assert verify_results(run.results) == []
    ragged = gf_kernels.launch_counts()["apply_matrix_cuda_ragged"]
    assert (ragged > 0) == paged
    assert run.report["stream_compiles"] == 0


# -- the "mxu" row's column-walk kernel and the dense kernel's table variant ---

@pytest.mark.parametrize("r,s,C,lead,zeros", [
    (256, 512, 2048, (2,), 0.95), (64, 704, 2048, (3,), 0.95),
    (16, 48, 4096 + 4, (2,), 0.7), (64, 176, 1000, (), 0.7),
    (3, 8, 512, (2, 2), 0.0), (1, 5, 130, (), 0.0),
    (300, 40, 1003, (2,), 0.7)])
def test_mxu_kernel_matches_plain_on_card(cuda_device, r, s, C, lead, zeros):
    """apply_matrix_mxu_cuda (and the packed wrapper where C is whole
    rows) equals its plain version over the same kernel data
    (apply_matrix_walk_torch), the reference's MXU twin, the dense kernel
    and numpy, on composite-like sparse matrices, tails off the tile and
    the word, more rows than one tile, strided chunk slices and no batch
    dimension."""
    rng = np.random.default_rng(r * s + C)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < zeros] = 0
    ms = matrix_to_static(mat)
    host = rng.integers(0, 256, lead + (s + 1, C), dtype=np.uint8)
    x = torch.from_numpy(host).to(cuda_device)[..., 1:, :]
    before = gf_kernels.apply_matrix_mxu_cuda.launches
    got = gf_kernels.apply_matrix_mxu_cuda(x, ms)
    torch.cuda.synchronize()
    assert gf_kernels.apply_matrix_mxu_cuda.launches == before + 1
    assert torch.equal(got, apply_matrix_walk_torch(
        x, gf_kernels.walk_data(ms), r))
    assert torch.equal(got, apply_matrix_mxu_torch(x, ms))
    assert torch.equal(got, apply_matrix_cuda(x, ms))
    flat = host[..., 1:, :].reshape((-1, s, C))[0]
    assert np.array_equal(got.reshape((-1, r, C))[0].cpu().numpy(),
                          regionops.matrix_encode(flat, mat, 8))
    if C % 512 == 0:
        before = gf_kernels.apply_matrix_mxu_cuda_packed.launches
        gotp = gf_kernels.apply_matrix_mxu_cuda_packed(pack_chunks(x), ms)
        torch.cuda.synchronize()
        assert gf_kernels.apply_matrix_mxu_cuda_packed.launches == before + 1
        assert torch.equal(unpack_chunks(gotp), got)


@pytest.mark.parametrize("r,s,C,batch,split", [
    (64, 704, 2048, 4, True), (64, 704, 2048, 64, False),
    (600, 256, 4096, 2, True), (300, 200, 2052, 3, True),
    (40, 150, 1003, 2, False)])
def test_mxu_kernel_column_splits_and_row_tiles(cuda_device, r, s, C, batch,
                                                split):
    """The column split the kernel picks (the partials XORed into a
    zeroed output) at batches under a wave, none at a batch that fills
    one, and matrices of two and three row tiles equal the plain
    product; a C that is not a whole number of words takes no split."""
    rng = np.random.default_rng(r + s + batch)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.8] = 0
    ms = matrix_to_static(mat)
    x = torch.from_numpy(rng.integers(0, 256, (batch, s, C),
                                      dtype=np.uint8)).to(cuda_device)
    assert (gf_kernels.walk_splits(batch, C, ms, x.device) > 1) == split
    got = gf_kernels.apply_matrix_mxu_cuda(x, ms)
    torch.cuda.synchronize()
    assert torch.equal(got, apply_matrix_walk_torch(
        x, gf_kernels.walk_data(ms), r))
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    assert -(-r // gf_kernels.walk_row_tile(r)) == (1 if r <= 256 else
                                                    -(-r // 256))


def test_mxu_kernel_refuses_what_it_cannot_take(cuda_device):
    ms = matrix_to_static(np.ones((2, 3), dtype=np.int64))
    x = torch.zeros((4, 3, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda(x[:, :2], ms)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda(x[..., ::2], ms)
    with pytest.raises(ValueError):
        gf_kernels.apply_matrix_mxu_cuda_packed(x, ms)
    # 2^31 stripes of one word each: more blocks than a grid holds, so
    # the launch is refused and the wrapper raises (the output, 8 GiB,
    # is allocated first; the input is one stripe broadcast)
    one = matrix_to_static(np.ones((1, 3), dtype=np.int64))
    wide = x[:1, :, :4].expand(1 << 31, 3, 4)
    before = gf_kernels.apply_matrix_mxu_cuda.launches
    with pytest.raises(KernelLaunchError):
        gf_kernels.apply_matrix_mxu_cuda(wide, one)
    assert gf_kernels.apply_matrix_mxu_cuda.launches == before


@pytest.mark.parametrize("r,s,C", [(64, 704, 2048), (9, 300, 4096 + 4),
                                   (256, 512, 512)])
def test_dense_kernel_table_variant_on_card(cuda_device, r, s, C):
    """A row program above the by-value limit (BY_VALUE_MAX_PROG words)
    goes through the device buffer: dense, packed and both ragged
    wrappers equal their plain versions."""
    rng = np.random.default_rng(r + s + C)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.5] = 0
    ms = matrix_to_static(mat)
    assert len(gf_kernels.dense_program(ms)) > gf_kernels.BY_VALUE_MAX_PROG
    x = torch.from_numpy(rng.integers(0, 256, (4, s, C),
                                      dtype=np.uint8)).to(cuda_device)
    got = apply_matrix_cuda(x, ms)
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.uint8, device=cuda_device)
    assert torch.equal(gf_kernels.apply_matrix_cuda_ragged(x, ms, mask),
                       apply_matrix_ragged_torch(x, ms, mask))
    if C % 512 == 0:
        words = pack_chunks(x)
        assert torch.equal(unpack_chunks(apply_matrix_cuda_packed(words, ms)),
                           got)
        assert torch.equal(
            gf_kernels.apply_matrix_cuda_packed_ragged(words, ms, mask),
            apply_matrix_packed_ragged_torch(words, ms, mask))


@pytest.mark.parametrize("profile", [{"k": "4", "m": "2", "d": "5"},
                                     {"k": "8", "m": "4", "d": "11"}])
def test_clay_round_trips_on_card(cuda_device, profile):
    """Clay on the card: encode in both layouts, then every single
    erasure and a few doubles; at k=8 the encode and the data-chunk
    decodes take the column-walk kernel, the parity repairs the dense
    kernel's table variant."""
    ec = ErasureCodePluginRegistry.instance().factory("clay", dict(profile))
    assert ec.device.type == "cuda"
    k, n = ec.k, ec.k + ec.m
    chunk = ec.sub_chunk_no * 512
    host = np.random.default_rng(n).integers(0, 256, (2, k, chunk),
                                             dtype=np.uint8)
    data = torch.from_numpy(host).to(cuda_device)
    before = gf_kernels.launch_counts()
    parity = ec.encode_chunks_torch(data)
    assert torch.equal(unpack_chunks(ec.encode_chunks_packed_torch(
        pack_chunks(data))), parity)
    ec.min_xla_bytes = 1 << 40                     # the host tier
    assert np.array_equal(parity.cpu().numpy(), ec.encode_chunks_batch(host))
    full = torch.cat([data, parity], dim=1)
    for erased in [(e,) for e in range(n)] + [(0, 1), (1, n - 1)]:
        avail = tuple(i for i in range(n) if i not in erased)
        surv = full[:, list(avail)]
        rec = ec.decode_chunks_torch(surv, avail, erased)
        recp = ec.decode_chunks_packed_torch(pack_chunks(surv), avail,
                                             erased)
        assert torch.equal(rec, full[:, list(erased)]), erased
        assert torch.equal(unpack_chunks(recp), rec), erased
    torch.cuda.synchronize()
    after = gf_kernels.launch_counts()
    ran = {name: after[name] - before[name] for name in after}
    if profile["k"] == "8":
        # encode (2 layouts) + 8 data singles + 2 doubles, both layouts
        assert ran["apply_matrix_mxu_cuda"] == 1 + 10
        assert ran["apply_matrix_mxu_cuda_packed"] == 1 + 10
        assert ran["apply_matrix_cuda"] >= 4
        assert ran["apply_matrix_cuda_packed"] >= 4
    else:
        assert ran["apply_matrix_mxu_cuda"] == 0


# -- the roofline tool's probe kernels ------------------------------------------

@pytest.mark.parametrize("b,s,rows", [(64, 8, 256), (3, 5, 7), (1, 1, 1),
                                      (7, 3, 1001)])
def test_probe_kernels_match_plain_on_card(cuda_device, b, s, rows):
    """Copy and fold equal their plain versions; (7, 3, 1001) is 672672
    vectors, not a whole number of the copy's 512-vector blocks, nor of
    the card's waves of them."""
    rng = np.random.default_rng(b + s + rows)
    host = rng.integers(0, 1 << 32, (b, s, rows, 128), dtype=np.uint32)
    x = torch.from_numpy(host).to(cuda_device)
    before = (copy_slab_cuda.launches, fold_slab_cuda.launches)
    got = copy_slab_cuda(x)
    fold = fold_slab_cuda(x)
    torch.cuda.synchronize()
    assert (copy_slab_cuda.launches, fold_slab_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, copy_slab_torch(x))
    assert torch.equal(fold, fold_slab_torch(x))
    assert np.array_equal(fold.cpu().numpy(), np.bitwise_xor.reduce(
        host, axis=1, keepdims=True))
    strided = torch.zeros((2, 2, 2, 128), dtype=torch.uint32,
                          device=cuda_device)[:, ::2]
    for fn in (copy_slab_cuda, fold_slab_cuda):
        with pytest.raises(ValueError):
            fn(strided)


def test_roofline_tool_on_card(cuda_device):
    from ceph_tpu_torch.tools import roofline
    for name in roofline.PROBES:
        row = roofline.probe(name, 8, 4, "packed")
        assert row["input_gbps"] > 0 and row["device"] != "cpu"
        assert row["traffic_mult"] == roofline.traffic_mult(name)


# -- the dense kernel's row-program form ---------------------------------------

def _rs_decode_matrix(erased=(3, 9)):
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    mat = reed_sol_vandermonde_coding_matrix(8, 3, 8)
    avail = [i for i in range(11) if i not in erased]
    return matrix_to_static(regionops.matrix_decode_matrix(
        mat, 8, avail[:8], list(erased)))


def _one_launch(fn, wrapper, *args):
    before = wrapper.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert wrapper.launches - before == 1
    return got


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_dense_kernel_both_sides_of_the_wave_rule(cuda_device, batch):
    """The RS decode e=2 matrix at 1 and 4 stripes (below a wave of the
    card: one stripe a block) and 64 (a block walks several), one launch
    a call, both layouts equal to the plain version."""
    dm = _rs_decode_matrix()
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.integers(0, 256, (batch, 8, 131072),
                                      dtype=np.uint8)).to(cuda_device)
    grid = gf_kernels.dense_plan(batch, 131072, dm, cuda_device)
    assert grid[0] == 131072 // (16 * gf_kernels.DENSE_UNITS)
    assert grid[2] == 1
    assert grid[1] == batch if batch < 64 else grid[1] < batch
    want = apply_matrix_torch(x, dm, 8)
    assert torch.equal(_one_launch(apply_matrix_cuda, apply_matrix_cuda, x,
                                   dm), want)
    assert torch.equal(unpack_chunks(_one_launch(
        apply_matrix_cuda_packed, apply_matrix_cuda_packed, pack_chunks(x),
        dm)), want)


@pytest.mark.parametrize("r,s", [(9, 8), (17, 11), (64, 8), (12, 40)])
def test_dense_kernel_takes_every_row_in_one_launch(cuda_device, r, s):
    """More rows than a row block (and, at s > 11, a row per block): one
    launch per call, zero rows and columns, all-ones rows."""
    rng = np.random.default_rng(r * s)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.3] = 0
    mat[:, 1] = 0
    mat[0] = 1
    mat[2] = 0
    ms = matrix_to_static(mat)
    x = torch.from_numpy(rng.integers(0, 256, (3, s, 8192),
                                      dtype=np.uint8)).to(cuda_device)
    got = _one_launch(apply_matrix_cuda, apply_matrix_cuda, x, ms)
    assert torch.equal(got, apply_matrix_torch(x, ms, 8))
    assert not got[:, 2].any()
    assert gf_kernels.dense_plan(3, 8192, ms, cuda_device)[2] == \
        gf_kernels.dense_geometry(r, s)[0]


@pytest.mark.parametrize("C", [4097, 4096 + 4, 4096 + 16, 15, 1])
def test_dense_kernel_tails_and_strided_slices(cuda_device, C):
    """A chunk size off the 16-byte unit, and a survivor slice whose
    first chunk is not the tensor's (strided chunk axis, a base off 16
    bytes where C is): staged and stored byte by byte where needed."""
    dm = _rs_decode_matrix((1, 5, 10))
    rng = np.random.default_rng(C)
    wide = torch.from_numpy(rng.integers(0, 256, (4, 10, C),
                                         dtype=np.uint8)).to(cuda_device)
    x = wide[:, 1:9]
    want = apply_matrix_torch(x.contiguous(), dm, 8)
    assert torch.equal(_one_launch(apply_matrix_cuda, apply_matrix_cuda, x,
                                   dm), want)
    assert torch.equal(apply_matrix_cuda(x.contiguous(), dm), want)


@pytest.mark.parametrize("pages", [4, 512])
@pytest.mark.parametrize("kind", ["dead", "half", "live"])
def test_ragged_masks_both_sides_of_the_wave_rule(cuda_device, pages, kind):
    """All-dead, half-live and all-live masks over a pool of 4 pages
    (below a wave) and 512 (above): dead pages zero, both wrappers equal
    their plain versions in one launch."""
    from ceph_tpu_torch.matrices.jerasure import \
        reed_sol_vandermonde_coding_matrix
    ms = matrix_to_static(reed_sol_vandermonde_coding_matrix(8, 3, 8))
    rng = np.random.default_rng(pages)
    pool = torch.from_numpy(rng.integers(0, 256, (pages, 8, 4096),
                                         dtype=np.uint8)).to(cuda_device)
    live = {"dead": np.zeros(pages, bool), "live": np.ones(pages, bool),
            "half": np.arange(pages) % 2 == 1}[kind]
    mask = torch.from_numpy(live.astype(np.uint8)).to(cuda_device)
    got = _one_launch(gf_kernels.apply_matrix_cuda_ragged,
                      gf_kernels.apply_matrix_cuda_ragged, pool, ms, mask)
    assert torch.equal(got, apply_matrix_ragged_torch(pool, ms, mask))
    assert not got[~torch.from_numpy(live).to(cuda_device)].any()
    words = pack_chunks(pool)
    gotp = _one_launch(gf_kernels.apply_matrix_cuda_packed_ragged,
                       gf_kernels.apply_matrix_cuda_packed_ragged, words,
                       ms, mask)
    assert torch.equal(gotp, apply_matrix_packed_ragged_torch(words, ms,
                                                              mask))


@pytest.mark.parametrize("r,s", [(64, 704), (256, 512)])
def test_dense_table_variant_on_sparse_matrices(cuda_device, r, s):
    """A sparse (64, 704) like clay's repairs and a (256, 512): the row
    program through its device buffer, a row per block, one launch."""
    rng = np.random.default_rng(r + s)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.96] = 0
    mat[:, : s // 4] = 0
    ms = matrix_to_static(mat)
    assert len(gf_kernels.dense_program(ms, 8)) > \
        gf_kernels.BY_VALUE_MAX_PROG
    x = torch.from_numpy(rng.integers(0, 256, (4, s, 2048),
                                      dtype=np.uint8)).to(cuda_device)
    want = apply_matrix_torch(x, ms, 8)
    assert torch.equal(_one_launch(apply_matrix_cuda, apply_matrix_cuda, x,
                                   ms), want)
    assert torch.equal(unpack_chunks(_one_launch(
        apply_matrix_cuda_packed, apply_matrix_cuda_packed, pack_chunks(x),
        ms)), want)


# -- CRUSH: the bulk evaluator on the card against its CPU run --------------

def _crush_two_level(hosts, devs, rule):
    from ceph_tpu_torch.crush.builder import CrushBuilder
    from ceph_tpu_torch.crush.types import (
        step_chooseleaf_firstn, step_chooseleaf_indep, step_emit,
        step_take)
    b = CrushBuilder()
    root = b.build_two_level(hosts, devs)
    if rule == "firstn":
        b.add_rule(0, [step_take(root), step_chooseleaf_firstn(0, 1),
                       step_emit()])
    else:
        b.add_erasure_rule("root", [step_chooseleaf_indep(0, 1)],
                           rule_id=0)
    return b


@pytest.mark.parametrize("hosts,devs,rule,nrep", [
    (8, 4, "firstn", 3), (8, 4, "ec", 6), (100, 12, "ec", 11),
    (6, 2, "ec", 8)])
def test_crush_bulk_on_the_card_equals_its_cpu_run(cuda_device, hosts,
                                                   devs, rule, nrep):
    """Rows A-C of chip_smoke.py phase 6 at 8192 x, and a rule wider
    than the hosts (holes, every rung of the ladder); with reweights."""
    from ceph_tpu_torch.crush import bulk
    b = _crush_two_level(hosts, devs, rule)
    xs = np.arange(8192) + (1 << 32) - 4096
    w = b.map.device_weights()
    w[1], w[5] = 0, 0x7000
    for weight in (None, w):
        cm = bulk.CompiledCrushMap(b.map)
        assert cm.items.device.type == "cuda"
        got = bulk.bulk_do_rule(cm, 0, xs, nrep, weight=weight)
        want = bulk.bulk_do_rule(b.map, 0, xs, nrep, weight=weight,
                                 device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_crushtool_and_osdmaptool_on_the_card(cuda_device, tmp_path,
                                              capsys):
    """The CLIs' default device is the card: the same text as --device
    cpu."""
    from ceph_tpu_torch.bench import crushtool, osdmaptool
    argv = ["--build-two-level", "8", "4", "--test", "--num-rep", "3",
            "--max-x", "4095", "--show-mappings"]
    outs = []
    for extra in ([], ["--device", "cpu"]):
        assert crushtool.main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    path = str(tmp_path / "m.json")
    assert osdmaptool.main(["--createsimple", "24", "-o", path,
                            "--pg-num", "512"]) == 0
    outs = []
    for extra in ([], ["--device", "cpu"]):
        capsys.readouterr()
        assert osdmaptool.main([path, "--upmap", "-", "--upmap-max",
                                "30"] + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "pg-upmap-items" in outs[0]


def test_crush_bulk_ties_on_the_card(cuda_device):
    """Every draw of a bucket equal (choose_args ids alike, equal
    weights; then an all-zero weight set at the root): the card's
    argmin / uint8 argmax keep the first slot, as the CPU run and the
    host mapper do."""
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    from ceph_tpu_torch.crush.types import ChooseArg
    b = _crush_two_level(4, 3, "firstn")
    args = {bid: ChooseArg(weight_set=[[0x10000] * bk.size],
                           ids=[77] * bk.size)
            for bid, bk in b.map.buckets.items()}
    xs = np.arange(512)
    for _ in range(2):
        got = bulk.bulk_do_rule(b.map, 0, xs, 3, choose_args=args)[0]
        want = bulk.bulk_do_rule(b.map, 0, xs, 3, choose_args=args,
                                 device="cpu")[0]
        np.testing.assert_array_equal(got, want)
        for x in range(0, 512, 37):
            r = crush_do_rule(b.map, 0, x, 3, choose_args=args)
            assert list(got[x][:len(r)]) == r
        root = max(b.map.buckets, key=lambda bid: b.map.buckets[bid].type)
        args[root] = ChooseArg(weight_set=[[0] * 4])


# -- CRUSH: the rule kernel against the host mapper -------------------------

def _crush_host_rows(cmap, rule, xs, nrep, weight=None, choose_args=None):
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    rows = [crush_do_rule(cmap, rule, int(x), nrep, weight=weight,
                          choose_args=choose_args) for x in xs]
    return (np.asarray([r + [0x7FFFFFFF] * (nrep - len(r)) for r in rows],
                       np.int32),
            np.asarray([len(r) for r in rows], np.int32))


def _crush_kernel_sweep(cm, rule, xs, nrep, weight=None):
    """bulk_do_rule on the card: (out, count, the rule kernel's launches);
    the kernel placed every lane (no flag, no residue)."""
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.ops import crush_kernels
    assert crush_kernels.kernel_rule(cm, rule, nrep) is not None
    before = crush_kernels.crush_rule_cuda.launches
    out, cnt = bulk.bulk_do_rule(cm, rule, xs, nrep, weight=weight)
    assert cm.last_flagged.size == 0 and cm.last_residue.size == 0
    return out, cnt, crush_kernels.crush_rule_cuda.launches - before


def _crush_weights(n, downs, reweights, seed):
    rng = np.random.default_rng(seed)
    w = [0x10000] * n
    picks = rng.choice(n, downs + reweights, replace=False)
    for o in picks[:downs]:
        w[o] = 0
    for o in picks[downs:]:
        w[o] = int(rng.integers(0x8000, 0x10000))
    return w


def test_crush_kernel_on_the_remap_cells_map(cuda_device, monkeypatch):
    """Every PG of the remap cell's pool (16384, 100 hosts x 12, the EC
    rule 11 wide), 8 OSDs down and 40 reweighted in [0.5, 1.0]: the rule
    kernel gives the eager tier's up sets (the same sweep with the
    kernel off: its rungs and host residue are the host mapper's
    answers) on every lane and crush_do_rule's on a seeded sample; it
    launched, flagged nothing and left no residue."""
    import json
    import os
    import sys
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.telemetry import spans
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks")
    sys.path.insert(0, bench)
    from yardstick.kinds.osdmap_churn import build
    with open(os.path.join(bench, "configs", "rs_k8_m3.json")) as f:
        config = json.load(f)
    osdmap, pid = build(config, cuda_device)
    pool = osdmap.pools[pid]
    cm = osdmap._compiled_map()
    w = _crush_weights(osdmap.max_osd, 8, 40, 23)
    xs = np.asarray(pool.pps_all(), np.int64)
    tracer = spans.global_tracer()
    tracer.reset()
    with spans.armed(), spans.root("test.sweep"):
        got, cnt, launches = _crush_kernel_sweep(cm, pool.crush_rule, xs,
                                                 pool.size, w)
    assert launches >= 1
    noted = tracer.totals()["crush.rung"]["counts"]
    assert noted["kernel_lanes"] == len(xs) and noted["kernel_flagged"] == 0
    monkeypatch.setattr(bulk, "_rule_kernel", lambda *a: None)
    want, want_n = bulk.bulk_do_rule(cm, pool.crush_rule, xs, pool.size,
                                     weight=w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cnt, want_n)
    pick = np.random.default_rng(7).choice(len(xs), 48, replace=False)
    host, host_n = _crush_host_rows(osdmap.crush, pool.crush_rule,
                                    xs[pick], pool.size, w)
    np.testing.assert_array_equal(got[pick], host)
    np.testing.assert_array_equal(cnt[pick], host_n)


@pytest.mark.parametrize("hosts,devs,rule,nrep", [
    (8, 4, "firstn", 3), (8, 4, "ec", 6), (6, 2, "ec", 8)])
def test_crush_kernel_equals_the_host_mapper_on_the_card(
        cuda_device, hosts, devs, rule, nrep):
    """chip_smoke.py phase 6's rows A and B and a rule wider than its
    hosts (NONE holes), x near 2^32, with and without reweights: every
    lane the host mapper's."""
    from ceph_tpu_torch.crush import bulk
    b = _crush_two_level(hosts, devs, rule)
    xs = np.arange(1024) + (1 << 32) - 512
    for weight in (None, _crush_weights(hosts * devs, 2, 4, hosts)):
        cm = bulk.CompiledCrushMap(b.map)
        got, cnt, launches = _crush_kernel_sweep(cm, 0, xs, nrep, weight)
        assert launches >= 1
        want, want_n = _crush_host_rows(b.map, 0, xs, nrep, weight)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cnt, want_n)


def test_crush_kernel_ties_and_weight_sets_on_the_card(cuda_device):
    """Weight ties (every draw of a bucket equal, then an all-zero
    weight set at the root) and choose_args weight sets by position with
    ids: the kernel keeps C's first slot and reads the position's
    weights."""
    from ceph_tpu_torch.crush import bulk
    from ceph_tpu_torch.crush.types import ChooseArg
    b = _crush_two_level(4, 3, "firstn")
    args = {bid: ChooseArg(weight_set=[[0x10000] * bk.size],
                           ids=[77] * bk.size)
            for bid, bk in b.map.buckets.items()}
    xs = np.arange(256)
    for _ in range(2):
        cm = bulk.CompiledCrushMap(b.map, args)
        got, cnt, _ = _crush_kernel_sweep(cm, 0, xs, 3)
        want, want_n = _crush_host_rows(b.map, 0, xs, 3, None, args)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cnt, want_n)
        root = max(b.map.buckets, key=lambda bid: b.map.buckets[bid].type)
        args[root] = ChooseArg(weight_set=[[0] * 4])
    b = _crush_two_level(8, 4, "ec")
    rng = np.random.default_rng(3)
    args = {bid: ChooseArg(
        weight_set=[[int(w * rng.uniform(0.5, 1.5))
                     for w in bk.item_weights] for _ in range(3)],
        ids=[i + 1000 for i in bk.items])
        for bid, bk in b.map.buckets.items()}
    cm = bulk.CompiledCrushMap(b.map, args)
    got, cnt, _ = _crush_kernel_sweep(cm, 0, xs, 6)
    want, want_n = _crush_host_rows(b.map, 0, xs, 6, None, args)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cnt, want_n)


# -- scrub, repair and recovery on the card ------------------------------------

SCRUB_FAMILIES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "3",
                  "packetsize": "32"}),
    ("isa", {"k": "8", "m": "3"}),
    ("shec", {"k": "6", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "8", "m": "4", "d": "11"}),
]


def _scrub_objects(ec, count, size, seed):
    from ceph_tpu_torch.codes.stripe import HashInfo, StripeInfo, encode
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    chunk = ec.get_chunk_size(size)
    sinfo = StripeInfo(k, k * chunk)
    rng = np.random.default_rng(seed)
    objs = []
    for _ in range(count):
        obj = rng.integers(0, 256, k * chunk, dtype=np.uint8).tobytes()
        shards = encode(sinfo, ec, obj)
        hinfo = HashInfo(n)
        hinfo.append(0, shards)
        objs.append((shards, hinfo))
    return sinfo, chunk, objs


def _scrub_stores(objs, pats, chunk, seed):
    from ceph_tpu_torch.chaos import BitFlip, ShardErasure, inject
    stores = []
    for i, (shards, _) in enumerate(objs):
        erased, flipped = pats[i % len(pats)]
        inj = [ShardErasure(shards=list(erased))] + (
            [BitFlip(shards=list(flipped), flips=1)] if flipped else [])
        stores.append(inject(shards, inj, seed=seed + i,
                             chunk_size=chunk)[0])
    return stores


@pytest.mark.parametrize("plugin,profile", SCRUB_FAMILIES,
                         ids=[f"{p}-{d.get('technique', '')}"
                              for p, d in SCRUB_FAMILIES])
def test_repair_batched_on_the_card_equals_the_host_path(cuda_device,
                                                         plugin, profile):
    """Each family's batched repair on the card: one device call per
    pattern, launches of the port's kernels, and the healed stores equal
    to the objects and to the host path's (a CPU code on the numpy
    tier, ``device=False``)."""
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.scrub import repair_batched
    reg = ErasureCodePluginRegistry.instance()
    ec = reg.factory(plugin, dict(profile), device="cuda")
    host = reg.factory(plugin, dict(profile), device="cpu")
    host.min_xla_bytes = float("inf")
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    pats = [([1], []), ([], [k]), ([0], [n - 1])]
    pats = [p for p in pats if _decodable(ec, p, n)]
    sinfo, chunk, objs = _scrub_objects(ec, 6, 64 << 10, seed=3)
    hinfos = [h for _, h in objs]
    on_card = _scrub_stores(objs, pats, chunk, seed=5)
    on_host = _scrub_stores(objs, pats, chunk, seed=5)
    reset_launch_counts()
    rep = repair_batched(sinfo, ec, on_card, hinfos)
    launched = {kk: v for kk, v in launch_counts().items() if v}
    hrep = repair_batched(sinfo, host, on_host, hinfos, device=False)
    assert rep.device_calls == rep.pattern_batches == len(pats)
    assert hrep.host_batches == len(pats) and rep.host_batches == 0
    assert launched
    for a, b, (shards, _) in zip(on_card, on_host, objs):
        assert a.snapshot() == b.snapshot() == {
            s: bytes(v) for s, v in shards.items()}


def _decodable(ec, pat, n) -> bool:
    bad = set(pat[0]) | set(pat[1])
    try:
        ec.minimum_to_decode(bad, set(range(n)) - bad)
        return True
    except (IOError, ValueError):
        return False


def test_recovery_churn_on_the_card_loses_nothing(cuda_device):
    """The orchestrator under MapChurn with the fused repair on the card
    converges with every store healed, as on the CPU."""
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    runs = {}
    for dev in ("cuda", "cpu"):
        bench = ErasureCodeBench()
        bench.setup(["--plugin", "jerasure", "-P", "technique=reed_sol_van",
                     "-P", "k=8", "-P", "m=3", "--workload",
                     "recovery-churn", "--size", str(256 << 10), "--batch",
                     "6", "-e", "1", "--device", dev])
        res = bench.run()
        run = bench.last_run
        for stores in run.runs:
            for st, (shards, _) in zip(stores, run.objects):
                assert st.snapshot() == {s: bytes(v)
                                         for s, v in shards.items()}
        runs[dev] = {f: res[f] for f in ("pattern_batches", "device_calls",
                                         "replans", "regroups", "rounds",
                                         "epochs_advanced")}
    assert runs["cuda"] == runs["cpu"] and runs["cuda"]["epochs_advanced"]


def test_forced_numpy_tier_on_a_card_code_raises(cuda_device):
    """device=None on a card code never moves the repair to the host: a
    forced numpy tier raises before anything is written."""
    from ceph_tpu_torch.scrub import repair_batched
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    sinfo, chunk, objs = _scrub_objects(ec, 2, 64 << 10, seed=1)
    stores = _scrub_stores(objs, [([1], [])], chunk, seed=2)
    before = [s.snapshot() for s in stores]
    prev = fallback.set_global_policy(fallback.FallbackPolicy("numpy"))
    try:
        with pytest.raises(ValueError, match="forced"):
            repair_batched(sinfo, ec, stores, [h for _, h in objs])
    finally:
        fallback.set_global_policy(prev)
    assert [s.snapshot() for s in stores] == before


# -- the supervised dispatch plane on the card ----------------------------------

def _isolated_supervisor(**kw):
    """A fresh policy and supervisor installed globally (on the system
    clock); returns (supervisor, restore)."""
    from ceph_tpu_torch.ops import supervisor
    pol = fallback.FallbackPolicy(force=None)
    prev_pol = fallback.set_global_policy(pol)
    sup = supervisor.DispatchSupervisor(**kw)
    prev = supervisor.set_global_supervisor(sup)

    def restore():
        supervisor.set_global_supervisor(prev)
        fallback.set_global_policy(prev_pol)
    return sup, restore


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
    ("jerasure", {"technique": "cauchy_good", "k": "8", "m": "3"}),
    ("shec", {"k": "6", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
], ids=["rs", "cauchy", "shec", "lrc"])
def test_supervised_fused_repair_launches_as_unsupervised(cuda_device,
                                                          plugin, profile):
    """One supervised fused repair on a clean card launches exactly the
    kernels the same call launches with the supervisor's mark set (its
    body alone), counts one dispatch, and returns the same bytes."""
    from ceph_tpu_torch.codes.engine import fused_repair_call
    from ceph_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from ceph_tpu_torch.ops.supervisor import _inside_seam
    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, dict(profile), device="cuda")
    n = ec.get_chunk_count()
    avail = tuple(range(1, n))
    chunk = ec.get_chunk_size(ec.get_data_chunk_count() * (64 << 10))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, len(avail), chunk), dtype=np.uint8)).to(cuda_device)
    sup, restore = _isolated_supervisor()
    try:
        call = fused_repair_call(ec, avail, (0,))
        call(x)                                     # warm
        counts = []
        outs = []
        for mark in (False, True):
            torch.cuda.synchronize()
            reset_launch_counts()
            d0 = sup.stats()["dispatches"]
            if mark:
                with _inside_seam():
                    outs.append(call(x))
            else:
                outs.append(call(x))
            torch.cuda.synchronize()
            counts.append(({k: v for k, v in launch_counts().items() if v},
                           sup.stats()["dispatches"] - d0))
        assert counts[0][0] == counts[1][0] and counts[0][0]
        assert counts[0][1] == 1 and counts[1][1] == 0
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        st = sup.stats()
        assert st["retries"] == st["demotions"] == 0
        assert st["host_completions"] == st["rung_downshifts"] == 0
    finally:
        restore()


def test_device_chaos_at_64k_on_the_card(cuda_device):
    """The bench's device-chaos row on the card: 4 faults fire, the retry
    and the rung split launch the kernel again, the loss raises at each
    of its two calls and the pass is re-queued; nothing demotes, no host
    twin runs, and the heal is byte-identical."""
    from ceph_tpu_torch.bench.erasure_code_benchmark import ErasureCodeBench
    sup, restore = _isolated_supervisor()
    try:
        bench = ErasureCodeBench()
        bench.setup(["--plugin", "jerasure", "-P", "technique=reed_sol_van",
                     "-P", "k=8", "-P", "m=3", "--size", str(64 << 10),
                     "--workload", "device-chaos", "--device", "cuda",
                     "--batch", "8", "--iterations", "1", "-e", "1",
                     "--seed", "42"])
        res = bench.run()
        sv = res["supervisor"]
        assert res["verified"] and res["faults_fired"] == 4
        assert sv["retries"] >= 1 and sv["rung_downshifts"] >= 1
        assert sv["card_failures"] == 2
        assert sv["demotions"] == sv["host_completions"] == 0
        assert sv["repromotions"] == 0 and res["demoted_at_end"] is False
        assert fallback.global_policy().engine(cuda_device) == "cuda"
    finally:
        restore()


def test_card_loss_raises_and_the_kernel_launches_again(cuda_device):
    """A persistent loss at ops.apply_matrix on card tensors raises
    DeviceDispatchError naming the seam: no demotion, no plain ops, no
    host twin.  Once the fault clears the dense kernel launches again
    and the bytes are the kernel's."""
    from ceph_tpu_torch.chaos.dispatch import DispatchFault, dispatch_faults
    from ceph_tpu_torch.utils.errors import DeviceDispatchError
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    ms = matrix_to_static(ec.matrix)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (4, 8, 65536), dtype=np.uint8)).to(cuda_device)
    want = apply_matrix_best(x, ms)
    sup, restore = _isolated_supervisor()
    try:
        with dispatch_faults([DispatchFault(
                "backend_loss", seam="ops.apply_matrix", at=1, calls=2)],
                seed=1):
            for _ in range(2):
                with pytest.raises(DeviceDispatchError) as got:
                    apply_matrix_best(x, ms)
                assert got.value.seam == "ops.apply_matrix"
                assert got.value.kind == "backend_loss"
            st = sup.stats()
            assert st["card_failures"] == 2
            assert st["demotions"] == st["host_completions"] == 0
            assert not sup.demoted
            before = apply_matrix_cuda.launches
            assert torch.equal(apply_matrix_best(x, ms), want)
            assert apply_matrix_cuda.launches > before
    finally:
        restore()


# -- the data plane on the card: 4 virtual members over one card -------------

@pytest.fixture
def card_plane(cuda_device, monkeypatch):
    """A plane of 4 virtual members over the card, torn down after."""
    from ceph_tpu_torch.parallel import plane
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "4")
    prev = plane.set_data_plane(None)
    p = plane.activate(4, kind="cuda")
    assert p is not None and p.kind == "cuda"
    yield p
    plane.set_data_plane(prev)


def test_mesh_tier_on_four_members_equals_the_kernel(card_plane):
    """The mesh row on card tensors: 4 shards of 16 stripes, each on the
    dense kernel (4 launches where the single-device call makes 1), the
    bytes the single-device call's, bytes and packed, and a batch of 63
    padded to 64."""
    from ceph_tpu_torch.utils.shard import last_partition
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    ms = matrix_to_static(ec.matrix)
    x = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (64, 8, 65536), dtype=np.uint8)).cuda()
    assert select_matrix_engine(8, x.device, shape=tuple(x.shape),
                                matrix_t=ms) == "mesh"
    before = apply_matrix_cuda.launches
    want = apply_matrix_best(x, ms, mesh=0)
    single = apply_matrix_cuda.launches - before
    before = apply_matrix_cuda.launches
    got = apply_matrix_best(x, ms)
    assert apply_matrix_cuda.launches - before == 4 * single
    assert torch.equal(got, want) and last_partition() == [16] * 4
    words = pack_chunks(x)
    assert torch.equal(unpack_chunks(apply_matrix_packed_best(words, ms)),
                       want)
    assert torch.equal(apply_matrix_best(x[:63], ms), want[:63])
    assert last_partition() == [16] * 4


def test_member_quarantine_stays_on_the_card(card_plane):
    """A loss of two calls at the fused-repair seam on a 4-member card
    plane halves the plane twice (4 -> 2 -> single-device) and the
    dispatch completes with the kernel's bytes on the card — no
    demotion, no host twin, no DeviceDispatchError; re-promotion
    restores the 4 members."""
    from ceph_tpu_torch.chaos.dispatch import DispatchFault, dispatch_faults
    from ceph_tpu_torch.codes.engine import fused_repair_call
    from ceph_tpu_torch.parallel import plane
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    avail, erased = tuple(range(1, 11)), (0,)
    stack = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (16, 10, 65536), dtype=np.uint8)).cuda()
    want = fused_repair_call(ec, avail, erased, mesh=False)(stack)
    sup, restore = _isolated_supervisor(promote_after=1, probe_every=1)
    try:
        with dispatch_faults([DispatchFault(
                "backend_loss", seam="engine.fused_repair", at=1,
                calls=2)], seed=2):
            got = fused_repair_call(ec, avail, erased)(stack)
        assert all(torch.equal(a, b) and a.is_cuda
                   for a, b in zip(got, want))
        st = sup.stats()
        assert st["quarantines"] == 2 and st["card_failures"] == 0
        assert st["demotions"] == st["host_completions"] == 0
        sup.tick()
        assert plane.data_plane().n_devices == 4 and not sup.demoted
        assert fallback.global_policy().engine(stack.device) == "cuda"
    finally:
        restore()


def test_width1_loss_on_the_card_raises(card_plane):
    """With the plane gone (width 1), a loss on card tensors raises
    DeviceDispatchError naming the seam, as it does with no plane."""
    from ceph_tpu_torch.chaos.dispatch import DispatchFault, dispatch_faults
    from ceph_tpu_torch.parallel import plane
    from ceph_tpu_torch.utils.errors import DeviceDispatchError
    plane.set_data_plane(None)
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device="cuda")
    ms = matrix_to_static(ec.matrix)
    x = torch.zeros((8, 8, 4096), dtype=torch.uint8, device="cuda")
    sup, restore = _isolated_supervisor()
    try:
        with dispatch_faults([DispatchFault(
                "backend_loss", seam="ops.apply_matrix", at=1,
                calls=None)], seed=1):
            with pytest.raises(DeviceDispatchError) as got:
                apply_matrix_best(x, ms)
        assert got.value.seam == "ops.apply_matrix"
        st = sup.stats()
        assert st["card_failures"] == 1 and st["quarantines"] == 0
        assert st["demotions"] == 0
    finally:
        restore()


# -- the program profiler, the tuning table and the registry audit ----------

def test_profiler_times_a_seam_with_cuda_events(cuda_device):
    """The serve-encode seam on the card: one analytic program, its
    calls timed with CUDA event pairs (each less the pair's own cost)
    read lazily, close to the kernel's own time when the stream is
    held, its utilization resolved by the card's name."""
    from ceph_tpu_torch.codes.engine import serve_dispatch_call
    from ceph_tpu_torch.telemetry import profiler
    prev = profiler.set_global_profiler(profiler.ProgramProfiler())
    try:
        ec = ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
            device=cuda_device)
        x = torch.randint(0, 256, (64, 8, 131072), dtype=torch.uint8,
                          device=cuda_device)
        call = serve_dispatch_call(ec, "encode")
        call(x)
        torch.cuda.synchronize()
        for _ in range(10):
            profiler.hold_stream(cuda_device, 1)
            call(x)
        prof = profiler.global_profiler()
        assert len(prof._pending) >= 10          # read later, not per call
        rows = prof.attribution_rows()
        assert prof._pending == []
        (row,) = rows
        assert row["platform"] == "cuda" and row["source"] == "analytic"
        assert row["calls"] == 11 and 0.02 < row["p50_ms"] < 0.2
        assert 0 < profiler.event_pair_overhead(cuda_device) < 2e-5
        if torch.cuda.get_device_name() in profiler.CARD_PEAK_GBPS:
            assert 0 < row["utilization_pct"] <= 100
    finally:
        profiler.set_global_profiler(prev)


def test_registry_audit_on_the_card(cuda_device, monkeypatch):
    """Every entry of the registry audits clean on the card: setups cold
    within budget and none warm, no host sync on a warm repeat except
    CRUSH's declared one, every tier's bytes equal."""
    from ceph_tpu_torch.analysis.audit import audit_registry
    monkeypatch.setenv("CEPH_TPU_TORCH_VIRTUAL_DEVICES", "4")
    got = audit_registry(device=cuda_device)
    assert [a.name for a in got if not a.ok] == []
    assert {a.name for a in got if a.sync == "declared"} == {
        "crush.bulk_rule", "crush.bulk_rule_sharded",
        "cluster.balancer_round", "cluster.storm_reeval"}


def test_timed_sweep_on_the_card_pins_the_r6_encode(cuda_device):
    """The r6 encode's candidates on the card (dense, XOR schedule,
    column walk) give identical bytes; a pin, when one wins, routes the
    encode there with the default's bytes."""
    from ceph_tpu_torch.tune import sweep, table
    profile = {"technique": "reed_sol_r6_op", "k": "8", "m": "2"}
    rep = sweep.timed_sweep("jerasure", profile, size=1 << 20, batch=64,
                            repeats=5, device=cuda_device)
    row = rep.rows[0]
    assert set(row["candidates_ms"]) == {"cuda", "xor", "mxu"}
    assert row["before"]["engine"] == "xor"
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", profile, device=cuda_device)
    x = torch.randint(0, 256, (64, 8, 131072), dtype=torch.uint8,
                      device=cuda_device)
    want = ec.encode_chunks_torch(x)
    with table.scoped_table(rep.table):
        got = ec.encode_chunks_torch(x)
        eng = select_matrix_engine(8, cuda_device, shape=tuple(x.shape),
                                   matrix_t=matrix_to_static(ec.matrix))
    assert torch.equal(got, want)
    pinned = row["key"] in rep.table.entries
    assert eng == row["after" if pinned else "before"]["engine"]


# -- the cluster plane and the scenarios on the card -----------------------

def test_cluster_storm_and_balance_on_the_card_equal_the_host_mapper(
        cuda_device):
    """A churn storm and the balancer on the card's bulk evaluator give
    the host mapper's reports and upmap items, and the storm
    equivalence gate holds on the card."""
    from ceph_tpu_torch.chaos import MapChurn
    from ceph_tpu_torch.cluster import (ClusterSpec, balance_cluster,
                                        build_cluster, run_churn_storm,
                                        verify_storm_equivalence)
    spec = ClusterSpec.sized(60, seed=7, replicated_pg_num=64,
                             ec_pg_num=16)
    card = build_cluster(spec, device=cuda_device)
    host = build_cluster(spec, device="cpu")
    churn = MapChurn(seed=3, max_down=4, fire_every=1, max_events=4)
    s_card = run_churn_storm(card, seed=3, churn=churn, events=4,
                             engine="bulk")
    s_host = run_churn_storm(host, seed=3, events=4, max_down=4,
                             engine="host")
    want = s_host.to_dict()
    want["engine"] = "bulk"
    assert s_card.to_dict() == want
    verify_storm_equivalence(card, churn,
                             lambda: build_cluster(spec, device="cuda"),
                             engine="bulk", scalar_samples=4)
    b_card = balance_cluster(card, engine="bulk")
    b_host = balance_cluster(host, engine="host")
    want = b_host.to_dict()
    want["engine"] = "bulk"
    assert b_card.to_dict() == want
    assert card.pg_upmap_items == host.pg_upmap_items


def test_scenario_on_the_card_equals_its_cpu_run(cuda_device):
    """The simulated production day on the card: the report JSON and
    the dispatch log equal the same run on CPU tensors, the gates hold,
    and the kernels launched."""
    from ceph_tpu_torch.ops.launches import (launch_counts,
                                             reset_launch_counts)
    from ceph_tpu_torch.parallel.plane import set_data_plane
    from ceph_tpu_torch.scenario import default_scenario, run_scenario
    from ceph_tpu_torch.serve.loadgen import throughput_service_model
    from ceph_tpu_torch.utils.retry import FakeClock
    spec = default_scenario(seed=42, n_requests=32, damaged_objects=2,
                            storm_events=2)
    prev = set_data_plane(None)
    reset_launch_counts()
    try:
        runs = {dev: run_scenario(spec, clock=FakeClock(), device=dev,
                                  service_model=throughput_service_model())
                for dev in ("cpu", "cuda")}
    finally:
        set_data_plane(prev)
    card, cpu = runs["cuda"], runs["cpu"]
    assert card.report.to_json() == cpu.report.to_json()
    assert card.serving.batcher.dispatch_log == \
        cpu.serving.batcher.dispatch_log
    assert card.report.ok() and card.report.slo["stream_compiles"] == 0
    assert sum(launch_counts().values()) > 0


def test_tenant_week_on_the_card_equals_its_cpu_run(cuda_device):
    from ceph_tpu_torch.scenario import run_tenant_week, tenant_week_scenario
    spec = tenant_week_scenario(seed=17, days=2, day_s=6.0,
                                peak_rates=(40.0, 30.0, 20.0),
                                burst_factor=80.0)
    card = run_tenant_week(spec, device=cuda_device).report
    cpu = run_tenant_week(spec, device="cpu").report
    assert card.gates["dispatch_crc"] == cpu.gates["dispatch_crc"]
    assert card.to_json() == cpu.to_json()
    assert card.gates["converged"] and card.gates["healed"]


def _sync_warnings(fn):
    """(fn's result, the synchronising-call warnings it raised under
    ``torch.cuda.set_sync_debug_mode("warn")``, each as file:line)."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def test_noted_host_syncs_equal_torchs_count_on_the_card(cuda_device):
    """One epoch of the remap cell's map (1200 OSDs, 16384 PGs): the
    host syncs the spans note equal the synchronising calls torch
    counts; an RS encode and a shec decode note none and make none;
    and the benchmark's CUDA-only profiler session arms the sites."""
    import collections
    import json
    import os
    import sys
    from ceph_tpu_torch.telemetry import spans
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks")
    sys.path.insert(0, bench)
    from yardstick.kinds.osdmap_churn import build
    from yardstick.trace import Tracer
    with open(os.path.join(bench, "configs", "rs_k8_m3.json")) as f:
        config = json.load(f)
    osdmap, pid = build(config, cuda_device)
    osdmap.mark_down(7)
    osdmap.mark_out(7)
    osdmap.pg_to_up_bulk(pid)               # warm: tables, rule, events
    tracer = spans.global_tracer()
    tracer.reset()
    with spans.armed():
        _, caught = _sync_warnings(lambda: osdmap.pg_to_up_bulk(pid))
    noted = tracer.totals()["osdmap.pg_to_up_bulk"]["counts"]["host_syncs"]
    assert noted == len(caught), \
        f"noted {noted}, torch {sorted(collections.Counter(caught).items())}"

    reg = ErasureCodePluginRegistry.instance()
    rs = reg.factory("jerasure", {"technique": "reed_sol_van", "k": "8",
                                  "m": "3"}, device=cuda_device)
    shec = reg.factory("shec", {"k": "6", "m": "3", "c": "2"},
                       device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    data = torch.randint(0, 256, (64, 8, 131072), dtype=torch.uint8,
                         device=cuda_device, generator=gen)
    sdata = torch.randint(0, 256, (64, 6, 174784), dtype=torch.uint8,
                          device=cuda_device, generator=gen)
    sfull = torch.cat([sdata, shec.encode_chunks_torch(sdata)], dim=1)
    avail = tuple(c for c in range(9) if c != 2)
    survivors = sfull[:, list(avail)].contiguous()

    def codec():
        rs.encode_chunks_torch(data)
        return shec.decode_chunks_torch(survivors, avail, (2,))

    codec()                                  # warm: tables, plan, index
    torch.cuda.synchronize()
    tracer.reset()
    with spans.armed():
        got, caught = _sync_warnings(codec)
    totals = tracer.totals()
    assert caught == [], f"{caught}"
    assert totals["codec.encode"]["count"] == 1
    assert totals["codec.decode"]["count"] == 1
    assert "host_syncs" not in totals["codec.encode"]["counts"]
    assert "host_syncs" not in totals["codec.decode"]["counts"]
    assert torch.equal(got[:, 0], sdata[:, 2])

    tracer.reset()
    osdmap.pg_to_up_bulk(pid)                # unarmed: not recorded
    with Tracer(cuda_device):
        osdmap.pg_to_up_bulk(pid)
    osdmap.pg_to_up_bulk(pid)
    assert tracer.totals()["osdmap.pg_to_up_bulk"]["count"] == 1
