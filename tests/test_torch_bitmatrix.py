"""Port parity, bitmatrix ops: the packet-layout plain versions
(``apply_bitmatrix_torch``, ``apply_bitmatrix_xor_torch``), the kernel
wrappers' CPU path, the dispatch and the ported XOR scheduler, against
ceph_tpu's XLA builds, its Pallas kernels in interpret mode and the
numpy ground truth.  Exact byte equality throughout (GF(2) math is
integer).  The packet kernel's rows (``xor_schedule.row_program`` and
``plain_row_program``) are run here by a numpy interpreter that mirrors
the kernel's walk (tests/test_torch_packet.py runs the packed program); the kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.ops import xla_ops as ref_xla
from ceph_tpu.ops import xor_schedule as ref_xs
from ceph_tpu.ops.pallas_gf import (apply_bitmatrix_pallas,
                                    apply_bitmatrix_xor_pallas,
                                    apply_bitmatrix_xor_xla)
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import fallback, gf_kernels, regionops, xor_schedule
from ceph_tpu_torch.ops.gf_kernels import (
    apply_bitmatrix_best, apply_bitmatrix_cuda, apply_bitmatrix_numpy,
    apply_bitmatrix_xor_cuda, bitmatrix_op_count, schedule_op_count)
from ceph_tpu_torch.ops.torch_ops import (apply_bitmatrix_torch,
                                          apply_bitmatrix_xor_torch,
                                          bitmatrix_to_static)

TECHNIQUE_PROFILES = [
    {"technique": "cauchy_good", "k": "8", "m": "3"},
    {"technique": "cauchy_orig", "k": "4", "m": "2"},
    {"technique": "cauchy_good", "k": "6", "m": "2"},
    {"technique": "liberation", "k": "7", "w": "7"},
    {"technique": "blaum_roth", "k": "6", "w": "6"},
    {"technique": "liber8tion", "k": "8"},
]


def _ids(profiles):
    return [f"{p['technique']}-k{p['k']}-w{p.get('w', 'default')}"
            for p in profiles]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(profile):
    ours = ErasureCodePluginRegistry.instance().factory(
        "jerasure", dict(profile), device="cpu")
    ref = RefRegistry.instance().factory("jerasure", dict(profile))
    return ours, ref


def _random_bitmatrix(rng, r, s, w, density=0.4):
    bm = (rng.random((r * w, s * w)) < density).astype(np.uint8)
    bm[0] = 0                           # an all-zero output packet
    bm[1, :] = 0
    bm[1, 3] = 1                        # a copy of one input packet
    return bm


def _interpret_rows(prog, inputs, n_out, w):
    """Run a ``RowProgram`` the way the CUDA kernel does: load k of
    input packet ``prog.loads[k]`` into slot k; each row XORs its leaves,
    keeps the result in slot dst and stores it to packet ``packet`` of
    output chunk ``chunk``; the loads a row refills are handed to the next
    unit, so no later row may read or keep into their slots.  Leaves must
    be slots the loads or an earlier row wrote."""
    slots = [None] * prog.n_slots
    for k, c in enumerate(prog.loads):
        slots[k] = inputs[c]
    outs = [None] * n_out
    for leaves, dst, store, refills in prog.rows:
        acc = np.zeros_like(inputs[0])
        for x in leaves:
            assert slots[x] is not None
            acc = acc ^ slots[x]
        if dst is not None:
            assert dst < prog.n_slots
            slots[dst] = acc
        if store is not None:
            chunk, packet = store
            outs[chunk * w + packet] = acc
        for k in refills:
            slots[k] = None
    assert all(o is not None for o in outs)
    return outs


def _interpret_row_program(static, inputs, w=1):
    prog = xor_schedule.row_program(static, w)
    return _interpret_rows(prog, inputs, static[2], w), prog.n_slots


# -- the plain packet product ------------------------------------------------

@pytest.mark.parametrize("r,s,w,ps,nb,lead", [
    (3, 8, 8, 512, 2, (2,)), (2, 7, 7, 512, 1, (3,)), (2, 6, 6, 512, 2, ()),
    (1, 3, 4, 512, 3, (2,)), (3, 5, 8, 1024, 1, (2, 2))])
def test_bitmatrix_torch_matches_xla_pallas_and_regionops(r, s, w, ps, nb,
                                                          lead):
    rng = np.random.default_rng(r * 1000 + s * 10 + w)
    bm = _random_bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    assert rows == ref_xla.bitmatrix_to_static(bm)
    data = rng.integers(0, 256, lead + (s, nb * w * ps), dtype=np.uint8)
    want = ref_regionops.bitmatrix_encode(data, bm, w, ps)
    assert np.array_equal(want, regionops.bitmatrix_encode(data, bm, w, ps))
    got = apply_bitmatrix_torch(_t(data), rows, w, ps).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(ref_xla.apply_bitmatrix_xla(
        jnp.asarray(data), rows, w, ps)))
    flat = data.reshape((-1,) + data.shape[-2:])
    assert np.array_equal(got.reshape((-1,) + got.shape[-2:]), np.asarray(
        apply_bitmatrix_pallas(flat, rows, w, ps, True)))
    assert np.array_equal(apply_bitmatrix_cuda(_t(data), rows, w, ps)
                          .numpy(), want)


@pytest.mark.parametrize("ps", [8, 32, 12, 3])
def test_bitmatrix_small_packets_and_strided_slice(ps):
    """Packet sizes the TPU's tiling gate declines (the port takes any),
    through a survivor slice whose chunk axis is strided."""
    rng = np.random.default_rng(ps)
    w, s, r = 7, 5, 2
    bm = _random_bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    data = rng.integers(0, 256, (3, s + 2, 4 * w * ps), dtype=np.uint8)
    view = _t(data)[:, :s, :]
    assert not view.is_contiguous()
    want = ref_regionops.bitmatrix_encode(data[:, :s], bm, w, ps)
    assert np.array_equal(np.asarray(ref_xla.apply_bitmatrix_xla(
        jnp.asarray(data[:, :s]), rows, w, ps)), want)
    assert np.array_equal(apply_bitmatrix_torch(view, rows, w, ps).numpy(),
                          want)
    assert np.array_equal(apply_bitmatrix_cuda(view, rows, w, ps).numpy(),
                          want)
    sched = xor_schedule.probe_bitmatrix_schedule(rows, w)
    if sched is not None:
        assert np.array_equal(apply_bitmatrix_xor_cuda(
            view, sched.static, w, ps).numpy(), want)


# -- the scheduled product ---------------------------------------------------

@pytest.mark.parametrize("profile", TECHNIQUE_PROFILES,
                         ids=_ids(TECHNIQUE_PROFILES))
def test_bitmatrix_xor_torch_matches_pallas_and_xla(profile):
    ours, ref = _codes(profile)
    assert np.array_equal(ours.bitmatrix, ref.bitmatrix)
    rows = ours._bitmatrix_static
    sched = xor_schedule.probe_bitmatrix_schedule(rows, ours.w)
    ps = 512
    data = np.random.default_rng(ours.k).integers(
        0, 256, (2, ours.k, 2 * ours.w * ps), dtype=np.uint8)
    want = ref_regionops.bitmatrix_encode(data, ref.bitmatrix, ours.w, ps)
    if sched is None:
        # liberation: no schedule pays, here or in the reference; the
        # dispatch takes the plain product
        assert ref_xs.probe_bitmatrix_schedule(rows, ours.w) is None
        assert np.array_equal(apply_bitmatrix_best(
            _t(data), rows, ours.w, ps, sched).numpy(), want)
        return
    got = apply_bitmatrix_xor_torch(_t(data), sched.static, ours.w, ps)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(apply_bitmatrix_xor_pallas(
        jnp.asarray(data), sched.static, ours.w, ps, True)))
    assert np.array_equal(got.numpy(), np.asarray(apply_bitmatrix_xor_xla(
        jnp.asarray(data), sched.static, ours.w, ps)))
    assert np.array_equal(apply_bitmatrix_xor_cuda(
        _t(data), sched.static, ours.w, ps).numpy(), want)


def _decode_sample(k, n, e_max, count, seed):
    pats = [p for e in range(1, e_max + 1)
            for p in itertools.combinations(range(n), e)]
    idx = np.random.default_rng(seed).choice(len(pats), min(count, len(pats)),
                                             replace=False)
    return [pats[i] for i in sorted(idx)]


@pytest.mark.parametrize("profile", TECHNIQUE_PROFILES,
                         ids=_ids(TECHNIQUE_PROFILES))
def test_schedules_equal_the_reference(profile):
    """The port's schedule of every technique's encode bitmatrix, and of
    a seeded sample of decode bitmatrices, is the reference's static
    tuple: the same matrices take the same kernel."""
    ours, ref = _codes(profile)
    k, n = ours.k, ours.k + ours.m
    mats = [ours.bitmatrix]
    for erased in _decode_sample(k, n, ours.m, 8, k * 31 + ours.w):
        avail = [i for i in range(n) if i not in erased][:k]
        mats.append(regionops.bitmatrix_decode_matrix(
            ours.bitmatrix, k, ours.w, avail, list(erased)))
    for bm in mats:
        rows = bitmatrix_to_static(bm)
        mine = xor_schedule.probe_bitmatrix_schedule(rows, ours.w)
        theirs = ref_xs.probe_bitmatrix_schedule(rows, ours.w)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.static == theirs.static
            assert (mine.xor_ops, mine.naive_xor_ops) == (
                theirs.xor_ops, theirs.naive_xor_ops)


def test_cauchy_good_routing_matches_the_reference_survey():
    """cauchy_good k=8 m=3: the encode is scheduled (247 XORs against
    463 naive); of the 231 1/2/3-erasure patterns, the 9 single erasures
    of chunks 0-8 take the plain product and the rest a schedule."""
    ours, _ = _codes(TECHNIQUE_PROFILES[0])
    enc = ours._encode_sched
    assert (enc.xor_ops, enc.naive_xor_ops) == (247, 463)
    plain = []
    for e in range(1, 4):
        for erased in itertools.combinations(range(11), e):
            avail = tuple(i for i in range(11) if i not in erased)
            if ours._decode_bitmatrix(avail, erased)[3] is None:
                plain.append(erased)
    assert plain == [(i,) for i in range(9)]


@pytest.mark.parametrize("profile", TECHNIQUE_PROFILES,
                         ids=_ids(TECHNIQUE_PROFILES))
def test_row_program_runs_the_schedule(profile):
    """The kernel's rows compute what eval_schedule_u8 computes, in fewer
    slots than nodes, reading fewer leaves than the XORs' operands."""
    ours, _ = _codes(profile)
    rng = np.random.default_rng(5)
    k, n, w = ours.k, ours.k + ours.m, ours.w
    mats = [ours.bitmatrix]
    for erased in _decode_sample(k, n, ours.m, 4, 17):
        avail = [i for i in range(n) if i not in erased][:k]
        mats.append(regionops.bitmatrix_decode_matrix(
            ours.bitmatrix, k, w, avail, list(erased)))
    for bm in mats:
        sched = xor_schedule.probe_bitmatrix_schedule(
            bitmatrix_to_static(bm), w)
        if sched is None:
            continue
        ins = [rng.integers(0, 256, 16, dtype=np.uint8)
               for _ in range(sched.n_in)]
        want = xor_schedule.eval_schedule_u8(
            sched.static, ins, lambda: np.zeros(16, np.uint8))
        got, n_slots = _interpret_row_program(sched.static, ins, w)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        prog = xor_schedule.row_program(sched.static, w)
        assert len(prog.loads) <= n_slots < sched.n_in + sched.n_ops
        assert sum(len(lv) for lv, _, _, _ in prog.rows) < 2 * sched.xor_ops


def test_row_program_zero_rows_copies_and_reuse():
    # out0 = 0, out1 = in1 (a copy), out2 = in0^in1, out3 = out2^in2 and
    # out4 = in0^in1 again; node 3 (in0^in1) is read by node 4 and stored
    # twice, so it is kept; node 4 is only stored
    static = ("xorsched", 3, 5, (("xor", 0, 1), ("xor", 3, 2)),
              (-1, 1, 3, 4, 3))
    ins = [np.array([v], np.uint8) for v in (1, 2, 4)]
    got, n_slots = _interpret_row_program(static, ins)
    assert [int(o[0]) for o in got] == [0, 2, 3, 7, 3]
    assert n_slots == 3                  # node 3 reuses in0's or in1's slot
    prog = xor_schedule.row_program(static, 1)
    assert prog.loads == (0, 1, 2)
    rows = prog.rows
    assert rows[0] == ((), None, (0, 0), ())       # the zero row
    assert rows[1] == ((1,), None, (1, 0), ())     # the copy of in1
    leaves, dst, store, refills = rows[2]          # node 3, kept
    assert leaves == (0, 1) and dst in (0, 1) and store == (2, 0)
    assert refills == tuple({0, 1} - {dst})        # the other slot is free
    assert rows[3] == ((dst,), None, (4, 0), ())   # its second store
    assert rows[4] == ((dst, 2), None, (3, 0), tuple(sorted((dst, 2))))
    with pytest.raises(ValueError):
        xor_schedule.row_program(("xorsched", 1, 1, (("xt", 0),), (1,)), 1)
    # with w=2, output row 3 is packet 1 of chunk 1
    rows = xor_schedule.row_program(static, 2).rows
    assert sorted(st for _, _, st, _ in rows) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1), (2, 0)]


def test_pack_rows_layout_and_plain_rows():
    rows = (((0, 1, 2, 3, 4), None, (0, 1), (0, 1)),
            ((), 5, None, ()), ((2,), None, (1, 0), (2, 3, 4)))
    flat = gf_kernels._pack_group(xor_schedule.RowProgram(6, (0, 1, 2, 3, 4),
                                                          rows), 4)
    keep, store = gf_kernels.PACKET_KEEP, gf_kernels.PACKET_STORE
    hand = 1 << gf_kernels.PACKET_REFILL_SHIFT
    loads = [0, 1 << 16, 2 << 16, 3 << 16, 1]      # chunk | packet << 16
    case = gf_kernels.PACKET_CASE_SHIFT
    want = [5, 3] + loads + [0, 0, 0]              # heads at 2 mod 4
    want += [2 | gf_kernels.PACKET_SINGLE | store | 2 * hand, 8 | 5 << case,
             0, 16, 32, 48, 64, 0 | 1 << 16]
    want += [0 | keep, 4 | 80 << 16]               # no leaves, kept in slot 5
    want += [0, 0, gf_kernels.PACKET_SINGLE | store | 3 * hand, 4 | 1 << case,
             32, 1]
    assert flat == want
    with pytest.raises(ValueError, match="order"):  # loads handed out of order
        gf_kernels._pack_group(xor_schedule.RowProgram(
            3, (0, 1), (((0, 1), None, (0, 0), (1, 0)),)), 4)
    # the plain product's rows run like apply_bitmatrix_torch
    rng = np.random.default_rng(3)
    bm = _random_bitmatrix(rng, 2, 3, 4)
    masks = bitmatrix_to_static(bm)
    prog = xor_schedule.plain_row_program(masks, 12, 4)
    ins = [rng.integers(0, 256, 8, dtype=np.uint8) for _ in range(12)]
    got = _interpret_rows(prog, ins, 8, 4)
    for o, m in enumerate(masks):
        want = np.zeros(8, np.uint8)
        for c in range(12):
            if (m >> c) & 1:
                want ^= ins[c]
        assert np.array_equal(got[o], want)
    assert all(dst is None for _, dst, _, _ in prog.rows)


# -- op counts (the ops side of the kernels' bounds) ----------------------------

def test_bitmatrix_op_counts():
    ours, _ = _codes(TECHNIQUE_PROFILES[0])
    rows = ours._bitmatrix_static
    # each output row's n ones fold in ceil((n - 1) / 2) LOP3s
    assert bitmatrix_op_count(rows) == sum(
        -(-(bin(m).count("1") - 1) // 2) for m in rows) == 239
    assert bitmatrix_op_count((0, 1, 0b11, 0b111)) == 0 + 0 + 1 + 1
    sched = ours._encode_sched
    assert schedule_op_count(sched.static) == 165
    assert schedule_op_count(sched.static) <= sched.xor_ops
    # a schedule without shared temps costs what the plain product costs
    chains = ("xorsched", 4, 2, (("xor", 0, 1), ("xor", 4, 2),
                                 ("xor", 5, 3), ("xor", 1, 2)), (6, 7))
    assert schedule_op_count(chains) == bitmatrix_op_count((0b1111, 0b110))
    # a temp read twice must exist: (a^b) once, then two 2-leaf folds
    shared = ("xorsched", 3, 2, (("xor", 0, 1), ("xor", 3, 2),
                                 ("xor", 3, 2)), (4, 5))
    assert schedule_op_count(shared) == 3


# -- dispatch ------------------------------------------------------------------

def test_bitmatrix_best_routes_and_tiers():
    ours, ref = _codes(TECHNIQUE_PROFILES[1])
    rows, w, ps = ours._bitmatrix_static, ours.w, 32
    data = np.random.default_rng(2).integers(0, 256, (2, 4, 3 * w * ps),
                                             dtype=np.uint8)
    want = ref_regionops.bitmatrix_encode(data, ref.bitmatrix, w, ps)
    sched = xor_schedule.probe_bitmatrix_schedule(rows, w)
    assert sched is not None
    # the probe is cached: the same matrix gives the same schedule object
    assert xor_schedule.probe_bitmatrix_schedule(rows, w) is sched
    for s in (sched, None):
        assert np.array_equal(
            apply_bitmatrix_best(_t(data), rows, w, ps, s).numpy(), want)
    assert np.array_equal(apply_bitmatrix_numpy(_t(data), rows, w, ps)
                          .numpy(), want)
    prev = fallback.set_global_policy(fallback.FallbackPolicy("numpy"))
    try:
        assert np.array_equal(
            apply_bitmatrix_best(_t(data), rows, w, ps, sched).numpy(), want)
        with pytest.raises(ValueError, match="CPU tensors"):
            gf_kernels.select_matrix_engine(w, torch.device("cuda"))
    finally:
        fallback.set_global_policy(prev)
    with pytest.raises(TypeError):                # the schedule is required
        apply_bitmatrix_best(_t(data), rows, w, ps)


def test_bitmatrix_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 8 * 32, dtype=torch.uint8)
    with pytest.raises(ValueError):               # C not a block multiple
        apply_bitmatrix_cuda(x[..., :100], (1,) * 8, 8, 32)
    with pytest.raises(ValueError):               # rows not a multiple of w
        apply_bitmatrix_cuda(x, (1,) * 7, 8, 32)
    with pytest.raises(ValueError):               # a row past s*w columns
        apply_bitmatrix_cuda(x, (1 << 24,) + (1,) * 7, 8, 32)
    with pytest.raises(ValueError):
        apply_bitmatrix_cuda(x.to(torch.int32), (1,) * 8, 8, 32)
    with pytest.raises(ValueError):               # not a schedule
        apply_bitmatrix_xor_cuda(x, (1,) * 8, 8, 32)
    with pytest.raises(ValueError):               # schedule past the input
        apply_bitmatrix_xor_cuda(
            x, ("xorsched", 32, 8, (), (0,) * 8), 8, 32)
