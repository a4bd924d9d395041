"""Port parity, the GF(2^8) XOR scheduler and the XOR-schedule kernel's
program: ``ceph_tpu_torch.ops.xor_schedule`` against
``ceph_tpu.ops.xor_schedule`` (static tuples, cost models, the numpy
tier), the plain torch schedule (``apply_matrix_xor_torch`` and its
packed form) against the reference's XLA build and its Pallas kernels in
interpret mode, the kernel's instruction buffer
(``gf_kernels.pack_word_program``) run by a numpy interpreter that
mirrors the CUDA kernel, and the engine table's xor row against the
reference's ``select_matrix_engine``.  Exact byte equality throughout
(GF(2^8) math is integer); the kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.ops import xor_schedule as ref_xs
from ceph_tpu.ops.pallas_gf import (apply_matrix_xor_packed,
                                    apply_matrix_xor_pallas,
                                    apply_matrix_xor_xla)
from ceph_tpu.ops.pallas_gf import pack_chunks as ref_pack_chunks
from ceph_tpu.ops.pallas_gf import select_matrix_engine as ref_select
from ceph_tpu.ops.pallas_gf import unpack_chunks as ref_unpack_chunks
from ceph_tpu_torch.ops import fallback, gf_kernels, regionops, xor_schedule
from ceph_tpu_torch.ops.gf_kernels import (
    apply_matrix_best, apply_matrix_packed_best, apply_matrix_xor_cuda,
    apply_matrix_xor_cuda_packed, pack_chunks, pack_word_program,
    select_matrix_engine, unpack_chunks, xor_program_fits,
    xor_schedule_op_count)
from ceph_tpu_torch.ops.torch_ops import apply_matrix_xor_torch, \
    matrix_to_static

CUDA = torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_code(plugin, profile):
    return RefRegistry.instance().factory(plugin, dict(profile))


def _plugin_matrices():
    """The r6 k=8 m=2 encode matrix, every plan matrix of shec k=4 m=3 c=2
    (1- to 3-erasure patterns) and every composite of lrc k=4 m=2 l=3
    (its encode, 1- and 2-erasure patterns), from the reference codes."""
    mats = [matrix_to_static(_ref_code("jerasure", {
        "technique": "reed_sol_r6_op", "k": "8", "m": "2"}).matrix)]
    shec = _ref_code("shec", {"k": "4", "m": "3", "c": "2"})
    n = shec.get_chunk_count()
    for e in range(1, 4):
        for erased in itertools.combinations(range(n), e):
            avail = frozenset(range(n)) - set(erased)
            try:
                plan = shec.tcache.get_plan(shec.matrix, shec.k, shec.w,
                                            avail, frozenset(erased))
            except IOError:
                continue
            mats.append(shec._plan_static(plan)[1])
    lrc = _ref_code("lrc", {"k": "4", "m": "2", "l": "3"})
    n = lrc.get_chunk_count()
    mats.append(lrc._encode_static())
    for e in range(1, 3):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            mats.append(lrc._decode_composite(avail, erased)[1])
    return mats


def _random_matrices(n_random=120, seed=4321):
    """Seeded random families: dense, sparse, monomial (the ring
    transform), binary, shingled windows and near-duplicate rows."""
    rng = np.random.default_rng(seed)
    kinds = ("dense", "sparse", "monomial", "binary", "window", "duprows")
    out = []
    for i in range(n_random):
        r = int(rng.integers(1, 6))
        s = int(rng.integers(1, 11))
        kind = kinds[i % len(kinds)]
        if kind == "dense":
            m = rng.integers(0, 256, (r, s))
        elif kind == "sparse":
            m = rng.integers(0, 256, (r, s)) * (rng.random((r, s)) < 0.3)
        elif kind == "monomial":
            m = (1 << rng.integers(0, 8, (r, s))) * (rng.random((r, s)) < 0.7)
        elif kind == "binary":
            m = rng.integers(0, 2, (r, s))
        elif kind == "window":
            m = np.zeros((r, s), dtype=np.int64)
            for ri in range(r):
                start = int(rng.integers(0, s))
                for t in range(int(rng.integers(1, s + 1))):
                    m[ri, (start + t) % s] = int(rng.integers(1, 256))
        else:
            base = rng.integers(0, 256, s)
            m = np.stack([base ^ rng.integers(0, 2, s) for _ in range(r)])
        out.append(matrix_to_static(m))
    return out


FIXED = [
    matrix_to_static(np.eye(4, dtype=np.int64)),          # identity
    matrix_to_static(np.zeros((2, 3), dtype=np.int64)),   # all-zero
    ((7,),),                                              # 1x1
    matrix_to_static(np.ones((3, 7), dtype=np.int64)),    # parity rows
    ((1, 1, 1, 1, 1, 1, 1), (1, 2, 4, 8, 16, 32, 64)),    # ring
    ((0, 0, 0), (1, 0, 2), (0, 0, 0)),                    # zero rows
    ((255, 255), (255, 255)),                             # max entries
    ((1, 0, 0, 0), (1, 0, 0, 0)),                         # duplicate rows
]
MATRICES = FIXED + _random_matrices() + _plugin_matrices()


def test_corpus_covers_the_cases():
    assert len(MATRICES) >= 100 + len(FIXED)
    kinds = {xor_schedule.build_schedule(ms).transform for ms in MATRICES}
    assert kinds == {"cse", "ring"}


def test_schedules_equal_the_reference():
    """build_schedule, probe_schedule and preferred_schedule give the
    reference's static tuples and cost models for every matrix."""
    for ms in MATRICES:
        mine, theirs = xor_schedule.build_schedule(ms), \
            ref_xs.build_schedule(ms)
        assert mine.static == theirs.static, ms
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), ms
        probed = xor_schedule.probe_schedule(ms, 8)
        assert (probed is None) == (ref_xs.probe_schedule(ms, 8) is None)
        assert probed is None or probed.static == mine.static
        for mxu in (None, 2048):
            a = xor_schedule.preferred_schedule(ms, 8, mxu_min=mxu)
            b = ref_xs.preferred_schedule(ms, 8, mxu_min=mxu)
            assert (a is None) == (b is None), ms
            assert a is None or a.static == b.static
        assert xor_schedule.naive_bitmatrix_xors(ms) == \
            ref_xs.naive_bitmatrix_xors(ms)
        assert xor_schedule.dense_vpu_cost(ms) == ref_xs.dense_vpu_cost(ms)
    # the tuned seams of the reference default to the port's constants
    assert ref_xs.tuned_cse_topk() == xor_schedule.CSE_TOPK
    assert ref_xs.tuned_xor_cutover() == xor_schedule.XOR_DENSE_CUTOVER
    assert xor_schedule.DEFAULT_MAX_ONES == ref_xs.DEFAULT_MAX_ONES


def test_r6_encode_takes_the_ring_schedule():
    r6 = MATRICES[len(FIXED) + 120]
    assert r6 == ((1,) * 8, tuple(1 << j for j in range(8)))
    sched = xor_schedule.preferred_schedule(r6, 8, mxu_min=2048)
    assert sched.transform == "ring"
    assert (sched.n_ops, sched.xor_ops, sched.plane_ops, sched.vpu_ops,
            sched.dense_vpu_ops) == (53, 30, 23, 76, 156)


def test_degenerate_schedules():
    """Identity rows are zero-op copies, zero rows are -1 outputs, a 1x1
    matrix schedules; all equal to the reference and run exactly."""
    eye = matrix_to_static(np.eye(3, dtype=np.int64))
    zero = matrix_to_static(np.zeros((2, 2), dtype=np.int64))
    ident, zeros, single = (xor_schedule.build_schedule(ms)
                            for ms in (eye, zero, ((7,),)))
    assert ident.vpu_ops == 0 and ident.static[4] == (0, 1, 2)
    assert zeros.static[4] == (-1, -1)
    data = np.random.default_rng(0).integers(0, 256, (1, 3, 256),
                                             dtype=np.uint8)
    for ms, sched, x in ((eye, ident, data), (zero, zeros, data[:, :2]),
                         (((7,),), single, data[:, :1])):
        assert sched.static == ref_xs.build_schedule(ms).static
        got = apply_matrix_xor_torch(_t(x), sched.static).numpy()
        assert np.array_equal(got, ref_regionops.matrix_encode(
            x, np.array(ms, dtype=np.int64), 8))
    assert not apply_matrix_xor_torch(_t(data[:, :2]), zeros.static).any()
    with pytest.raises(ValueError):
        xor_schedule.build_schedule(((1,),), w=16)
    with pytest.raises(ValueError):
        xor_schedule.build_schedule(())
    assert xor_schedule.probe_schedule(((0, 0),), 8) is None
    assert xor_schedule.probe_schedule(((1, 0),), 16) is None


def test_plain_version_matches_xla_pallas_and_numpy():
    """apply_matrix_xor_torch and its packed form equal the reference's
    XLA build on every tenth matrix and its Pallas kernels (interpret
    mode, bytes and packed) on every forty-sixth; the numpy tier and
    host_matrix_apply equal the reference's on all."""
    rng = np.random.default_rng(99)
    for i, ms in enumerate(MATRICES):
        sched = xor_schedule.build_schedule(ms)
        s = len(ms[0])
        data = rng.integers(0, 256, (2, s, 512), dtype=np.uint8)
        want = ref_regionops.matrix_encode(data, np.array(ms, np.int64), 8)
        got = apply_matrix_xor_torch(_t(data), sched.static).numpy()
        assert np.array_equal(got, want), (i, sched.transform)
        assert np.array_equal(
            xor_schedule.apply_schedule_numpy(data, sched), want)
        mat = np.array(ms, dtype=np.int64)
        assert np.array_equal(
            xor_schedule.host_matrix_apply(data, mat, ms, 8),
            ref_xs.host_matrix_apply(data, mat, ms, 8))
        packed = apply_matrix_xor_cuda_packed(pack_chunks(_t(data)),
                                              sched.static)
        assert np.array_equal(unpack_chunks(packed).numpy(), want)
        if i % 10 == 0:
            assert np.array_equal(got, np.asarray(apply_matrix_xor_xla(
                jnp.asarray(data), sched.static)))
        if i % 46 == 0:
            assert np.array_equal(got, np.asarray(apply_matrix_xor_pallas(
                jnp.asarray(data), sched.static, True)))
            ref_words = np.asarray(apply_matrix_xor_packed(
                jnp.asarray(ref_pack_chunks(data)), sched.static, True))
            assert np.array_equal(packed.numpy(), ref_words)
            assert np.array_equal(ref_unpack_chunks(ref_words), want)


def test_host_matrix_apply_falls_back_to_regionops():
    """A dense matrix the probe declines, and a chunk size off the word,
    run the regionops ground truth: still the reference's bytes."""
    rng = np.random.default_rng(7)
    dense = rng.integers(100, 256, (3, 7))
    ms = matrix_to_static(dense)
    assert xor_schedule.preferred_schedule(ms, 8) is None
    for c in (1024, 1022):
        data = rng.integers(0, 256, (2, 7, c), dtype=np.uint8)
        for m in (dense, np.ones((3, 7), dtype=np.int64)):
            assert np.array_equal(
                xor_schedule.host_matrix_apply(data, m, None, 8),
                ref_regionops.matrix_encode(data, m, 8))


# -- the kernel's program -----------------------------------------------------

_OPS = {0: "id", 1: "xt", 2: "shl", 3: "shr"}


def _leaf_op(op, sh, v):
    if op == "xt":
        return xor_schedule.xtime_words_xor(v)
    if op == "shl":
        return (v << np.uint32(sh)) & np.uint32(xor_schedule._LMASK[sh])
    if op == "shr":
        return (v >> np.uint32(sh)) & np.uint32(xor_schedule._RMASK[sh])
    return v


def _run_kernel_data(static, inputs, n_out):
    """Interpret the uint32 buffer the CUDA kernel reads, word for word
    as gf8_xor_kernel does: per instruction a header (groups, dst, row,
    0) and 4 leaf codes per group (bits 0-19 index, 20-22 shift, 24-25
    op, bit 28 read input chunk ``index`` from memory; 0xFFFFFFFF reads
    zero), XORed in a register, kept in slot dst, stored to output row
    ``row`` (0xFFFFFFFF: neither)."""
    n_slots, n_instr, data = pack_word_program(static)
    assert len(data) % 4 == 0
    slots = [None] * n_slots
    outs = [None] * n_out
    q = 0
    for _ in range(n_instr):
        groups, dst, row, _ = (int(v) for v in data[q:q + 4])
        q += 4
        acc = np.zeros_like(inputs[0])
        for code in data[q:q + 4 * groups]:
            code = int(code)
            if code == 0xFFFFFFFF:
                continue
            idx = code & 0xFFFFF
            v = inputs[idx] if code & (1 << 28) else slots[idx]
            assert v is not None, "a leaf reads a slot nothing wrote"
            acc = acc ^ _leaf_op(_OPS[(code >> 24) & 3], (code >> 20) & 7, v)
        q += 4 * groups
        if dst != 0xFFFFFFFF:
            slots[dst] = acc
        if row != 0xFFFFFFFF:
            outs[row] = acc
    assert q + 4 == len(data)                      # the pad word
    assert all(o is not None for o in outs)
    return outs, n_slots


def test_word_program_runs_the_schedule():
    """The kernel's instruction buffer computes what eval_schedule
    computes, for every matrix; inputs are read from memory, and the
    slots never outnumber the schedule's nodes."""
    rng = np.random.default_rng(5)
    for ms in MATRICES:
        sched = xor_schedule.build_schedule(ms)
        ins = [rng.integers(0, 1 << 32, 16, dtype=np.uint32)
               for _ in range(sched.n_in)]
        want = xor_schedule.eval_schedule(
            sched.static, ins, lambda: np.zeros(16, np.uint32))
        got, n_slots = _run_kernel_data(sched.static, ins, sched.n_out)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), ms
        assert n_slots <= sched.n_ops
        _, instrs = xor_schedule.word_program(sched.static)
        for leaves, dst, _ in instrs:
            assert dst is None or dst < n_slots
            for mem, idx, _, _ in leaves:
                assert idx < (sched.n_in if mem else n_slots)


def test_word_program_of_the_main_schedules():
    """lrc's local repair reads its three inputs straight from memory
    into one instruction; the r6 encode keeps its 2 overflow nodes and
    folds every shifted plane into the leaf that reads it."""
    lrc = ("xorsched", 7, 1, (("xor", 0, 1), ("xor", 7, 2)), (8,))
    assert xor_schedule.word_program(lrc) == (
        0, ((((True, 0, "id", 0), (True, 1, "id", 0),
              (True, 2, "id", 0)), None, 0),))
    r6 = xor_schedule.preferred_schedule(
        ((1,) * 8, tuple(1 << j for j in range(8))), 8).static
    n_slots, instrs = xor_schedule.word_program(r6)
    assert n_slots == 2
    assert [len(lv) for lv, _, _ in instrs] == [8, 7, 3, 16]
    assert [(dst, row) for _, dst, row in instrs] == [
        (None, 0), (0, None), (1, None), (None, 1)]
    assert instrs[1][0][0] == (True, 1, "shr", 7)
    assert xor_schedule_op_count(lrc) == 1
    assert xor_schedule_op_count(r6) == 4 + (3 + 14) + (1 + 6) + (8 + 26)


def test_word_program_copies_zero_rows_and_reuse():
    # out0 = 0, out1 = in1 (a copy), out2 = xt(in0 ^ in1), out3 = out2
    # again, out4 = shl(in2, 3): the xor node is read by an xt, so it is
    # made; the xt node is an output twice, so it is kept for the copy
    static = ("xorsched", 3, 5, (("xor", 0, 1), ("xt", 3), ("shl", 2, 3)),
              (-1, 1, 4, 4, 5))
    ins = [np.array([v], np.uint32) for v in (0x01020304, 0x80808080, 0xFF)]
    want = xor_schedule.eval_schedule(static, ins,
                                      lambda: np.zeros(1, np.uint32))
    got, n_slots = _run_kernel_data(static, ins, 5)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert n_slots == 1                            # node 4 reuses node 3's
    assert xor_schedule.word_program(static)[1] == (
        ((), None, 0),                                       # the zero row
        (((True, 1, "id", 0),), None, 1),                    # copy of in1
        (((True, 0, "id", 0), (True, 1, "id", 0)), 0, None),  # node 3
        (((False, 0, "xt", 0),), 0, 2),                      # node 4, kept
        (((False, 0, "id", 0),), None, 3),                   # its copy
        (((True, 2, "shl", 3),), None, 4))                   # node 5
    with pytest.raises(ValueError):
        xor_schedule.word_program(("xorsched", 1, 1, (("mul", 0),), (1,)))


def test_xor_op_count_charges_xtime_and_shifts():
    static = ("xorsched", 2, 1, (("xt", 0), ("shr", 1, 2), ("xor", 2, 3)),
              (4,))
    # one instruction of 2 leaves (1 LOP3), an xt (4) and a shift (2)
    assert xor_schedule_op_count(static) == 1 + 4 + 2
    assert gf_kernels.SM90_XT_COST[8] == 4


# -- routing ------------------------------------------------------------------

def _patterns(n, most):
    for e in range(1, most + 1):
        yield from itertools.combinations(range(n), e)


def _routing_matrices():
    mats = list(MATRICES)
    for plugin, prof in (
            ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
            ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}),
            ("jerasure", {"technique": "reed_sol_r6_op", "k": "8",
                          "m": "2"})):
        ec = _ref_code(plugin, prof)
        n = ec.k + ec.m
        mats.append(matrix_to_static(ec.matrix))
        for erased in _patterns(n, ec.m):
            avail = tuple(i for i in range(n) if i not in erased)
            mats.append(ec._decode_matrix(avail, erased)[1])
    return mats


def test_routing_matches_the_reference():
    """On a CUDA device the port's table picks the XOR-schedule kernel
    exactly where the reference's returns "xor" and the dense kernel
    where it returns "pallas", in both layouts, for every matrix above
    and every decode pattern of jerasure reed_sol_van k=8 m=3, isa k=8
    m=3 and reed_sol_r6_op k=8 m=2."""
    tally = {}
    for ms in _routing_matrices():
        s = len(ms[0])
        for packed, shape in ((False, (4, s, 4096)), (False, (4, s, 4094)),
                              (True, (4, s, 8, 128))):
            theirs = ref_select(shape, ms, 8, packed=packed,
                                engine="pallas", mesh=0)
            mine = select_matrix_engine(8, CUDA, shape=shape, matrix_t=ms,
                                        packed=packed)
            # "xla": the reference's dense path for shapes its Pallas
            # tiling declines; the port's dense kernel takes any C
            assert mine == {"xor": "xor", "pallas": "cuda",
                            "xla": "cuda"}[theirs], (ms, shape)
            tally[theirs] = tally.get(theirs, 0) + 1
            cpu = select_matrix_engine(8, torch.device("cpu"), shape=shape,
                                       matrix_t=ms, packed=packed)
            assert cpu == ("xor" if theirs == "xor" else "torch")
    assert tally["xor"] > 100 and tally["pallas"] > 400


def test_main_path_keeps_the_dense_kernel():
    """jerasure reed_sol_van k=8 m=3 routes its encode and all 231
    decode patterns to the dense kernel; reed_sol_r6_op k=8 m=2 its
    encode and the (9,) and (8, 9) decodes to the XOR kernel."""
    for prof, want in (
            ({"technique": "reed_sol_van", "k": "8", "m": "3"}, []),
            ({"technique": "reed_sol_r6_op", "k": "8", "m": "2"},
             ["encode", (9,), (8, 9)])):
        ec = _ref_code("jerasure", prof)
        n = ec.k + ec.m
        got = []
        for erased in ["encode"] + list(_patterns(n, ec.m)):
            if erased == "encode":
                ms = matrix_to_static(ec.matrix)
            else:
                avail = tuple(i for i in range(n) if i not in erased)
                ms = ec._decode_matrix(avail, erased)[1]
            eng = select_matrix_engine(8, CUDA, shape=(64, ec.k, 131072),
                                       matrix_t=ms)
            if eng == "xor":
                got.append(erased)
        assert got == want


def test_capacity_rule_routes_to_the_dense_kernel(monkeypatch):
    """A schedule whose program and slots exceed the kernel's shared
    memory takes the dense kernel (stated beside DEFAULT_MAX_ONES in
    select_matrix_engine); the plain tiers stay byte-identical."""
    ones = matrix_to_static(np.ones((3, 7), dtype=np.int64))
    sched = xor_schedule.preferred_schedule(ones, 8, mxu_min=2048)
    assert sched is not None and xor_program_fits(sched.static)
    shape = (2, 7, 2048)
    assert select_matrix_engine(8, CUDA, shape=shape, matrix_t=ones) == "xor"
    _, _, data = pack_word_program(sched.static)
    monkeypatch.setattr(gf_kernels, "XOR_SMEM_BUDGET", 4 * data.size)
    assert not xor_program_fits(sched.static)
    assert select_matrix_engine(8, CUDA, shape=shape, matrix_t=ones) == \
        "cuda"
    x = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(apply_matrix_best(_t(x), ones, 8).numpy(),
                          ref_regionops.matrix_encode(x, np.ones((3, 7)), 8))
    monkeypatch.undo()
    big = _too_many_slots()
    assert xor_schedule.word_program(big)[0] == 800
    assert not xor_program_fits(big)


def _too_many_slots(n=800):
    """800 nodes each read by two chains, all live at once: 800 slots,
    past the kernel's 96 KiB with 32 threads of 4-byte units."""
    def chain(first):
        ops = [("xor", 2, 3)]
        for j in range(4, n + 2):
            ops.append(("xor", first + len(ops) - 1, j))
        return ops

    ops = [("xor", 0, 1)] * n
    first = 2 + n
    ops += chain(first)
    ops += chain(first + n - 1)
    return ("xorsched", 2, 2, tuple(ops), (first + n - 2, first + 2 * n - 3))


def test_dispatch_tiers_are_byte_identical(monkeypatch):
    """A matrix the table schedules, through apply_matrix_best and the
    packed dispatch under every forced tier on CPU tensors."""
    ms = ((1, 1, 1, 1, 1, 1, 1), (1, 2, 4, 8, 16, 32, 64))
    assert xor_schedule.preferred_schedule(ms, 8) is not None
    data = np.random.default_rng(3).integers(0, 256, (2, 7, 1024),
                                             dtype=np.uint8)
    want = ref_regionops.matrix_encode(data, np.array(ms), 8)
    before = dict(gf_kernels.launch_counts())
    for force in fallback.ENGINES:
        monkeypatch.setenv("CEPH_TPU_ENGINE", force)
        prev = fallback.set_global_policy(None)
        try:
            assert np.array_equal(apply_matrix_best(_t(data), ms, 8).numpy(),
                                  want)
            got = apply_matrix_packed_best(pack_chunks(_t(data)), ms)
            assert np.array_equal(unpack_chunks(got).numpy(), want)
            eng = select_matrix_engine(8, torch.device("cpu"),
                                       shape=data.shape, matrix_t=ms)
            assert eng == ("numpy" if force == "numpy" else "xor")
        finally:
            fallback.set_global_policy(prev)
    assert gf_kernels.launch_counts() == before     # CPU tensors launch none


def test_xor_wrappers_on_cpu_take_the_plain_version():
    sched = xor_schedule.build_schedule(((1, 2, 0), (0, 1, 3))).static
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (3, 4, 516), dtype=np.uint8))
    view = x[:, :3]                               # a strided survivor slice
    want = ref_regionops.matrix_encode(view.numpy(),
                                       np.array([[1, 2, 0], [0, 1, 3]]), 8)
    n0 = apply_matrix_xor_cuda.launches
    assert np.array_equal(apply_matrix_xor_cuda(view, sched).numpy(), want)
    assert np.array_equal(apply_matrix_xor_cuda(view[0], sched).numpy(),
                          want[0])
    assert apply_matrix_xor_cuda.launches == n0
    assert {apply_matrix_xor_cuda, apply_matrix_xor_cuda_packed} <= set(
        gf_kernels.WRAPPERS)
    with pytest.raises(ValueError):               # C % 4 != 0
        apply_matrix_xor_cuda(view[..., :514], sched)
    with pytest.raises(ValueError):               # s does not match
        apply_matrix_xor_cuda(x, sched)
    with pytest.raises(ValueError):
        apply_matrix_xor_cuda(view.to(torch.int32), sched)
    with pytest.raises(ValueError):               # not a schedule
        apply_matrix_xor_cuda(view, ((1, 2, 0),))
    with pytest.raises(ValueError):
        apply_matrix_xor_cuda_packed(view, sched)
    packed = pack_chunks(view[..., :512].contiguous())
    assert np.array_equal(
        unpack_chunks(apply_matrix_xor_cuda_packed(packed, sched)).numpy(),
        want[..., :512])
