"""Port parity, the GF(2) packet kernel's program
(``gf_kernels.packet_program``: per row group its loads, then its rows,
each the pairs of leaf offsets, an odd single leaf, a kept slot, an
output store and the loads whose slots fall free) run by a numpy
interpreter that mirrors the kernel's walk (``csrc/gf2_bitmatrix.cu``:
row groups, the persistent walk over units, the next unit's packets
landing as soon as the kernel issues them), against
ceph_tpu's Pallas kernels in interpret mode, its XLA path and its numpy
region ops; the lowering's invariants; the launch plan
(``gf_kernels.packet_plan``: unit, row groups, one wave) and the
launch's data (the program through a device buffer, uploaded once, and
its room in shared memory).  Exact byte equality throughout (GF(2)
math is integer).  The kernel itself is held against its plain version
on the card in tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.ops import xla_ops as ref_xla
from ceph_tpu.ops.pallas_gf import (apply_bitmatrix_pallas,
                                    apply_bitmatrix_xor_pallas,
                                    apply_bitmatrix_xor_xla)
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import gf_kernels as gk
from ceph_tpu_torch.ops import xor_schedule
from ceph_tpu_torch.ops.torch_ops import bitmatrix_to_static
from ceph_tpu_torch.telemetry import metrics as tel

# an H100 SXM's limits as the plan reads them (gf2_device_limits): SMs,
# shared memory per SM, the per-block reserve, the most a block takes
H100 = (132, 233472, 1024, 232448)
CAUCHY = {"technique": "cauchy_good", "k": "8", "m": "3"}
# (unit, row groups) the interpreter cycles through
CONFIGS = [(u, g) for g in (1, 2, 4, 8) for u in (16, 8, 4, 1)]


def parse_group(prog, g):
    """(loads, rows) of row group g: loads as (chunk, packet); rows as
    (leaf offsets, keep offset or None, (chunk, packet) or None,
    refilled loads)."""
    words = prog.view(np.uint32)
    at0 = at = int(words[2 + g])
    n_loads, n_rows = int(words[at]), int(words[at + 1])
    at += 2
    loads = [(int(h) & 0xFFFF, int(h) >> 16)
             for h in words[at:at + n_loads]]
    at += n_loads
    rows = []
    handed = 0
    for _ in range(n_rows):
        head_at = at + (2 - (at - at0)) % 4       # leaves on 16 bytes
        assert not words[at:head_at].any()        # padding before it
        head, second = int(words[head_at]), int(words[head_at + 1])
        at = head_at + 2
        n = 2 * (head & gk.PACKET_PAIRS) + bool(head & gk.PACKET_SINGLE)
        assert second >> gk.PACKET_CASE_SHIFT & 7 == (
            2 * ((head & gk.PACKET_PAIRS) % 4) + bool(head & gk.PACKET_SINGLE))
        leaves = [int(x) for x in words[at:at + n]]
        at += n
        keep = second >> 16 if head & gk.PACKET_KEEP else None
        assert keep is not None or second >> 16 == 0
        store = None
        stride = second & gk.PACKET_STRIDE
        if head & gk.PACKET_STORE:
            store = (int(words[at]) & 0xFFFF, int(words[at]) >> 16)
            at += 1
        assert (head_at + stride - at0) % 4 == 2 and head_at + stride >= at
        count = head >> gk.PACKET_REFILL_SHIFT
        rows.append((leaves, keep, store,
                     tuple(range(handed, handed + count))))
        handed += count
    return loads, rows


def run_program(prog, n_slots, x, r, w, packetsize, unit=8, lanes=5,
                poison=0xA5):
    """Run ``prog`` over (b, s, C) uint8 chunks ``x`` -> (b, r, C) the way
    the kernel does with ``lanes`` threads per row group, thread t
    walking units t, t + lanes, ... (all threads of a round at once, as
    the numpy axis 0).  Slots start as ``poison``; the next unit's packet
    lands in a slot when the row that hands it on has run."""
    assert int(prog[0]) == len(prog) and len(prog) % 4 == 0
    b, _, c = x.shape
    nb, units = c // (w * packetsize), packetsize // unit
    total = b * nb * units
    flat_in = x.reshape(-1)
    out = np.full((b, r, c), poison, np.uint8)
    flat_out = out.reshape(-1)
    span = np.arange(unit)
    lane = np.arange(lanes)

    def where(v):
        """(stripe, byte offset in its chunk 0) of units v."""
        rest = v // units
        return rest // nb, (rest % nb) * w * packetsize + (v % units) * unit

    for g in range(int(prog[1])):
        loads, rows = parse_group(prog, g)
        slots = np.full((lanes, n_slots | 1, unit), poison, np.uint8)

        def fetch(v, ks):
            live = v < total
            bb, off = where(v[live])
            for k in ks:
                j, lb = loads[k]
                at = (bb * x.shape[1] + j) * c + off + lb * packetsize
                slots[live, k] = flat_in[at[:, None] + span]

        fetch(lane, range(len(loads)))
        for first in range(0, total, lanes):
            v = first + lane
            live = v < total
            bb, off = where(v[live])
            for leaves, keep, store, refills in rows:
                assert all(o % 16 == 0 for o in leaves)
                acc = np.zeros((lanes, unit), np.uint8)
                for o in leaves:
                    acc ^= slots[:, o // 16]
                if keep is not None:
                    slots[:, keep // 16] = acc
                if store is not None:
                    ch, pk = store
                    at = (bb * r + ch) * c + off + pk * packetsize
                    flat_out[at[:, None] + span] = acc[live]
                fetch(v + lanes, refills)
    return out


def symbolic(prog, n_slots, w):
    """Walk each row group with slots holding the XOR of input packets
    as bit masks: {output (chunk, packet): (mask, group)}.  Fails on a
    leaf of a slot nothing wrote, an output stored twice, a load never
    handed on, and a slot read or written after its load was handed to
    the next unit."""
    stored = {}
    for g in range(int(prog[1])):
        loads, rows = parse_group(prog, g)
        slots = [None] * (n_slots | 1)
        for k, (j, lb) in enumerate(loads):
            slots[k] = 1 << (j * w + lb)
        handed = []
        for leaves, keep, store, refills in rows:
            acc = 0
            for o in leaves:
                assert isinstance(slots[o // 16], int), (g, o)
                acc ^= slots[o // 16]
            if keep is not None:
                assert slots[keep // 16] != "next", (g, keep)
                slots[keep // 16] = acc
            if store is not None:
                assert store not in stored, store
                stored[store] = (acc, g)
            for k in refills:
                slots[k] = "next"
            handed += refills
        assert sorted(handed) == list(range(len(loads)))
    return stored


def _codes():
    ours = ErasureCodePluginRegistry.instance().factory(
        "jerasure", dict(CAUCHY), device="cpu")
    ref = RefRegistry.instance().factory("jerasure", dict(CAUCHY))
    return ours, ref


def _decode(ours, erased):
    """(kind, key, avail) of a cauchy_good decode: the schedule when one
    pays, else the plain rows."""
    avail = tuple(i for i in range(11) if i not in erased)
    _, rows, _, sched = ours._decode_bitmatrix(avail, erased)
    if sched is None:
        return "plain", tuple(rows), avail
    return "schedule", sched.static, avail


def _masks(kind, key, n_in):
    """The input mask of each output packet the program must store."""
    if kind == "plain":
        return [int(m) for m in key]
    _, n, _, ops, outputs = key
    node = [1 << c for c in range(n)]
    for _, a, b in ops:
        node.append(node[a] ^ node[b])
    return [0 if o < 0 else node[o] for o in outputs]


# -- the interpreter against the reference ------------------------------------

@pytest.mark.parametrize("kind", ["plain", "schedule"])
@pytest.mark.parametrize("config", [(16, 1), (8, 3), (4, 8), (1, 2)])
def test_packet_program_cauchy_encode_matches_pallas(kind, config):
    """The cauchy_good k=8 m=3 encode, plain and scheduled, at packetsize
    512 (the reference's Pallas gate), against its Pallas kernels in
    interpret mode and the region ops."""
    ours, ref = _codes()
    unit, groups = config
    key = ours._bitmatrix_static if kind == "plain" \
        else ours._encode_sched.static
    ps = 512
    data = np.random.default_rng(groups).integers(
        0, 256, (2, 8, 2 * 8 * ps), dtype=np.uint8)
    n, prog = gk.packet_program(kind, key, 64, 8, groups)
    got = run_program(prog, n, data, 3, 8, ps, unit, lanes=7)
    want = ref_regionops.bitmatrix_encode(data, ref.bitmatrix, 8, ps)
    assert np.array_equal(got, want)
    if kind == "plain":
        pal = apply_bitmatrix_pallas(data, key, 8, ps, True)
    else:
        pal = apply_bitmatrix_xor_pallas(jnp.asarray(data), key, 8, ps,
                                         True)
    assert np.array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("e", [1, 2, 3])
def test_packet_program_every_cauchy_decode(e):
    """Every 1-, 2- and 3-erasure decode program of cauchy_good k=8 m=3
    (9 plain, 222 scheduled) recovers the erased chunks at packetsize 32,
    each under one of CONFIGS in turn, and passes the symbolic walk."""
    ours, ref = _codes()
    ps = 32
    data = np.random.default_rng(e).integers(0, 256, (2, 8, 2 * 8 * ps),
                                             dtype=np.uint8)
    full = np.concatenate([data, ref_regionops.bitmatrix_encode(
        data, ref.bitmatrix, 8, ps)], axis=1)
    for i, erased in enumerate(itertools.combinations(range(11), e)):
        kind, key, avail = _decode(ours, erased)
        unit, groups = CONFIGS[i % len(CONFIGS)]
        groups = min(groups, 8 * e)
        n, prog = gk.packet_program(kind, key, 64, 8, groups)
        got = run_program(prog, n, full[:, list(avail[:8])], e, 8, ps, unit,
                          lanes=3)
        assert np.array_equal(got, full[:, list(erased)]), erased
        stored = symbolic(prog, n, 8)
        masks = _masks(kind, key, 64)
        assert {o: m for o, (m, _) in stored.items()} == {
            divmod(o, 8): m for o, m in enumerate(masks)}, erased


def _random_bitmatrix(rng, r, s, w):
    bm = (rng.random((r * w, s * w)) < 0.4).astype(np.uint8)
    bm[0] = 0                           # an all-zero output packet
    bm[1, :] = 0
    bm[1, 3] = 1                        # a copy of one input packet
    return bm


@pytest.mark.parametrize("w", [6, 7, 8])
@pytest.mark.parametrize("ps", [8, 32, 512])
def test_packet_program_random_bitmatrices(w, ps):
    """Random (2w, 5w) bitmatrices with a zero row and a copy row, plain
    and through their schedule, against the reference's XLA path (and
    its Pallas kernels in interpret mode at packetsize 512)."""
    rng = np.random.default_rng(w * 100 + ps)
    s, r = 5, 2
    bm = _random_bitmatrix(rng, r, s, w)
    rows = bitmatrix_to_static(bm)
    data = rng.integers(0, 256, (2, s, 2 * w * ps), dtype=np.uint8)
    want = np.asarray(ref_xla.apply_bitmatrix_xla(jnp.asarray(data), rows,
                                                  w, ps))
    assert np.array_equal(want, ref_regionops.bitmatrix_encode(data, bm, w,
                                                               ps))
    cases = [("plain", rows)]
    sched = xor_schedule.probe_bitmatrix_schedule(rows, w)
    if sched is not None:
        cases.append(("schedule", sched.static))
        assert np.array_equal(want, np.asarray(apply_bitmatrix_xor_xla(
            jnp.asarray(data), sched.static, w, ps)))
    if ps % 512 == 0:
        assert np.array_equal(want, np.asarray(apply_bitmatrix_pallas(
            data, rows, w, ps, True)))
    for i, (kind, key) in enumerate(cases):
        for unit, groups in CONFIGS[i::3]:
            if ps % unit or groups > r * w:
                continue
            n, prog = gk.packet_program(kind, key, s * w, w, groups)
            got = run_program(prog, n, data, r, w, ps, unit, lanes=4)
            assert np.array_equal(got, want), (kind, unit, groups)


# -- the lowering's invariants ------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
def test_packet_lowering_invariants(groups):
    """On the cauchy_good encode (plain and scheduled) and a sample of
    decodes: each output is stored once, in exactly one group, the group
    of ``packet_groups``; a group's rows make every node its outputs read
    (the symbolic walk reads no empty slot) and store the right masks;
    each load is handed on exactly once, after the last row that touches
    its slot; a row keeps a result only when a later row reads it."""
    ours, _ = _codes()
    cases = [("plain", ours._bitmatrix_static),
             ("schedule", ours._encode_sched.static)]
    for erased in ((3,), (3, 9), (0, 10), (5, 6, 7), (8, 9, 10)):
        cases.append(_decode(ours, erased)[:2])
    for kind, key in cases:
        rw = len(key) if kind == "plain" else key[2]
        g = min(groups, rw)
        n, prog = gk.packet_program(kind, key, 64, 8, g)
        stored = symbolic(prog, n, 8)
        spans = gk.packet_groups(rw, g)
        assert len(stored) == rw
        for o, m in enumerate(_masks(kind, key, 64)):
            mask, grp = stored[divmod(o, 8)]
            assert mask == m and o in spans[grp]
        for gi in range(g):
            _, rows = parse_group(prog, gi)
            reads = [set(o // 16 for o in lv) for lv, _, _, _ in rows]
            for i, (_, keep, _, _) in enumerate(rows):
                if keep is not None:
                    later = next(j for j in range(i + 1, len(rows))
                                 if keep // 16 in reads[j])
                    writes = [rows[j][1] for j in range(i + 1, later)]
                    assert keep not in writes


def test_row_groups_make_only_their_closure():
    """One output's group makes just the nodes under it: fewer rows than
    the whole schedule's, and a temp two groups need is made in both."""
    static = ("xorsched", 4, 2, (("xor", 0, 1), ("xor", 4, 2),
                                 ("xor", 4, 3)), (5, 6))
    whole = xor_schedule.row_program(static, 1)
    assert len(whole.rows) == 3          # the shared temp once, two outputs
    first = xor_schedule.row_program(static, 1, (0,))
    second = xor_schedule.row_program(static, 1, (1,))
    assert first.loads == (0, 1, 2) and second.loads == (0, 1, 3)
    for prog in (first, second):         # the temp folds into its reader
        (leaves, dst, store, refills), = prog.rows
        assert len(leaves) == 3 and dst is None and store is not None
        assert sorted(refills) == [0, 1, 2]


# -- the plan and the launch's data -------------------------------------------

def _plan(kind, key, batch, c=131072, ps=2048, widest=16, w=8, n_in=64):
    rw = len(key) if kind == "plain" else key[2]
    return gk.packet_plan(batch, c, w, ps, widest, rw,
                          gk.packet_slots(kind, key, n_in, w), H100)


def test_packet_plan_one_group_at_64_stripes_a_wave_at_4():
    """At 64 stripes of 128 KiB every cauchy_good product takes one row
    group; at 4 the plan takes the fewest groups whose units fill one
    wave of an H100 (or all it may), and its grid is that wave."""
    ours, _ = _codes()
    cases = [("plain", ours._bitmatrix_static),
             ("schedule", ours._encode_sched.static)]
    cases += [_decode(ours, e)[:2] for e in ((3,), (3, 9), (5, 6, 7))]
    for kind, key in cases:
        assert _plan(kind, key, 64).groups == 1
        plan = _plan(kind, key, 4)
        rw = len(key) if kind == "plain" else key[2]
        units = 4 * 8 * (2048 // plan.unit)
        n, extra = gk.packet_slots(kind, key, 64, 8)(plan.groups)
        _, resident = gk._packet_block(n, plan.unit, extra, H100)
        assert plan.groups > 1
        assert units * plan.groups >= resident * H100[0] or \
            plan.groups == max(g for g in gk.PACKET_GROUPS if g <= rw)
        smaller = [g for g in gk.PACKET_GROUPS if g < plan.groups]
        for g in smaller:
            n_g, x_g = gk.packet_slots(kind, key, 64, 8)(g)
            assert units * g < gk._packet_block(
                n_g, plan.unit, x_g, H100)[1] * H100[0]
        assert plan.blocks * plan.groups <= resident // plan.threads * H100[0]


def test_packet_plan_units_stages_and_blocks():
    """The unit is the widest the pointers, strides and packet size allow
    whose slots leave PACKET_MIN_WARPS warps per SM; single bytes only
    where nothing wider divides; the block fits the card's shared
    memory, the program's stream beside the slots."""
    ours, _ = _codes()
    for kind, key in (("plain", ours._bitmatrix_static),
                      ("schedule", ours._encode_sched.static)):
        plan = _plan(kind, key, 64)
        n, x = gk.packet_slots(kind, key, 64, 8)(1)
        words, load_words = gk.packet_stream_room(
            gk.packet_program(kind, key, 64, 8, 1)[1])
        assert plan.pitch == n | 1 and x == 4 * (words + load_words) > 0
        assert x + plan.threads * plan.pitch * plan.unit <= H100[3]
        assert gk._packet_block(n, plan.unit, x, H100)[1] >= \
            32 * gk.PACKET_MIN_WARPS
        for u in gk.PACKET_UNITS:
            if u > plan.unit:
                assert gk._packet_block(n, u, x, H100)[1] < \
                    32 * gk.PACKET_MIN_WARPS
        assert _plan(kind, key, 64, widest=4).unit <= 4
        assert _plan(kind, key, 64, ps=2052, c=64 * 2052, widest=4).unit \
            == 4
        assert _plan(kind, key, 64, ps=2051, c=64 * 2051, widest=1).unit \
            == 1


class _FakeLib:
    """Stands in for the built gf2_bitmatrix library: records each
    launch's arguments and accepts it."""

    def __init__(self):
        self.calls = []

    def gf2_packet_apply(self, *args):
        self.calls.append(args)
        return 0

    def gf2_error_string(self, err):
        return b"fake"


@pytest.mark.parametrize("erased,groups", [((3, 9), 1), ((5, 6, 7), 1),
                                           ((5, 6, 7), 8)])
def test_programs_go_through_a_device_buffer_made_once(monkeypatch, erased,
                                                       groups):
    """The launch hands the kernel the program twice, in host memory (for
    its checks) and as a device buffer made once per (matrix, row
    groups), with its room in shared memory (``packet_stream_room``:
    the longest stream, and the most loads' offsets, in whole 16-byte
    words); one launch, one kernel setup, and none on a warm repeat.  The
    kernel library is a fake here."""
    fake = _FakeLib()
    monkeypatch.setattr(gk, "_bitlib", lambda: fake)
    monkeypatch.setattr(gk, "device_and_stream", lambda x: (0, 0))
    gk._packet_data.cache_clear()
    ours, _ = _codes()
    kind, key, _ = _decode(ours, erased)
    n, prog = gk.packet_program(kind, key, 64, 8, groups)
    x = torch.zeros((2, 8, 8 * 2048), dtype=torch.uint8)
    r = len(erased)
    words, load_words = gk.packet_stream_room(prog)
    plan = gk._packet_grid(2 * 256, 8, groups, n,
                           4 * (words + load_words), H100)
    before = tel.kernel_setups()
    for _ in range(2):
        out = gk._packet_launch(x, r, 8, 2048, kind, key, 64, plan=plan)
        assert out.shape == (2, r, 8 * 2048)
    assert tel.kernel_setups() == before + 1
    first, second = fake.calls
    assert first[2:] == second[2:]        # all but the buffers
    assert first[10:12] == (prog.ctypes.data, prog.size)
    table = gk._packet_data(kind, key, 64, 8, groups, torch.device("cpu"))[1]
    assert first[12] == table.data_ptr()
    assert np.array_equal(table.numpy(), prog)
    assert first[13:19] == (words, load_words, 8, plan.threads, plan.blocks,
                            plan.pitch)
    starts = [int(prog[2 + g]) for g in range(groups)]
    ends = starts[1:] + [int(prog[0])]
    assert words % 4 == 0 and load_words % 4 == 0
    assert words - 4 < max(e - b for b, e in zip(starts, ends)) <= words
    assert load_words - 4 < 2 * max(int(prog[b]) for b in starts) \
        <= load_words


def test_packet_program_layout_fields():
    """The stream of a small schedule (w=2), field by field: the loads in
    the order their slots fall free, then per row its head (pairs, flags,
    loads handed on) and second word (stride to the next head, case of
    the rest, kept slot) at 2 and 3 mod 4 words of the stream, so its
    leaves start on 16 bytes, the leaves and the output."""
    # out0 = (in0 ^ in1) ^ in2, out1 = (in0 ^ in1) ^ in3: the temp in0^in1
    # is read twice, so it is kept, in the slot in1 frees
    static = ("xorsched", 4, 2, (("xor", 0, 1), ("xor", 4, 2),
                                 ("xor", 4, 3)), (5, 6))
    n, prog = gk.packet_program("schedule", static, 4, 2, 1)
    keep, store = gk.PACKET_KEEP, gk.PACKET_STORE
    hand = 1 << gk.PACKET_REFILL_SHIFT
    case = gk.PACKET_CASE_SHIFT
    want = [28, 1, 3,                            # length, groups, stream
            4, 3,                                # loads, rows
            0, 1, 1 << 16, 1 | 1 << 16,          # in0, in2, in1, in3
            1 | keep | hand, 4 | 2 << case | 32 << 16,  # the temp, slot 2
            0, 32,
            1 | store | hand, 8 | 2 << case,     # out0: chunk 0, packet 0
            32, 16, 0,
            0, 0, 0,                             # the next leaves on 16 bytes
            1 | store | 2 * hand, 8 | 2 << case,  # out1: packet 1
            32, 48, 1 << 16,
            0, 0]                                # to whole 16-byte words
    assert n == 4 and prog.dtype == np.int32 and len(prog) % 4 == 0
    assert [int(v) for v in prog] == want
    # a zero row, a copy and an odd count: no pairs, a single leaf
    n, prog = gk.packet_program("plain", (0, 0b10, 0b111, 0), 3, 2, 2)
    assert list(prog[1:4]) == [2, 4, 18]
    loads, rows = parse_group(prog, 0)
    assert loads == [(0, 1)]                     # in1 alone, into slot 0
    assert rows == [([], None, (0, 0), ()), ([0], None, (0, 1), (0,))]
    loads, rows = parse_group(prog, 1)
    assert loads == [(0, 0), (0, 1), (1, 0)]
    assert rows == [([0, 16, 32], None, (1, 0), (0, 1, 2)),
                    ([], None, (1, 1), ())]
