"""Port parity, the dense GF(2^w) kernel's data: its row program
(``gf_kernels.dense_program``) run by a numpy interpreter that mirrors
the kernel's walk (``csrc/gf8_matrix.cu``: row blocks, staged tiles of
the block's nonzero columns, per row and tile a partial Horner over the
set bits of each level, two per three-input XOR), against ceph_tpu's
Pallas kernels in interpret mode and its numpy region ops; and the
integer-work counts behind the kernel's bound (``sm90_row_op_count``,
``sm90_op_floor``, ``program_op_count``).  Exact byte equality
throughout (GF math is integer).  The kernel itself is held against its
plain version on the card in tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from ceph_tpu.ops import regionops as ref_regionops
from ceph_tpu.ops import xla_ops as ref_xla
from ceph_tpu.ops.pallas_gf import apply_matrix_pallas, \
    apply_matrix_pallas_words
from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.ops.gf_kernels import (
    BY_VALUE_MAX_PROG, DENSE_ROWS_MAX, DENSE_TILE_COLS, DENSE_UNITS,
    SM90_XT_COST,
    dense_geometry, dense_program, program_op_count, sm90_op_count,
    sm90_op_floor, sm90_row_op_count)
from ceph_tpu_torch.ops.torch_ops import matrix_to_static

CPU = "cpu"
MASK32 = 0xFFFFFFFF


def _xtime(v: np.ndarray, w: int) -> np.ndarray:
    """The kernel's SWAR xtime on uint32 words: the top bits shifted
    out, the reduction term where an element's top bit was set (the
    sign-replicated mask prmt makes)."""
    if w == 8:
        m = ((v >> 7) & 0x01010101) * 0xFF
        return ((v & 0x7F7F7F7F) << 1) ^ (m & 0x1D1D1D1D)
    if w == 16:
        m = ((v >> 15) & 0x00010001) * 0xFFFF
        return ((v & 0x7FFF7FFF) << 1) ^ (m & 0x100B100B)
    m = (v >> 31) * np.uint32(MASK32)
    return ((v << 1) & np.uint32(MASK32)) ^ (m & 0x00400007)


def interpret(prog: np.ndarray, chunks: np.ndarray, r: int, w: int = 8
              ) -> np.ndarray:
    """Run a row program over (batch, s, C) uint8 chunks the way the
    kernel does and return (batch, r, C) uint8: each row block's tiles
    staged in turn (a tile's columns gathered as the block's threads
    stage them), each row folding a tile's levels from its top bit
    down (xtime, then the level's slots two at a time), XORing the
    tile's partial row into its accumulator.  The words are the chunks'
    little-endian uint32 view, zero padded to whole words."""
    batch, s, c = chunks.shape
    pad = -c % 4
    words = np.concatenate(
        [chunks, np.zeros((batch, s, pad), np.uint8)], axis=2) \
        .view("<u4").astype(np.uint32)
    nrb, per = int(prog[1]), int(prog[2])
    assert (nrb, per) == dense_geometry(r, s)[:2]
    zero = min(s, DENSE_TILE_COLS)          # the zero slot
    stride = DENSE_UNITS * 16               # bytes between 16-byte slots
    out = np.zeros((batch, r, words.shape[2]), np.uint32)
    for rb in range(nrb):
        rows = range(rb * per, min(r, (rb + 1) * per))
        tp = int(prog[3 + rb])
        ntiles = int(prog[tp])
        tp += 1
        rp = {i: int(prog[3 + nrb + i]) for i in rows}
        for _ in range(ntiles):
            ncols = int(prog[tp])
            cols = [int(j) for j in prog[tp + 1:tp + 1 + ncols]]
            assert ncols <= DENSE_TILE_COLS and len(set(cols)) == ncols
            tp += 1 + ncols
            stage = np.zeros((batch, zero + 1, words.shape[2]), np.uint32)
            stage[:, :ncols] = words[:, cols, :]
            for i in rows:
                top = int(prog[rp[i]])
                rp[i] += 1
                t = np.zeros((batch, words.shape[2]), np.uint32)
                for lev in range(top):
                    if lev:
                        t = _xtime(t, w)
                    n = int(prog[rp[i]])
                    offs = [int(o) for o in prog[rp[i] + 1:rp[i] + 1 + 2 * n]]
                    for a, b in zip(offs[0::2], offs[1::2]):
                        assert a % stride == 0 and b % stride == 0
                        assert a // stride < ncols and (
                            b // stride < ncols or b // stride == zero)
                        t ^= stage[:, a // stride] ^ stage[:, b // stride]
                    rp[i] += 1 + 2 * n
                out[:, i] ^= t
    got = out.astype("<u4").view(np.uint8).reshape(batch, r, -1)
    return got[:, :, :c]


def _run(mat, data, w=8):
    ms = matrix_to_static(mat)
    if w == 8:
        return interpret(dense_program(ms, 8), data, len(mat), 8)
    words = data.view(np.uint8)
    got = interpret(dense_program(ms, w), words, len(mat), w)
    return got.view(ref_regionops.words_view(got, w).dtype)


def _pallas(mat, data, rows=48):
    """apply_matrix_pallas in interpret mode, ``rows`` rows of the
    matrix per call, each call on the columns its rows read (a zero
    column adds nothing; the reference's compile time grows faster than
    the coefficients it is given)."""
    mat = np.asarray(mat)
    out = []
    for i in range(0, len(mat), rows):
        part = mat[i:i + rows]
        cols = np.flatnonzero(part.any(axis=0))
        if len(cols) == 0:
            out.append(np.zeros(data.shape[:-2] + (len(part),)
                                + data.shape[-1:], np.uint8))
            continue
        out.append(np.asarray(apply_matrix_pallas(
            jnp.asarray(np.ascontiguousarray(data[..., cols, :])),
            ref_xla.matrix_to_static(part[:, cols]), True)))
    return np.concatenate(out, axis=-2)


def _rs():
    return ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3"},
        device=CPU)


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_rs_encode_program_matches_pallas_and_regionops():
    ec = _rs()
    data = _data(1, (2, 8, 4096))
    got = _run(ec.matrix, data)
    assert np.array_equal(got, _pallas(ec.matrix, data))
    assert np.array_equal(got, ref_regionops.matrix_encode(data, ec.matrix,
                                                           8))
    # one tile of the 8 columns; 105 words, passed by value
    prog = dense_program(matrix_to_static(ec.matrix), 8)
    assert len(prog) == 105 <= BY_VALUE_MAX_PROG


@pytest.mark.parametrize("erasures", [1, 2, 3])
def test_rs_decode_programs_match_pallas_and_regionops(erasures):
    """Every decode matrix of RS k=8 m=3 with ``erasures`` lost chunks
    (11, 55 and 165 patterns; 231 in all), each through its own program,
    against one Pallas interpret call on the stacked rows of them all
    (the same survivors' bytes feed every matrix) and the region ops."""
    ec = _rs()
    data = _data(erasures, (2, 8, 256))
    mats, outs = [], []
    for erased in itertools.combinations(range(11), erasures):
        avail = tuple(i for i in range(11) if i not in erased)
        dm = ec._decode_matrix(avail, erased)[0]
        got = _run(dm, data)
        assert np.array_equal(got, ref_regionops.matrix_encode(data, dm, 8))
        mats.append(dm)
        outs.append(got)
    assert len(mats) == {1: 11, 2: 55, 3: 165}[erasures]
    stacked = np.concatenate(mats, axis=0)
    assert np.array_equal(np.concatenate(outs, axis=1),
                          _pallas(stacked, data))


@pytest.mark.parametrize("plugin,profile,erased", [
    ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}, (2, 7, 9)),
    ("isa", {"technique": "cauchy", "k": "6", "m": "3"}, (0, 6)),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "8"}, (3, 9)),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "8"}, (8, 9))])
def test_isa_and_r6_programs_match_pallas_and_regionops(plugin, profile,
                                                        erased):
    ec = ErasureCodePluginRegistry.instance().factory(plugin, dict(profile),
                                                      device=CPU)
    n = ec.k + ec.m
    avail = tuple(i for i in range(n) if i not in erased)
    dm = ec._decode_matrix(avail, erased)[0]
    for mat in (ec.matrix, dm):
        data = _data(len(mat), (2, mat.shape[1], 2048))
        got = _run(mat, data)
        assert np.array_equal(got, _pallas(mat, data))
        assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))


def _random_matrix(seed, r, s):
    """Zero rows, zero columns, an all-ones row and a row of one 0x80
    among random coefficients with zeros."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < 0.3] = 0
    mat[:, s // 2] = 0
    mat[0] = 1
    if r > 2:
        mat[1] = 0
        mat[2] = 0
        mat[2, -1] = 0x80
    return mat


@pytest.mark.parametrize("r", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("s,C", [(8, 4096), (5, 4096 + 4), (13, 1027),
                                 (30, 512)])
def test_random_programs_match_pallas_and_regionops(r, s, C):
    """Random matrices (more than one row block for r > 8, more than one
    tile for s > 12) at chunk sizes on and off the word and the unit."""
    mat = _random_matrix(r * 100 + s, r, s)
    data = _data(C + r, (2, s, C))
    got = _run(mat, data)
    assert np.array_equal(got, ref_regionops.matrix_encode(data, mat, 8))
    if C % 128 == 0:
        assert np.array_equal(got, _pallas(mat, data))
    if r > 2:
        assert not got[:, 1].any()
        assert np.array_equal(got[:, 0], np.bitwise_xor.reduce(data, axis=1))


@pytest.mark.parametrize("w", [16, 32])
def test_word_programs_match_pallas_words_and_regionops(w):
    """reed_sol_van k=8 m=3 at w=16/32 and a random matrix: levels run
    up to w bits, the xtime is the width's."""
    ec = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3",
                     "w": str(w)}, device=CPU)
    rng = np.random.default_rng(w)
    rand = rng.integers(0, 1 << w, (5, 6), dtype=np.uint64)
    rand[1] = 0
    rand[2, 3] = 0
    for mat in (ec.matrix, rand):
        data = _data(w + len(mat), (2, mat.shape[1], 4096))
        words = ref_regionops.words_view(data, w)
        got = interpret(dense_program(matrix_to_static(mat), w), data,
                        len(mat), w)
        got = ref_regionops.words_view(got, w)
        assert np.array_equal(got, ref_regionops.matrix_encode(words, mat,
                                                               w))
        assert np.array_equal(got, np.asarray(apply_matrix_pallas_words(
            words, ref_xla.matrix_to_static(mat), w, True)))


@pytest.mark.parametrize("s", [8, 40])
@pytest.mark.parametrize("r", list(range(1, 20)) + [64, 256])
def test_program_lays_out_every_coefficient_once(r, s):
    """The program holds the matrix and nothing else: decoding it gives
    back every coefficient, each row's tiles cover its block's nonzero
    columns once, in order, at most DENSE_TILE_COLS per tile."""
    mat = _random_matrix(r, r, s)
    prog = dense_program(matrix_to_static(mat), 8)
    nrb, per, units, tile_cols = dense_geometry(r, s)
    assert (int(prog[0]), int(prog[1]), int(prog[2])) == (len(prog), nrb,
                                                          per)
    assert per <= DENSE_ROWS_MAX and nrb * per >= r > (nrb - 1) * per
    back = np.zeros_like(mat)
    for rb in range(nrb):
        rows = range(rb * per, min(r, (rb + 1) * per))
        tp = int(prog[3 + rb])
        seen = []
        rp = {i: int(prog[3 + nrb + i]) for i in rows}
        for _ in range(int(prog[tp])):
            ncols = int(prog[tp + 1])
            cols = [int(j) for j in prog[tp + 2:tp + 2 + ncols]]
            assert 1 <= ncols <= tile_cols
            seen += cols
            tp += 1 + ncols
            for i in rows:
                top = int(prog[rp[i]])
                rp[i] += 1
                for lev in range(top):
                    n = int(prog[rp[i]])
                    for off in prog[rp[i] + 1:rp[i] + 1 + 2 * n]:
                        slot = int(off) // (DENSE_UNITS * 16)
                        if slot == min(s, tile_cols):
                            continue                # the zero slot
                        bit = 1 << (top - 1 - lev)
                        assert not back[i, cols[slot]] & bit
                        back[i, cols[slot]] |= bit
                    rp[i] += 1 + 2 * n
        assert seen == sorted(np.flatnonzero(mat[rows.start:rows.stop]
                                             .any(axis=0)))
    assert np.array_equal(back, mat)


def test_geometry_rule():
    """Balanced blocks of at most 8 rows when the columns fit a tile, one
    row per block when they do not."""
    assert [dense_geometry(r, 8)[:2] for r in (1, 2, 3, 8, 9, 11, 17, 64)] \
        == [(1, 1), (1, 2), (1, 3), (1, 8), (2, 5), (2, 6), (3, 6), (8, 8)]
    assert [dense_geometry(r, 12)[:2] for r in (1, 3, 64)] == [
        (1, 1), (3, 1), (64, 1)]
    assert dense_geometry(3, 11) == (1, 3, DENSE_UNITS, DENSE_TILE_COLS)
    assert {dense_geometry(r, s)[2:] for r in range(1, 40)
            for s in (1, 11, 12, 704)} == {(128, 11)}
    with pytest.raises(ValueError):
        dense_geometry(0, 8)
    assert not gf_kernels.matrix_kernel_fits(65536, 12)
    assert gf_kernels.matrix_kernel_fits(65536, 11)


def _rs_decode_3_9():
    ec = _rs()
    avail = tuple(i for i in range(11) if i not in (3, 9))
    return matrix_to_static(ec._decode_matrix(avail, (3, 9))[0])


def test_row_op_count_and_floor_on_rs():
    """The chain per output row on the RS k=8 m=3 encode and decode (3,
    9): 14 and 7 xtimes at 4 instructions, the rows' set bits two per
    LOP3 — 89 and 47 instructions per word position, under the chain per
    column's 225 and 215."""
    enc = matrix_to_static(_rs().matrix)
    dec = _rs_decode_3_9()
    assert sm90_row_op_count(enc) == 4 * 14 + (8 // 2 + 30 // 2 + 28 // 2) \
        == 89
    assert sm90_row_op_count(dec) == 4 * 7 + (8 // 2 + 31 // 2) == 47
    assert (sm90_op_count(enc), sm90_op_count(dec)) == (225, 215)
    assert (sm90_op_floor(enc), sm90_op_floor(dec)) == (89, 47)
    # what the kernel spends on its program: a level's odd bit costs a
    # whole XOR, and each tile's partial row one XOR into the accumulator
    assert program_op_count(enc) == 93
    assert program_op_count(dec) == 51


def test_row_op_count_by_hand():
    assert sm90_row_op_count(((1,),)) == 0
    assert sm90_row_op_count(((3, 1),)) == 4 * 1 + 3 // 2
    assert sm90_row_op_count(((0x80, 0x80, 1),)) == 4 * 7 + 3 // 2
    assert sm90_row_op_count(((0, 0), (0, 0))) == 0
    # one column feeding many rows: the chain per column wins
    tall = tuple((0x80,) for _ in range(5))
    assert sm90_op_count(tall) == 4 * 7
    assert sm90_row_op_count(tall) == 5 * 4 * 7
    assert sm90_op_floor(tall) == 4 * 7
    assert sm90_row_op_count(((1 << 15, 1),), 16) == 4 * 15 + 1
    assert sm90_row_op_count(((1 << 31, 1),), 32) == 3 * 31 + 1
    assert SM90_XT_COST == {8: 4, 16: 4, 32: 3}
    with pytest.raises(KeyError):
        sm90_row_op_count(((3, 1),), 7)


@pytest.mark.parametrize("seed", range(6))
def test_floor_never_above_either_form(seed):
    rng = np.random.default_rng(seed)
    r, s = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    for w in (8, 16, 32):
        mat = rng.integers(0, 1 << w, (r, s), dtype=np.uint64)
        mat[rng.random((r, s)) < 0.4] = 0
        ms = matrix_to_static(mat)
        floor = sm90_op_floor(ms, w)
        assert floor <= sm90_op_count(ms, w)
        assert floor <= sm90_row_op_count(ms, w)
        assert floor in (sm90_op_count(ms, w), sm90_row_op_count(ms, w))
        # the kernel's own count is never below the row form's least
        assert program_op_count(ms, w) >= sm90_row_op_count(ms, w)


def test_program_is_cached_per_matrix():
    ms = matrix_to_static(_rs().matrix)
    assert dense_program(ms, 8) is dense_program(
        matrix_to_static(_rs().matrix), 8)
    assert gf_kernels.matrix_kernel_fits(64, 704, 8)
    assert not gf_kernels.matrix_kernel_fits(1, gf_kernels.MAX_TABLE_COEF + 1)
