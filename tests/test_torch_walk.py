"""The "mxu" row's sparse column walk (``csrc/gf8_column_walk.cu``) on
the CPU: its kernel data and its plain version, held to ``ceph_tpu``.

- ``torch_ops.column_walk_data`` round-trips to the matrix (row tiles,
  records, entries, sentinels), for clay's composites and random sparse
  tables in several row tilings;
- ``torch_ops.apply_matrix_walk_torch`` (the kernel's plain version,
  walking the same data) equals the reference's
  ``ceph_tpu.ops.xla_ops.apply_matrix_mxu`` and the numpy ground truth
  on seeded clay composites, random sparse matrices, C % 4 != 0 and a
  strided chunk dimension;
- the column split: the records the kernel's splits walk partition the
  matrix, and the splits' products XORed together are the whole product;
- the capacity rule ``gf_kernels.walk_row_tile`` (clay's (256, 512)
  encode is one tile; any r is taken);
- the wrappers on a CPU tensor run the plain walk and count no launch.

Comparisons are exact.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.codes.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.ops.xla_ops import apply_matrix_mxu as ref_apply_mxu

from ceph_tpu_torch.codes.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import gf_kernels, regionops
from ceph_tpu_torch.ops.gf_kernels import (
    WALK_SMEM_BUDGET, WALK_WARPS, WALK_WORDS, pack_chunks, unpack_chunks,
    walk_data, walk_row_tile)
from ceph_tpu_torch.ops.torch_ops import (apply_matrix_walk_torch,
                                          column_walk_data, matrix_to_static)

K8 = {"k": "8", "m": "4", "d": "11"}


def _decode_walk_data(data: np.ndarray, r: int, s: int) -> np.ndarray:
    """The (r, s) matrix that column-walk ``data`` describes, read back
    as the kernel reads it; checks the layout on the way."""
    data = np.asarray(data, dtype=np.int64)
    tiles, rows_per_tile, rec_base, ent_base = (int(x) for x in data[:4])
    assert rec_base % 2 == 0 and tiles == -(-r // rows_per_tile)
    ptr = data[4:5 + tiles]
    assert ptr[0] == 0 and ent_base == rec_base + 2 * int(ptr[-1])
    recs = data[rec_base:ent_base].reshape(-1, 2)
    mat = np.zeros((r, s), dtype=np.int64)
    for t in range(tiles):
        k0, k_end = int(ptr[t]), int(ptr[t + 1]) - 1
        assert recs[k_end, 0] == 0              # the sentinel
        cols = recs[k0:k_end, 0] & 0xFFFFFF
        assert list(cols) == sorted(set(cols))  # each nonzero column once
        for k in range(k0, k_end):
            j, top = int(recs[k, 0]) & 0xFFFFFF, int(recs[k, 0]) >> 24
            ents = data[ent_base + recs[k, 1]:ent_base + recs[k + 1, 1]]
            assert ents.size > 0
            rows = t * rows_per_tile + (ents >> 8)
            coef = ents & 0xFF
            assert np.all(coef > 0) and list(rows) == sorted(rows)
            assert top == int(coef.max()).bit_length()
            mat[rows, j] = coef
    assert int(recs[int(ptr[-1]) - 1, 1]) == data.size - ent_base
    return mat


def _random_matrix(rng, r, s, zeros):
    mat = rng.integers(0, 256, (r, s))
    mat[rng.random((r, s)) < zeros] = 0
    return mat


def _clay_composites():
    """The k=8 m=4 d=11 encode, the (0,) and (8,) single-erasure and the
    (0, 1) double-erasure decode composites: (label, matrix, static)."""
    ec = ErasureCodePluginRegistry.instance().factory("clay", dict(K8),
                                                      device="cpu")
    out = [("encode",) + ec._encode_composite()]
    for erased in ((0,), (8,), (0, 1)):
        avail = tuple(i for i in range(12) if i not in erased)
        out.append((f"decode {erased}",)
                   + ec._decode_composite(avail, erased))
    return out


def test_walk_data_round_trips_on_the_clay_composites():
    """One row tile each; 6272 entries on the encode (25 KB) and 2252 on
    the (0,) decode (9 KB), as many as the nonzero coefficients."""
    for label, mat, ms in _clay_composites():
        data = walk_data(ms)
        assert data.dtype == np.int32 and data[0] == 1, label
        assert np.array_equal(_decode_walk_data(data, *mat.shape), mat)
        assert data.size - int(data[3]) == np.count_nonzero(mat), label
        if label in ("encode", "decode (0,)"):
            assert data.size - int(data[3]) == \
                {"encode": 6272, "decode (0,)": 2252}[label]


@pytest.mark.parametrize("r,s,rows_per_tile,zeros,seed", [
    (300, 40, 256, 0.7, 1), (64, 704, 7, 0.9, 2), (5, 3, 1, 0.0, 3),
    (17, 9, 4, 0.5, 4), (2, 6, 256, 1.0, 5)])
def test_walk_data_round_trips_in_row_tiles(r, s, rows_per_tile, zeros,
                                            seed):
    mat = _random_matrix(np.random.default_rng(seed), r, s, zeros)
    data = column_walk_data(matrix_to_static(mat), rows_per_tile)
    assert np.array_equal(_decode_walk_data(data, r, s), mat)


def test_walk_data_refuses_what_it_cannot_describe():
    with pytest.raises(ValueError):
        column_walk_data(((1, 2),), 0)
    with pytest.raises(ValueError):
        column_walk_data(np.ones((1, 1 << 24), dtype=np.int64), 1)


def _check(x: torch.Tensor, mat: np.ndarray, rows_per_tile: int):
    """The plain walk == the reference's MXU apply == numpy, on x."""
    ms = matrix_to_static(mat)
    got = apply_matrix_walk_torch(
        x, column_walk_data(ms, rows_per_tile), len(mat))
    want = np.asarray(ref_apply_mxu(np.ascontiguousarray(x.numpy()), ms, 8))
    assert np.array_equal(got.numpy(), want)
    flat = np.ascontiguousarray(x.numpy()).reshape((-1,) + x.shape[-2:])
    assert np.array_equal(got.numpy().reshape((-1, len(mat), x.shape[-1]))[0],
                          regionops.matrix_encode(flat[0], mat, 8))
    return got


@pytest.mark.parametrize("profile", [{"k": "4", "m": "2", "d": "5"}, K8],
                         ids=["k4m2d5", "k8m4d11"])
def test_walk_plain_matches_reference_on_clay(profile):
    """The encode and a single-erasure decode composite of clay, at a
    small sub-chunk, through the plain walk, against the reference's
    MXU apply and its decode_chunks_batch."""
    ours = ErasureCodePluginRegistry.instance().factory(
        "clay", dict(profile), device="cpu")
    ref = RefRegistry.instance().factory("clay", dict(profile))
    rng = np.random.default_rng(11)
    sub, sc = ours.sub_chunk_no, 8
    data = rng.integers(0, 256, (2, ours.k, sub * sc), dtype=np.uint8)
    mat, _ = ours._encode_composite()
    got = _check(torch.from_numpy(data).reshape(2, ours.k * sub, sc), mat,
                 walk_row_tile(len(mat)))
    parity = ref.encode_chunks_batch(data)
    assert np.array_equal(got.reshape(parity.shape).numpy(), parity)
    full = np.concatenate([data, parity], axis=1)
    n = ours.k + ours.m
    avail = tuple(range(1, n))
    mat, _ = ours._decode_composite(avail, (0,))
    surv = np.ascontiguousarray(full[:, list(avail)])
    got = _check(torch.from_numpy(surv).reshape(2, len(avail) * sub, sc),
                 mat, walk_row_tile(len(mat)))
    assert np.array_equal(got.reshape(2, 1, -1).numpy(), full[:, [0]])


@pytest.mark.parametrize("r,s,c,lead,rows_per_tile,zeros,seed", [
    (16, 48, 128, (2,), 16, 0.7, 1),
    (64, 176, 36 + 3, (3,), 64, 0.9, 2),        # C % 4 != 0
    (300, 20, 64, (2,), 256, 0.5, 3),           # two row tiles
    (9, 13, 5, (), 4, 0.3, 4),                  # no batch dim, tiny C
    (3, 8, 1, (2, 2), 2, 0.0, 5)])
def test_walk_plain_matches_reference_on_random(r, s, c, lead,
                                                rows_per_tile, zeros, seed):
    """Random sparse matrices, a strided chunk dimension (a survivor
    slice), tails off the word, several row tilings."""
    rng = np.random.default_rng(seed)
    mat = _random_matrix(rng, r, s, zeros)
    host = rng.integers(0, 256, lead + (s + 2, c), dtype=np.uint8)
    x = torch.from_numpy(host)[..., 1:s + 1, :]
    assert x.storage_offset() == c and (not lead or not x.is_contiguous())
    _check(x, mat, rows_per_tile)


def _split_matrices(mat, rows_per_tile, splits, warps):
    """The part of ``mat`` each column split of the kernel walks: in each
    row tile, warp w of split z starts at the tile's record z * warps + w
    and steps by warps * splits, so the q-th nonzero column of the tile
    falls to split (q // warps) % splits."""
    parts = [np.zeros_like(mat) for _ in range(splits)]
    for t0 in range(0, mat.shape[0], rows_per_tile):
        tile = slice(t0, t0 + rows_per_tile)
        for q, j in enumerate(np.flatnonzero(mat[tile].any(axis=0))):
            parts[(q // warps) % splits][tile, j] = mat[tile, j]
    return parts


@pytest.mark.parametrize("splits,warps", [(2, 16), (3, 16), (5, 2),
                                          (4, 1)])
def test_column_splits_xor_back_to_the_whole(splits, warps):
    """The records each of the kernel's column splits walks are disjoint
    and cover the matrix, and the splits' products XOR back to the whole
    product, as the split kernel's partials do in its zeroed output."""
    rng = np.random.default_rng(splits * 10 + warps)
    mat = _random_matrix(rng, 40, 150, 0.8)
    data = column_walk_data(matrix_to_static(mat), 16)
    x = torch.from_numpy(rng.integers(0, 256, (2, 150, 24), dtype=np.uint8))
    whole = apply_matrix_walk_torch(x, data, 40)
    parts = _split_matrices(mat, 16, splits, warps)
    assert np.array_equal(sum(parts), mat)
    assert all(np.count_nonzero(p) for p in parts)
    outs = [apply_matrix_walk_torch(
        x, column_walk_data(matrix_to_static(p), 16), 40) for p in parts]
    acc = outs[0].clone()
    for o in outs[1:]:
        acc ^= o
    assert torch.equal(acc, whole)
    assert not any(torch.equal(o, whole) for o in outs)


def test_capacity_rule():
    """A row tile's accumulators (rows x WALK_WORDS words) fit the
    kernel's shared-memory budget; clay's encode (r=256) is one tile;
    larger r is tiled, never refused."""
    assert WALK_SMEM_BUDGET // (4 * WALK_WORDS) == 256
    assert walk_row_tile(256) == 256 and walk_row_tile(1) == 1
    assert walk_row_tile(64) == 64
    for r in (257, 513, 4096):
        rows = walk_row_tile(r)
        assert rows * WALK_WORDS * 4 <= WALK_SMEM_BUDGET
        assert column_walk_data(np.ones((r, 2), dtype=np.int64),
                                rows)[0] == -(-r // rows)
    with pytest.raises(ValueError):
        walk_row_tile(0)
    assert WALK_WARPS >= 1


def test_wrappers_run_the_plain_walk_on_cpu_tensors():
    rng = np.random.default_rng(7)
    mat = _random_matrix(rng, 20, 30, 0.6)
    ms = matrix_to_static(mat)
    x = torch.from_numpy(rng.integers(0, 256, (2, 30, 1024), dtype=np.uint8))
    before = gf_kernels.launch_counts()
    got = gf_kernels.apply_matrix_mxu_cuda(x, ms)
    gotp = gf_kernels.apply_matrix_mxu_cuda_packed(pack_chunks(x), ms)
    assert gf_kernels.launch_counts() == before
    want = apply_matrix_walk_torch(x, walk_data(ms), 20)
    assert torch.equal(got, want) and torch.equal(unpack_chunks(gotp), want)
