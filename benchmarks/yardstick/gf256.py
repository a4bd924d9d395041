"""The benchmark's plain erasure-code reference: GF(2^8) arithmetic,
jerasure's ``reed_sol_van`` coding matrix, shec's shingled windows, and
an encode and a decode in plain PyTorch.

Frozen copies of the project's ``ceph_tpu/gf/gf8.py`` (scalar multiply
and divide over jerasure's polynomial 0x11D),
``ceph_tpu/matrices/jerasure.py`` (the extended Vandermonde matrix made
systematic in jerasure's elimination order) and
``ceph_tpu/codes/plugins/shec.py::_shec_coding_matrix``.  Nothing here
imports the program under test: the benchmark works every matrix out
again (the decode rows by Gauss-Jordan elimination), and products are
looked up in a 256 x 256 table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D  # jerasure's GF(2^8) primitive polynomial (galois.c)


def gf_mul(a: int, b: int) -> int:
    """galois_single_multiply(a, b, 8): carry-less product reduced by
    POLY."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= POLY
        b >>= 1
    return r


def gf_inv(a: int) -> int:
    """a^254, the inverse of a != 0."""
    if a == 0:
        raise ZeroDivisionError("GF inverse of 0")
    r, base, n = 1, a, 254
    while n:
        if n & 1:
            r = gf_mul(r, base)
        base = gf_mul(base, base)
        n >>= 1
    return r


def gf_div(a: int, b: int) -> int:
    return 0 if a == 0 else gf_mul(a, gf_inv(b))


def _extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """reed_sol.c -> reed_sol_extended_vandermonde_matrix."""
    vdm = np.zeros((rows, cols), dtype=np.int64)
    vdm[0, 0] = 1
    vdm[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(cols):
            vdm[i, j] = acc
            acc = gf_mul(acc, i)
    return vdm


def _big_vandermonde_distribution(rows: int, cols: int) -> np.ndarray:
    """reed_sol.c -> reed_sol_big_vandermonde_distribution_matrix, in
    jerasure's order: per column pivot, scale, eliminate; then the first
    coding row to ones by column scaling; then each later coding row's
    first element to 1 by row scaling."""
    dist = _extended_vandermonde(rows, cols)
    for i in range(1, cols):
        j = i
        while j < rows and dist[j, i] == 0:
            j += 1
        if j >= rows:
            raise ArithmeticError("couldn't make distribution matrix")
        if j != i:
            dist[[i, j]] = dist[[j, i]]
        if dist[i, i] != 1:
            inv = gf_div(1, int(dist[i, i]))
            for r in range(rows):
                dist[r, i] = gf_mul(inv, int(dist[r, i]))
        for j in range(cols):
            e = int(dist[i, j])
            if j != i and e != 0:
                for r in range(rows):
                    dist[r, j] ^= gf_mul(e, int(dist[r, i]))
    for j in range(cols):
        e = int(dist[cols, j])
        if e != 1:
            inv = gf_div(1, e)
            for r in range(cols, rows):
                dist[r, j] = gf_mul(inv, int(dist[r, j]))
    for i in range(cols + 1, rows):
        e = int(dist[i, 0])
        if e != 1:
            inv = gf_div(1, e)
            for j in range(cols):
                dist[i, j] = gf_mul(int(dist[i, j]), inv)
    return dist


@functools.lru_cache(maxsize=None)
def reed_sol_van(k: int, m: int) -> np.ndarray:
    """(m, k) coding rows of jerasure's technique=reed_sol_van, w=8."""
    return _big_vandermonde_distribution(k + m, k)[k:k + m].copy()


@functools.lru_cache(maxsize=None)
def shec_matrix(k: int, m: int, c: int) -> np.ndarray:
    """(m, k) shec coding matrix: parity i keeps reed_sol_van's row i on
    its shingle window {(floor(i*k/m) + t) mod k : t < ceil(k*c/m)}."""
    base = reed_sol_van(k, m)
    if m == 1 or c == m:
        return base
    width = -(-k * c // m)
    mat = np.zeros_like(base)
    for i in range(m):
        start = (i * k) // m
        for t in range(width):
            j = (start + t) % k
            mat[i, j] = base[i, j]
    return mat


def coding_matrix(profile: dict) -> np.ndarray:
    """The (m, k) coding matrix a configuration's profile states."""
    plugin = profile["plugin"]
    k, m = int(profile["k"]), int(profile["m"])
    if plugin == "jerasure" and profile["technique"] == "reed_sol_van":
        return reed_sol_van(k, m)
    if plugin == "shec":
        return shec_matrix(k, m, int(profile["c"]))
    raise ValueError(f"no reference for profile {profile}")


@functools.lru_cache(maxsize=None)
def _mul_table_np() -> np.ndarray:
    t = np.zeros((256, 256), dtype=np.uint8)
    for a in range(256):
        for b in range(256):
            t[a, b] = gf_mul(a, b)
    return t


def mul_table(device) -> torch.Tensor:
    """(256, 256) uint8 table of GF(2^8) products on ``device``."""
    return torch.from_numpy(_mul_table_np()).to(device)


def encode(data: torch.Tensor, matrix: np.ndarray,
           block: int = 16) -> torch.Tensor:
    """(B, k, C) uint8 -> (B, m, C) parity: out[i] = xor_j M[i, j] *
    data[j], by table lookup, ``block`` stripes at a time so that the
    int64 indices stay small."""
    table = mul_table(data.device)
    b, k, c = data.shape
    m = matrix.shape[0]
    out = torch.zeros((b, m, c), dtype=torch.uint8, device=data.device)
    for s in range(0, b, block):
        idx = data[s:s + block].long()
        for i in range(m):
            acc = out[s:s + block, i]
            for j in range(k):
                coef = int(matrix[i, j])
                if coef:
                    acc ^= table[coef][idx[:, j]]
    return out


def decode_matrix(matrix: np.ndarray, available: tuple,
                  lost: tuple) -> np.ndarray:
    """(len(lost), len(available)) rows that rebuild the data chunks
    ``lost`` from the chunks ``available``: Gauss-Jordan over GF(2^8) on
    the generator rows [I; M] of the available chunks, taking the first
    k independent ones; the columns of chunks it does not take are 0."""
    m, k = matrix.shape
    gen = np.vstack([np.eye(k, dtype=np.int64), matrix])
    rows = [[int(v) for v in gen[c]] + [int(t == i) for i in
            range(len(available))] for t, c in enumerate(available)]
    basis = []  # (pivot column, row) in reduced form
    for row in rows:
        for col, prow in basis:
            f = row[col]
            if f:
                row = [a ^ gf_mul(f, b) for a, b in zip(row, prow)]
        piv = next((c for c in range(k) if row[c]), None)
        if piv is None:
            continue
        inv = gf_inv(row[piv])
        row = [gf_mul(inv, a) for a in row]
        for i, (col, prow) in enumerate(basis):
            f = prow[piv]
            if f:
                basis[i] = (col, [a ^ gf_mul(f, b)
                                  for a, b in zip(prow, row)])
        basis.append((piv, row))
        if len(basis) == k:
            break
    if len(basis) < k:
        raise ValueError(f"chunks {available} do not determine the data")
    by_col = dict(basis)
    return np.array([by_col[c][k:] for c in lost], dtype=np.int64)


def decode(survivors: torch.Tensor, matrix: np.ndarray, available: tuple,
           lost: tuple) -> torch.Tensor:
    """(B, len(available), C) -> (B, len(lost), C): the lost data
    chunks, by the rows of :func:`decode_matrix`."""
    return encode(survivors, decode_matrix(matrix, available, lost))


__all__ = ["POLY", "coding_matrix", "decode", "decode_matrix", "encode",
           "gf_div", "gf_inv", "gf_mul", "mul_table", "reed_sol_van",
           "shec_matrix"]
