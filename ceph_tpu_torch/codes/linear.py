"""Generic decode planning for sparse linear codes (shec / lrc semantics).

The reference implements recovery-set selection twice, each time specialised:
- shec: src/erasure-code/shec/ErasureCodeShec.cc -> shec_minimum_to_decode /
  shec_make_decoding_matrix — searches over subsets of available parity
  chunks for the cheapest solvable recovery set (a cover problem, because
  each shec parity only covers a window of data chunks).
- lrc: src/erasure-code/lrc/ErasureCodeLrc.cc -> minimum_to_decode walking
  layers, preferring the smallest local layer that covers the erasure.

Here both reduce to one primitive over the (m, k) coding matrix M (full
generator G = [I_k ; M], sparse rows = local parities):

    decode_plan(M, k, w, available, want) ->
        (reads, want_order, D)   with   wanted = D @ chunks[reads]

found by searching subsets P of the available parity rows for the plan
minimising chunks read (ties: fewest parities). Solvability of a candidate
P is a rank test of M[P] restricted to the unknown (erased) data columns.
The returned D composes survivor-submatrix inversion with re-encoding of
wanted parity rows, so the hot path stays ONE batched GF(2^w) matrix
application on the card regardless of code structure.

A copy of ``ceph_tpu.codes.linear`` (pure numpy), kept so that
``ceph_tpu_torch`` imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..gf.gf8 import gf_mul
from ..gf.matrix import gf_invert_matrix, gf_rank

MAX_SEARCH_PARITIES = 16  # 2^16 subset cap; reference codes have m <= 11


class DecodePlan:
    """Result of decode planning: read set and one composed decode matrix."""

    __slots__ = ("reads", "want_order", "matrix")

    def __init__(self, reads: Tuple[int, ...], want_order: Tuple[int, ...],
                 matrix: np.ndarray) -> None:
        self.reads = reads            # chunk ids to read, ordered
        self.want_order = want_order  # wanted chunk ids, ordered as D rows
        self.matrix = matrix          # (len(want_order), len(reads)) GF matrix


def _window(matrix: np.ndarray, i: int) -> frozenset:
    """Data columns parity row i actually covers (nonzero coefficients)."""
    return frozenset(int(j) for j in np.nonzero(matrix[i])[0])


def decode_plan(matrix: np.ndarray, k: int, w: int, available: frozenset,
                want: frozenset) -> DecodePlan:
    """Minimum-read decode plan; raises IOError if unrecoverable.

    matrix: (m, k) coding matrix (rows may be sparse = local parities).
    available / want: chunk ids in [0, k + m).
    """
    matrix = np.asarray(matrix)
    m = matrix.shape[0]
    n = k + m
    if m > MAX_SEARCH_PARITIES:
        raise ValueError(f"m={m} exceeds decode search cap "
                         f"{MAX_SEARCH_PARITIES}")
    windows = [_window(matrix, i) for i in range(m)]
    avail_data = frozenset(c for c in available if c < k)
    erased_data = frozenset(j for j in range(k) if j not in available)
    want_avail = frozenset(c for c in want if c in available)
    want_data_erased = frozenset(c for c in want if c < k
                                 and c not in available)
    want_par_erased = frozenset(c - k for c in want if c >= k
                                and c not in available)

    # data unknowns forced by wanted-but-erased chunks
    base_unknown = set(want_data_erased)
    for i in sorted(want_par_erased):
        base_unknown |= windows[i] & erased_data

    avail_par = sorted(i for i in range(m) if k + i in available)
    best: tuple | None = None  # (n_reads, n_parities, P, U, data_reads)
    for r in range(len(avail_par) + 1):
        for P in itertools.combinations(avail_par, r):
            unknown = set(base_unknown)
            for i in P:
                unknown |= windows[i] & erased_data
            if len(P) < len(unknown):
                continue
            if unknown:
                sub = matrix[np.array(P)][:, sorted(unknown)]
                if gf_rank(sub, w) < len(unknown):
                    continue
            data_reads = set()
            for i in set(P) | want_par_erased:
                data_reads |= windows[i] & avail_data
            reads = (data_reads | set(k + i for i in P) | want_avail)
            score = (len(reads), len(P))
            if best is None or score < (best[0], best[1]):
                best = (len(reads), len(P), P, frozenset(unknown), reads)
    if best is None:
        raise IOError(
            f"cannot decode chunks {sorted(want - available)} from "
            f"available {sorted(available)}")
    _, _, P, unknown, reads = best
    reads_order = tuple(sorted(reads))
    want_order = tuple(sorted(want))
    D = _compose_decode_matrix(matrix, k, w, reads_order, want_order,
                               tuple(P), tuple(sorted(unknown)), windows)
    return DecodePlan(reads_order, want_order, D)


def _compose_decode_matrix(matrix: np.ndarray, k: int, w: int,
                           reads: Tuple[int, ...], want: Tuple[int, ...],
                           parities: Tuple[int, ...],
                           unknown: Tuple[int, ...],
                           windows: List[frozenset]) -> np.ndarray:
    """Build D with wanted = D @ chunks[reads] (all GF(2^w) host math)."""
    ridx = {c: t for t, c in enumerate(reads)}
    nr = len(reads)

    # expression vectors over the read chunks for every data symbol we touch
    expr: Dict[int, np.ndarray] = {}
    for c in reads:
        if c < k:
            e = np.zeros(nr, dtype=np.int64)
            e[ridx[c]] = 1
            expr[c] = e

    if unknown:
        # pick |unknown| independent parity rows (restricted to unknown cols)
        need = len(unknown)
        rows: List[int] = []
        for p in parities:
            trial = rows + [p]
            sub = matrix[np.array(trial)][:, list(unknown)]
            if gf_rank(sub, w) == len(trial):
                rows.append(p)
            if len(rows) == need:
                break
        assert len(rows) == need, "planner guaranteed solvability"
        inv = gf_invert_matrix(matrix[np.array(rows)][:, list(unknown)], w)
        # rhs_p = chunk_{k+p} - sum_{j in window(p) \ unknown} M[p,j] chunk_j
        rhs_expr = []
        for p in rows:
            e = np.zeros(nr, dtype=np.int64)
            e[ridx[k + p]] = 1
            for j in windows[p] - set(unknown):
                c = int(matrix[p, j])
                if c:
                    e = _axpy(e, c, expr[j], w)
            rhs_expr.append(e)
        for ui, u in enumerate(unknown):
            e = np.zeros(nr, dtype=np.int64)
            for pi in range(need):
                c = int(inv[ui, pi])
                if c:
                    e = _axpy(e, c, rhs_expr[pi], w)
            expr[u] = e

    out_rows = []
    for c in want:
        if c in ridx:  # wanted and read directly
            e = np.zeros(nr, dtype=np.int64)
            e[ridx[c]] = 1
        elif c < k:
            e = expr[c]
        else:  # erased parity: re-encode from (read or recovered) data
            i = c - k
            e = np.zeros(nr, dtype=np.int64)
            for j in windows[i]:
                coef = int(matrix[i, j])
                if coef:
                    e = _axpy(e, coef, expr[j], w)
        out_rows.append(e)
    return np.array(out_rows, dtype=np.int64)


def _axpy(acc: np.ndarray, c: int, vec: np.ndarray, w: int) -> np.ndarray:
    """acc ^= c * vec elementwise in GF(2^w) (host-side tiny vectors)."""
    out = acc.copy()
    for t in range(len(vec)):
        v = int(vec[t])
        if v:
            out[t] ^= gf_mul(c, v, w)
    return out
