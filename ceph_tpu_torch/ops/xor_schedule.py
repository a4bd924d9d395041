"""XOR schedules for packet-layout bitmatrix codes.

A copy of the part of ``ceph_tpu/ops/xor_schedule.py`` that the
bitmatrix techniques (cauchy_orig, cauchy_good, liberation, blaum_roth,
liber8tion) need, kept so that ``ceph_tpu_torch`` imports nothing of the
JAX package:

- :class:`XorSchedule`, ``_Emitter`` and the greedy pairwise CSE
  (``_greedy_cse``, Paar's algorithm as in arxiv 2108.02692):
  deterministic given the matrix, bounded by ``CSE_TOPK`` /
  ``CSE_MAX_TEMPS``, never worse than the naive XOR count;
- :func:`probe_bitmatrix_schedule`: the schedule of a bitmatrix, or
  None when sharing saves less than ``BITMATRIX_MIN_SAVINGS`` of the
  naive XORs.  Its ``static`` tuple equals the reference's for the same
  rows, so the port routes each matrix to the same kernel;
- :func:`eval_schedule_u8`: the evaluator of a pure-XOR schedule, which
  the plain torch version runs over packet views.

Added here (no counterpart in the reference): :func:`row_program`,
which turns a schedule into the rows the CUDA packet kernel runs
(``csrc/gf2_bitmatrix.cu``): one row per node that must exist, the XOR
of its leaves accumulated in a register, with per-thread slots assigned by
liveness.

Not ported yet: the GF(2^8) matrix scheduler (``build_schedule``,
``probe_schedule``, ``preferred_schedule``, the ring transform, the
``tuned_*`` seams and ``host_matrix_apply``).  It serves the shec/lrc
composite decodes (ROADMAP Queue A item 5, Queue B item 5) and reads
the tuned-config table of ``tune/``, which is not ported either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

# greedy-CSE bounds: candidate pairs are scanned among the TOPK
# most-shared variables per round, and the temp budget caps the rounds
CSE_TOPK = 128
CSE_MAX_TEMPS = 4096

# bitmatrix (packet-layout) codes: scheduled only when CSE saves at
# least NUM/DEN = 1/10 of the naive XOR count
BITMATRIX_MIN_SAVINGS = (1, 10)


# A schedule is a straight-line program over node ids: nodes
# 0..n_in-1 are the inputs; op i defines node n_in+i.  Bitmatrix
# schedules hold only ("xor", a, b) ops.  outputs: one node id per
# output row; -1 = all-zero row.

@dataclasses.dataclass(frozen=True)
class XorSchedule:
    """One scheduled matrix: the static program plus its cost model."""

    static: tuple            # ("xorsched", n_in, n_out, ops, outputs)
    n_in: int
    n_out: int
    n_ops: int               # schedule length (all emitted ops)
    xor_ops: int             # pure XOR ops
    plane_ops: int           # xtime / shift plane materializations
    vpu_ops: int             # modeled full-width vector-op cost
    naive_xor_ops: int       # XORs of the naive bit-matrix expansion
    dense_gf_ops: int        # the dense model's op count
    dense_vpu_ops: int       # modeled cost of the dense kernel
    transform: str           # "bitcse" for bitmatrix schedules


class _Emitter:
    """Accumulates ops + node ids (bitmatrix schedules emit only
    ``("xor", a, b)``, each of cost 1 in the reference's model)."""

    def __init__(self, n_in: int) -> None:
        self.n_in = n_in
        self.ops: List[tuple] = []

    def emit(self, op: tuple) -> int:
        self.ops.append(op)
        return self.n_in + len(self.ops) - 1

    def fold_xor(self, nodes: Sequence[int]) -> int:
        """Left-fold a (sorted) node list into one XOR chain; -1 when
        empty, the node itself when singleton."""
        if not nodes:
            return -1
        acc = nodes[0]
        for nid in nodes[1:]:
            acc = self.emit(("xor", acc, nid))
        return acc


def _greedy_cse(rows: List[Set[int]], n_vars: int,
                max_temps: int = CSE_MAX_TEMPS,
                topk: int = CSE_TOPK,
                ) -> Tuple[List[Tuple[int, int]], List[List[int]]]:
    """Fold the most-shared variable pair into a fresh temp until no
    pair co-occurs twice (or the budget runs out).

    ``rows`` are sets of variable ids (inputs 0..n_vars-1; temps get
    ids n_vars, n_vars+1, ... in creation order).  Returns the temp
    definitions ``[(a, b), ...]`` and the rewritten rows (sorted).
    Every fold with count >= 2 removes ``count`` terms and adds one
    op, so the total XOR count strictly decreases."""
    col: Dict[int, int] = {}
    for ri, row in enumerate(rows):
        bit = 1 << ri
        for v in row:
            col[v] = col.get(v, 0) | bit
    temps: List[Tuple[int, int]] = []
    next_var = n_vars
    while len(temps) < max_temps:
        cand = sorted((v for v in col if col[v].bit_count() >= 2),
                      key=lambda v: (-col[v].bit_count(), v))[:topk]
        best_cnt, best_pair = 1, None
        for i, a in enumerate(cand):
            ra = col[a]
            if ra.bit_count() <= best_cnt:
                break  # sorted descending: no later pair can beat it
            for b in cand[i + 1:]:
                c = (ra & col[b]).bit_count()
                if c > best_cnt or (c == best_cnt and best_pair
                                    and (a, b) < best_pair):
                    best_cnt, best_pair = c, (a, b)
        if best_pair is None or best_cnt < 2:
            break
        a, b = best_pair
        mask = col[a] & col[b]
        col[a] &= ~mask
        col[b] &= ~mask
        for v in (a, b):
            if not col[v]:
                del col[v]
        col[next_var] = mask
        temps.append((a, b))
        next_var += 1
    new_rows: List[List[int]] = [[] for _ in rows]
    for v in sorted(col):
        mask = col[v]
        while mask:
            ri = (mask & -mask).bit_length() - 1
            new_rows[ri].append(v)
            mask &= mask - 1
    return temps, [sorted(row) for row in new_rows]


@functools.lru_cache(maxsize=128)
def probe_bitmatrix_schedule(rows_masks: tuple, w: int
                             ) -> XorSchedule | None:
    """CSE over a jerasure packet-layout bitmatrix: inputs are the
    s*w packets, outputs the r*w parity packets.  Returns a schedule
    only when the sharing pays >= BITMATRIX_MIN_SAVINGS of the naive
    XOR count (the plain kernel is already pure XOR)."""
    rw = len(rows_masks)
    if rw == 0 or rw % w:
        return None
    ncols = max((int(m).bit_length() for m in rows_masks), default=0)
    if ncols == 0:
        return None
    s_in = ((ncols + w - 1) // w) * w
    rows: List[Set[int]] = []
    naive = 0
    for m in rows_masks:
        m = int(m)
        row = set()
        col = 0
        while m:
            if m & 1:
                row.add(col)
            m >>= 1
            col += 1
        naive += max(0, len(row) - 1)
        rows.append(row)
    temps, final_rows = _greedy_cse(rows, s_in)
    em = _Emitter(s_in)
    node_of: Dict[int, int] = {v: v for v in range(s_in)}
    for ti, (a, b) in enumerate(temps):
        na, nb = node_of[a], node_of[b]
        node_of[s_in + ti] = em.emit(("xor", min(na, nb), max(na, nb)))
    outputs = [em.fold_xor([node_of[v] for v in sorted(row)])
               for row in final_rows]
    num, den = BITMATRIX_MIN_SAVINGS
    xors = len(em.ops)
    if naive == 0 or (naive - xors) * den < num * naive:
        return None
    static = ("xorsched", s_in, rw, tuple(em.ops), tuple(outputs))
    return XorSchedule(
        static=static, n_in=s_in, n_out=rw, n_ops=xors, xor_ops=xors,
        plane_ops=0, vpu_ops=xors, naive_xor_ops=naive,
        dense_gf_ops=naive + rw, dense_vpu_ops=naive, transform="bitcse")


def eval_schedule_u8(static: tuple, inputs: Sequence, zero) -> list:
    """Pure-XOR schedule over uint8 packet arrays (the bitmatrix
    packet layout); only ``xor`` ops are legal here.  ``inputs`` holds
    the n_in input arrays (numpy or torch), ``zero`` makes an all-zero
    array for -1 outputs; returns the n_out output arrays in order."""
    _, n_in, _, ops, outputs = static
    nodes = list(inputs)
    for op in ops:
        if op[0] != "xor":
            raise ValueError(f"bitmatrix schedules hold xor ops only: {op}")
        nodes.append(nodes[op[1]] ^ nodes[op[2]])
    return [nodes[o] if o >= 0 else zero() for o in outputs]


# -- the CUDA kernel's rows ------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def row_program(static: tuple, w: int) -> Tuple[int, tuple]:
    """(number of slots, rows) of a pure-XOR schedule whose outputs are
    packets of w per chunk, in the form the CUDA packet kernel runs.

    Every node that must exist (an output, or a node read by two ops) is
    one row: the XOR of its leaves, the inputs and earlier such nodes
    under it, through the nodes read once, which are never made.  So a
    thread accumulates a row in a register and reads each leaf once,
    instead of reading two slots and writing one per XOR.  A row is
    ``(leaves, dst, store)``: leaf slot ids, the slot that keeps the
    result for later rows (None: not kept), and the output ``(chunk,
    packet)`` it is stored to (None: not an output).  Slots 0..n_in-1
    hold the inputs; a node's slot is free once its last reader has read
    it (a row may write the slot it reads: reads come first).  The last
    two slots are the kernel's zero and trash slots."""
    _, n_in, n_out, ops, outputs = static
    n_nodes = n_in + len(ops)
    reads = [0] * n_nodes
    for op in ops:
        if op[0] != "xor":
            raise ValueError(f"bitmatrix schedules hold xor ops only: {op}")
        reads[op[1]] += 1
        reads[op[2]] += 1
    rows_of: Dict[int, List[int]] = {}
    for row, node in enumerate(outputs):
        rows_of.setdefault(node, []).append(row)
    made = [n for n in range(n_in, n_nodes)
            if reads[n] >= 2 or n in rows_of]
    kept = set(made)
    leaves: Dict[int, List[int]] = {}
    for i, (_, a, b) in enumerate(ops):
        leaves[n_in + i] = [x for y in (a, b) for x in (
            [y] if y < n_in or y in kept else leaves[y])]
    # readers of a node as a leaf: the rows that take it, plus one copy
    # row for each output row past its first
    users = [0] * n_nodes
    for n in made:
        for x in leaves[n]:
            users[x] += 1
    plan: List[Tuple[List[int], int, int]] = []   # (leaf nodes, node, row)
    for row in rows_of.get(-1, []):
        plan.append(([], -1, row))
    for node in range(n_in):
        for row in rows_of.get(node, []):
            plan.append(([node], -1, row))
            users[node] += 1
    for n in made:
        rws = rows_of.get(n, [])
        plan.append((leaves[n], n, rws[0] if rws else -1))
        for row in rws[1:]:
            plan.append(([n], -1, row))
            users[n] += 1
    slot = list(range(n_in)) + [-1] * len(ops)
    free: List[int] = [v for v in range(n_in) if users[v] == 0][::-1]
    n_live = n_in
    rows = []
    for lv, node, row in plan:
        ids = tuple(slot[x] for x in lv)
        for x in lv:
            users[x] -= 1
            if users[x] == 0:
                free.append(slot[x])
        dst = None
        if node >= 0 and users[node]:
            if free:
                slot[node] = free.pop()
            else:
                slot[node] = n_live
                n_live += 1
            dst = slot[node]
        rows.append((ids, dst, None if row < 0 else divmod(row, w)))
    return n_live + 2, tuple(rows)


__all__ = [
    "BITMATRIX_MIN_SAVINGS", "CSE_MAX_TEMPS", "CSE_TOPK", "XorSchedule",
    "eval_schedule_u8", "probe_bitmatrix_schedule", "row_program",
]
