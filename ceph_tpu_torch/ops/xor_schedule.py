"""XOR schedules: the GF(2^8) matrix scheduler and the packet-layout
bitmatrix CSE.

A copy of ``ceph_tpu/ops/xor_schedule.py``, kept so that
``ceph_tpu_torch`` imports nothing of the JAX package:

- the GF(2^8) matrix scheduler: a static (r, s) matrix becomes a
  straight-line program of full-width SWAR word ops (``xt``, byte-local
  ``shl`` / ``shr``, ``xor``) over 4 field bytes per 32-bit word.
  :func:`build_schedule` takes the cheaper of the bit-matrix expansion
  with greedy pairwise CSE (Paar's algorithm, arxiv 2108.02692) and, for
  monomial matrices, the polynomial-ring transform with lazy reduction
  (arxiv 1701.07731); :func:`probe_schedule` caches it per matrix and
  :func:`preferred_schedule` is the XOR-density probe the engine table
  consults.  The CSE horizon and the XOR/dense cutover are seams of the
  best-config table (tune/table.py): :func:`tuned_cse_topk` and
  :func:`tuned_xor_cutover`, :data:`CSE_TOPK` and
  :data:`XOR_DENSE_CUTOVER` without one;
- the evaluators :func:`eval_schedule` (uint32 SWAR words),
  :func:`apply_schedule_numpy` and :func:`host_matrix_apply` (the host
  tier: the identical schedule when one is preferred, the regionops
  ground truth otherwise);
- the packet-layout bitmatrix CSE (:func:`probe_bitmatrix_schedule`,
  :func:`eval_schedule_u8`) of jerasure's bitmatrix techniques.

Every ``static`` tuple equals the reference's for the same matrix, so the
port routes each matrix to the same kernel.

Added here (no counterpart in the reference), the programs the CUDA
kernels run:

- :func:`row_program` and :func:`plain_row_program`: a pure-XOR schedule,
  or the plain product, as the rows of the packet kernel
  (``csrc/gf2_bitmatrix.cu``), for all outputs or one row group's;
- :func:`word_program`: a GF(2^8) schedule as the instructions of the
  word kernel (``csrc/gf8_xor_schedule.cu``).

Both make only the nodes that must exist, accumulate each one in a
register from its leaves, and assign per-thread slots by liveness.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..gf.bitmatrix import bitmatrix_n_ones
from ..gf.gf8 import GF8_POLY
from ..tune.table import consult

W = 8
FEEDBACK = GF8_POLY & 0xFF                       # 0x1d
FB_TAPS = tuple(b for b in range(W) if (FEEDBACK >> b) & 1)  # (0, 2, 3, 4)

# modeled full-width vector-op costs (the probe's common currency)
XOR_COST = 1          # a ^ b
SHIFT_COST = 2        # byte-local shift: shift + lane mask
XT_COST = 10          # mul-free xtime: mask, 2 shifts, 4 tap shifts/xors
DENSE_XT_COST = 5     # the dense kernel's mul-form xtime (hi*0x1d)

# bit-matrix ones above which the probe declines to schedule (the greedy
# CSE is bounded but not free; huge composites stay on the dense tier)
DEFAULT_MAX_ONES = 20000


def _max_ones() -> int:
    try:
        return int(os.environ.get("CEPH_TPU_XOR_SCHED_MAX_ONES",
                                  str(DEFAULT_MAX_ONES)))
    except ValueError:
        return DEFAULT_MAX_ONES


# the XOR tier must WIN on the cost model, not tie it: schedule only when
# scheduled_ops * DEN <= dense_ops * NUM (an integer ratio)
XOR_DENSE_CUTOVER = (3, 4)

# greedy-CSE bounds: candidate pairs are scanned among the TOPK
# most-shared variables per round, and the temp budget caps the rounds
CSE_TOPK = 128
CSE_MAX_TEMPS = 4096

# bitmatrix (packet-layout) codes: scheduled only when CSE saves at
# least NUM/DEN = 1/10 of the naive XOR count
BITMATRIX_MIN_SAVINGS = (1, 10)


# A schedule is a straight-line program over node ids: nodes 0..n_in-1
# are the inputs; op i defines node n_in+i.  Ops:
#   ("xt",  src)       node = xtime(src)          (byte-local, w=8)
#   ("shl", src, sh)   node = byte-local src << sh
#   ("shr", src, sh)   node = byte-local src >> sh
#   ("xor", a, b)      node = a ^ b
# Bitmatrix schedules hold only xor ops.  outputs: one node id per output
# row; -1 = all-zero row.

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
    transform: str           # "cse" | "ring" | "bitcse"

    @property
    def reduction_ratio(self):
        """Dense-model ops per scheduled op (>= 1.0 when scheduling
        pays; the bench decode rows record it).  None for a zero-op
        schedule (pure copies: inf is not valid JSON)."""
        if not self.vpu_ops:
            return None
        return round(self.dense_vpu_ops / self.vpu_ops, 3)

    def stats(self) -> dict:
        """The schedule's cost model, as the bench decode rows print it."""
        return {
            "transform": self.transform,
            "len": self.n_ops,
            "xor_ops": self.xor_ops,
            "plane_ops": self.plane_ops,
            "vpu_ops": self.vpu_ops,
            "naive_xor_ops": self.naive_xor_ops,
            "dense_gf_ops": self.dense_gf_ops,
            "dense_vpu_ops": self.dense_vpu_ops,
            "reduction_ratio": self.reduction_ratio,
        }


class _Emitter:
    """Accumulates ops + node ids with the cost model attached."""

    COST = {"xt": XT_COST, "shl": SHIFT_COST, "shr": SHIFT_COST,
            "xor": XOR_COST}

    def __init__(self, n_in: int) -> None:
        self.n_in = n_in
        self.ops: List[tuple] = []
        self.vpu_ops = 0
        self.xor_ops = 0
        self.plane_ops = 0

    def emit(self, op: tuple) -> int:
        self.ops.append(op)
        kind = op[0]
        self.vpu_ops += self.COST[kind]
        if kind == "xor":
            self.xor_ops += 1
        else:
            self.plane_ops += 1
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


# -- bit-equation extraction and the naive / dense cost models ----------------

def _bit_rows(matrix_t) -> List[Set[int]]:
    """Row i -> the doubling-plane set {j*8+t : bit t of M[i][j]}."""
    s = len(matrix_t[0])
    rows: List[Set[int]] = []
    for row in matrix_t:
        planes: Set[int] = set()
        for j in range(s):
            e = int(row[j])
            t = 0
            while e:
                if e & 1:
                    planes.add(j * W + t)
                e >>= 1
                t += 1
        rows.append(planes)
    return rows


def naive_bitmatrix_xors(matrix_t) -> int:
    """XOR count of the naive full bit-matrix expansion: total ones of
    the (r*8, s*8) GF(2) matrix minus its nonzero bit-rows."""
    ones = 0
    nonzero_bit_rows = 0
    for row in matrix_t:
        ones += sum(bitmatrix_n_ones(int(e)) for e in row if e)
        if any(int(e) for e in row):
            nonzero_bit_rows += W  # every bit-row of a nonzero GF row
    return max(0, ones - nonzero_bit_rows)


def dense_vpu_cost(matrix_t) -> int:
    """Modeled op count of the dense unrolled xtime/XOR kernel: per
    input column, the shared doubling chain up to its highest used bit,
    plus one XOR per set bit of every entry."""
    r = len(matrix_t)
    s = len(matrix_t[0])
    cost = 0
    for j in range(s):
        col = [int(matrix_t[i][j]) for i in range(r)]
        top = max((c.bit_length() for c in col), default=0)
        if top > 1:
            cost += DENSE_XT_COST * (top - 1)
        cost += sum(c.bit_count() for c in col)
    return cost


def _monomial_shifts(matrix_t) -> Optional[List[List[Optional[int]]]]:
    """sh[i][j] when every nonzero entry is x^sh (a power of two in
    GF(2^8)); None when the matrix leaves the monomial subset."""
    out: List[List[Optional[int]]] = []
    for row in matrix_t:
        sh_row: List[Optional[int]] = []
        for e in row:
            e = int(e)
            if e == 0:
                sh_row.append(None)
            elif e & (e - 1):
                return None
            else:
                sh_row.append(e.bit_length() - 1)
        out.append(sh_row)
    return out


# -- schedule builders --------------------------------------------------------

def _finish(em: _Emitter, outputs: List[int], matrix_t, naive: int,
            dense_vpu: int, transform: str) -> XorSchedule:
    r = len(matrix_t)
    s = len(matrix_t[0])
    static = ("xorsched", em.n_in, r, tuple(em.ops), tuple(outputs))
    return XorSchedule(
        static=static, n_in=em.n_in, n_out=r, n_ops=len(em.ops),
        xor_ops=em.xor_ops, plane_ops=em.plane_ops,
        vpu_ops=em.vpu_ops, naive_xor_ops=naive,
        dense_gf_ops=2 * r * s, dense_vpu_ops=dense_vpu,
        transform=transform)


def _build_cse(matrix_t, naive: int, dense_vpu: int,
               topk: int = CSE_TOPK) -> XorSchedule:
    s = len(matrix_t[0])
    rows = _bit_rows(matrix_t)
    # equations per output BYTE on the doubling-plane domain: the byte
    # rows are the grouped bit-matrix equations
    temps, final_rows = _greedy_cse(rows, s * W, topk=topk)
    n_planes = s * W
    # the doubling planes that must exist: referenced by rows or by temp
    # definitions (temps reference their original operands)
    used: Set[int] = set()
    for a, b in temps:
        for v in (a, b):
            if v < n_planes:
                used.add(v)
    for row in final_rows:
        for v in row:
            if v < n_planes:
                used.add(v)
    em = _Emitter(s)
    node_of: Dict[int, int] = {}
    max_t: Dict[int, int] = {}
    for v in sorted(used):
        j, t = divmod(v, W)
        max_t[j] = max(max_t.get(j, 0), t)
    for j in sorted(max_t):
        node_of[j * W] = j               # plane t=0 IS the input
        prev = j
        for t in range(1, max_t[j] + 1):
            prev = em.emit(("xt", prev))
            node_of[j * W + t] = prev
    for ti, (a, b) in enumerate(temps):
        na, nb = node_of[a], node_of[b]
        node_of[n_planes + ti] = em.emit(("xor", min(na, nb),
                                          max(na, nb)))
    outputs = [em.fold_xor([node_of[v] for v in sorted(row)])
               for row in final_rows]
    return _finish(em, outputs, matrix_t, naive, dense_vpu, "cse")


def _build_ring(matrix_t, shifts, naive: int, dense_vpu: int,
                topk: int = CSE_TOPK) -> Optional[XorSchedule]:
    """The 1701.07731 lazy-reduction schedule for monomial matrices:
    accumulate out[i] = sum_j x^sh_ij * in_j in F2[x] as a (low,
    overflow) byte-plane pair — shifts are byte-local shift pairs,
    accumulation pure XOR — then fold the overflow through the
    feedback taps once per output row (two levels close it for 0x11d:
    overflow bits <= 6, second-level bits <= 2)."""
    r = len(matrix_t)
    s = len(matrix_t[0])
    # one CSE variable per used (kind, j, sh) plane, in a fixed order
    plane_vars: Dict[Tuple[str, int, int], int] = {}
    lo_rows: List[Set[int]] = []
    hi_rows: List[Set[int]] = []
    for i in range(r):
        lo: Set[int] = set()
        hi: Set[int] = set()
        for j in range(s):
            sh = shifts[i][j]
            if sh is None:
                continue
            lv = plane_vars.setdefault(("shl", j, sh), len(plane_vars))
            lo.add(lv)
            if sh > 0:
                hv = plane_vars.setdefault(("shr", j, W - sh),
                                           len(plane_vars))
                hi.add(hv)
        lo_rows.append(lo)
        hi_rows.append(hi)
    n_vars = len(plane_vars)
    temps, folded = _greedy_cse(lo_rows + hi_rows, n_vars, topk=topk)
    em = _Emitter(s)
    node_of: Dict[int, int] = {}
    for key, var in sorted(plane_vars.items(), key=lambda kv: kv[1]):
        kind, j, sh = key
        node_of[var] = j if sh == 0 else em.emit((kind, j, sh))
    for ti, (a, b) in enumerate(temps):
        na, nb = node_of[a], node_of[b]
        node_of[n_vars + ti] = em.emit(("xor", min(na, nb),
                                        max(na, nb)))

    def fold_overflow(h: int) -> int:
        """h carries polynomial bits 8.. as byte bits 0..; return its
        GF(2^8) reduction h * (x^8 mod p) mod p as a node."""
        terms = [h]
        over = []
        for tap in FB_TAPS[1:]:
            terms.append(em.emit(("shl", h, tap)))
            over.append(em.emit(("shr", h, W - tap)))
        low = em.fold_xor(terms)
        h2 = em.fold_xor(over)
        # second level: overflow of the overflow (bits <= 2 for 0x11d;
        # its shl taps cannot overflow again)
        terms2 = [h2]
        for tap in FB_TAPS[1:]:
            terms2.append(em.emit(("shl", h2, tap)))
        return em.emit(("xor", low, em.fold_xor(terms2)))

    outputs: List[int] = []
    for i in range(r):
        lnode = em.fold_xor([node_of[v] for v in folded[i]])
        hnode = em.fold_xor([node_of[v] for v in folded[r + i]])
        if hnode == -1:
            outputs.append(lnode)
        elif lnode == -1:
            outputs.append(fold_overflow(hnode))
        else:
            outputs.append(em.emit(("xor", lnode,
                                    fold_overflow(hnode))))
    return _finish(em, outputs, matrix_t, naive, dense_vpu, "ring")


def build_schedule(matrix_t, w: int = 8,
                   topk: Optional[int] = None) -> XorSchedule:
    """Schedule one static (r, s) GF(2^8) matrix: the cheaper of the CSE
    schedule and (for monomial-subset matrices) the ring-transform
    schedule, deterministic given the matrix and the CSE candidate
    horizon ``topk`` (None: CSE_TOPK)."""
    if w != W:
        raise ValueError(f"XOR scheduling is w=8 only, got w={w}")
    if not matrix_t or not matrix_t[0]:
        raise ValueError("empty matrix")
    if topk is None:
        topk = CSE_TOPK
    naive = naive_bitmatrix_xors(matrix_t)
    dense_vpu = dense_vpu_cost(matrix_t)
    sched = _build_cse(matrix_t, naive, dense_vpu, topk=topk)
    shifts = _monomial_shifts(matrix_t)
    if shifts is not None:
        ring = _build_ring(matrix_t, shifts, naive, dense_vpu,
                           topk=topk)
        # ring wins only on the full cost model AND without breaking
        # the never-worse-than-naive XOR property
        if ring is not None and ring.vpu_ops < sched.vpu_ops \
                and ring.xor_ops <= max(naive, sched.xor_ops):
            sched = ring
    return sched


# -- the probe (what select_matrix_engine consults) ---------------------------

def tuned_cse_topk() -> int:
    """The greedy-CSE candidate horizon: the tuned value from the
    installed best-config table (kind ``xor-schedule``), else CSE_TOPK
    byte-identically — the schedule changes op COUNT only, never
    output bytes."""
    cfg = consult("xor-schedule")
    if cfg:
        v = cfg.get("cse_topk")
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            return v
    return CSE_TOPK


def tuned_xor_cutover() -> Tuple[int, int]:
    """The XOR/dense cutover ratio (num, den): tuned from the table
    (kind ``engine-select``), else XOR_DENSE_CUTOVER.  Still an integer
    ratio."""
    cfg = consult("engine-select")
    if cfg:
        v = cfg.get("xor_cutover")
        try:
            num, den = int(v[0]), int(v[1])
        except (TypeError, ValueError, IndexError):
            return XOR_DENSE_CUTOVER
        if num > 0 and den > 0:
            return num, den
    return XOR_DENSE_CUTOVER


@functools.lru_cache(maxsize=256)
def _probe_schedule_cached(matrix_t, w: int,
                           topk: int) -> Optional[XorSchedule]:
    if w != W or not matrix_t or not matrix_t[0]:
        return None
    ones = sum(bitmatrix_n_ones(int(e))
               for row in matrix_t for e in row if e)
    if ones == 0 or ones > _max_ones():
        return None
    return build_schedule(matrix_t, w, topk=topk)


def probe_schedule(matrix_t, w: int = 8) -> Optional[XorSchedule]:
    """Build-and-cache the schedule of a static matrix (a tuple of
    tuples), or None when the matrix is out of scope: w != 8, or its
    bit-matrix expansion exceeds the scheduling budget (DEFAULT_MAX_ONES
    ones).  Cached on (matrix, CSE horizon), so a tuned-table install
    (which may change the horizon) never serves a schedule built under
    the old config."""
    return _probe_schedule_cached(matrix_t, w, tuned_cse_topk())


# tests and tune.table.install_table clear the probe through the
# public name
probe_schedule.cache_clear = _probe_schedule_cached.cache_clear
probe_schedule.cache_info = _probe_schedule_cached.cache_info


def preferred_schedule(matrix_t, w: int = 8,
                       mxu_min: Optional[int] = None,
                       ) -> Optional[XorSchedule]:
    """The XOR-density decision: the schedule, iff the cost model says it
    beats the dense unrolled kernel by the cutover (tuned_xor_cutover) —
    and, at or above ``mxu_min`` nonzeros, only when the schedule also
    undercuts one op per nonzero."""
    sched = probe_schedule(matrix_t, w)
    if sched is None:
        return None
    num, den = tuned_xor_cutover()
    if sched.vpu_ops * den > num * sched.dense_vpu_ops:
        return None
    if mxu_min is not None:
        nnz = sum(1 for row in matrix_t for e in row if e)
        if nnz >= mxu_min and sched.vpu_ops >= nnz:
            return None
    return sched


# -- bitmatrix (packet-layout) CSE --------------------------------------------

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
    if naive == 0 or (naive - em.xor_ops) * den < num * naive:
        return None
    static = ("xorsched", s_in, rw, tuple(em.ops), tuple(outputs))
    return XorSchedule(
        static=static, n_in=s_in, n_out=rw, n_ops=len(em.ops),
        xor_ops=em.xor_ops, plane_ops=0, vpu_ops=em.vpu_ops,
        naive_xor_ops=naive, dense_gf_ops=naive + rw,
        dense_vpu_ops=naive, transform="bitcse")


# -- execution: one evaluator for the numpy tier and the tests ----------------

_LMASK = tuple(int.from_bytes(bytes([(0xFF << sh) & 0xFF] * 4),
                              "little") for sh in range(W))
_RMASK = tuple(int.from_bytes(bytes([0xFF >> sh] * 4), "little")
               for sh in range(W))


def xtime_words_xor(v):
    """Byte-local multiply-by-x on uint32 SWAR words, mul-free: the
    feedback 0x1d is applied as ``t ^ t<<2 ^ t<<3 ^ t<<4`` (the taps of
    GF8_POLY)."""
    hi = v & np.uint32(0x80808080)
    t = hi >> np.uint32(W - 1)
    out = (v ^ hi) << np.uint32(1)
    for tap in FB_TAPS:
        out = out ^ (t << np.uint32(tap)) if tap else out ^ t
    return out


def eval_schedule(static: tuple, inputs: Sequence, zero) -> list:
    """Run one schedule over per-input uint32 word arrays (numpy);
    ``zero`` makes an all-zero array for -1 outputs.  Returns the n_out
    output arrays in row order."""
    _, n_in, _, ops, outputs = static
    nodes = list(inputs)
    for op in ops:
        kind = op[0]
        if kind == "xor":
            nodes.append(nodes[op[1]] ^ nodes[op[2]])
        elif kind == "xt":
            nodes.append(xtime_words_xor(nodes[op[1]]))
        elif kind == "shl":
            nodes.append((nodes[op[1]] << np.uint32(op[2]))
                         & np.uint32(_LMASK[op[2]]))
        else:  # "shr"
            nodes.append((nodes[op[1]] >> np.uint32(op[2]))
                         & np.uint32(_RMASK[op[2]]))
    return [nodes[o] if o >= 0 else zero() for o in outputs]


def eval_schedule_u8(static: tuple, inputs: Sequence, zero) -> list:
    """Pure-XOR schedule over uint8 packet arrays (the bitmatrix packet
    layout); only ``xor`` ops are legal here.  ``inputs`` holds the n_in
    input arrays (numpy or torch), ``zero`` makes an all-zero array for
    -1 outputs; returns the n_out output arrays in order."""
    _, n_in, _, ops, outputs = static
    nodes = list(inputs)
    for op in ops:
        if op[0] != "xor":
            raise ValueError(f"bitmatrix schedules hold xor ops only: {op}")
        nodes.append(nodes[op[1]] ^ nodes[op[2]])
    return [nodes[o] if o >= 0 else zero() for o in outputs]


def apply_schedule_numpy(chunks: np.ndarray,
                         sched: "XorSchedule | tuple") -> np.ndarray:
    """The numpy tier: run the schedule over (..., s, C) uint8 host
    chunks (C % 4 == 0) -> (..., r, C)."""
    static = sched.static if isinstance(sched, XorSchedule) else sched
    _, s, r, _, _ = static
    c = chunks.shape[-1]
    if chunks.shape[-2] != s or chunks.dtype != np.uint8 or c % 4:
        raise ValueError(f"need (..., {s}, C) uint8 chunks with C % 4 == "
                         f"0, got {chunks.shape} {chunks.dtype}")
    words = np.ascontiguousarray(chunks).view(np.uint32)
    ins = [words[..., j, :] for j in range(s)]
    outs = eval_schedule(static, ins,
                         lambda: np.zeros_like(words[..., 0, :]))
    out = np.stack(outs, axis=-2)
    return np.ascontiguousarray(out).view(np.uint8).reshape(
        chunks.shape[:-2] + (r, c))


def host_matrix_apply(chunks: np.ndarray, matrix: np.ndarray,
                      matrix_static: Optional[tuple] = None,
                      w: int = 8) -> np.ndarray:
    """Host-tier matrix apply: the identical XOR schedule when the probe
    prefers one, the regionops ground truth otherwise (byte-identical
    either way)."""
    if w == W:
        ms = matrix_static
        if ms is None:
            ms = tuple(tuple(int(x) for x in row)
                       for row in np.asarray(matrix))
        if chunks.shape[-1] % 4 == 0:
            sched = preferred_schedule(ms, W)
            if sched is not None:
                return apply_schedule_numpy(
                    np.ascontiguousarray(chunks), sched)
    from . import regionops
    words = regionops.words_view(np.ascontiguousarray(chunks), w)
    return regionops.matrix_encode(words, matrix, w).view(np.uint8)


# -- the CUDA kernels' programs -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowProgram:
    """The rows of the packet kernel (``csrc/gf2_bitmatrix.cu``) for some
    output packets of one product, before packing
    (``gf_kernels.packet_program``).

    ``loads`` are the input packets read, ``c = j * w + lb`` (packet lb
    of input chunk j); load k lands in slot k.  A row is ``(leaves, dst,
    store, refills)``: the slots it XORs, the slot that keeps the result
    for later rows (None: no later row reads it), the output ``(chunk,
    packet)`` it is stored to (None: not an output), and the loads whose
    slot no later row touches, so the next unit's packet may land there
    once this row has run.  The loads are numbered in the order their
    slots fall free, so the refills of the rows, in order, are 0, 1, 2,
    ...  A slot is free once its last reader has read it, and a row may
    write a slot it reads (reads come first)."""

    n_slots: int
    loads: Tuple[int, ...]
    rows: Tuple[tuple, ...]


def lower_rows(plan: Sequence[tuple], n_in: int) -> RowProgram:
    """Slots for a plan of rows ``(leaf nodes, node, store)``: nodes
    below ``n_in`` are input packets, ``node`` is the node a row makes
    (-1: none) and ``store`` the output ``(chunk, packet)`` it is stored
    to (None: none).  Inputs take slots in the order of their packets; a
    made node that a later row reads takes a freed slot (liveness)."""
    users: Dict[int, int] = {}
    for lv, _, _ in plan:
        for x in lv:
            users[x] = users.get(x, 0) + 1
    loads = tuple(sorted(x for x in users if x < n_in))
    slot = {x: k for k, x in enumerate(loads)}
    free: List[int] = []
    n_live = len(loads)
    last: Dict[int, int] = {}
    rows = []
    for r, (lv, node, store) in enumerate(plan):
        ids = tuple(slot[x] for x in lv)
        for x in lv:
            last[slot[x]] = r
            users[x] -= 1
            if users[x] == 0:
                free.append(slot[x])
        dst = None
        if node >= 0 and users.get(node):
            if free:
                slot[node] = free.pop()
            else:
                slot[node] = n_live
                n_live += 1
            dst = slot[node]
        rows.append((ids, dst, store))
    # number the loads in the order their slots fall free, so the rows
    # hand them to the next unit as one running sequence
    order = sorted(range(len(loads)), key=lambda k: last[k])
    slot_of = {k: i for i, k in enumerate(order)}
    renum = lambda x: slot_of.get(x, x)
    refills: List[List[int]] = [[] for _ in rows]
    for i, k in enumerate(order):
        refills[last[k]].append(i)
    return RowProgram(n_live, tuple(loads[k] for k in order), tuple(
        (tuple(map(renum, ids)), None if dst is None else renum(dst), store,
         tuple(ref)) for (ids, dst, store), ref in zip(rows, refills)))


@functools.lru_cache(maxsize=4096)
def row_program(static: tuple, w: int, outs: Optional[tuple] = None
                ) -> RowProgram:
    """The packet kernel's rows for output packets ``outs`` (default:
    all) of a pure-XOR schedule whose outputs are packets of w per
    chunk.

    Every node those outputs need that must exist (one of them, or a
    node read by two of the ops under them) is one row: the XOR of its
    leaves, the inputs and earlier such nodes under it, through the
    nodes read once, which are never made.  So a thread accumulates a
    row in a register and reads each leaf once, instead of reading two
    slots and writing one per XOR.  Nodes that no output of ``outs``
    needs are not made, so the outputs of one row group of the kernel
    make exactly the closure they read (a temp two groups need is made
    in both)."""
    _, n_in, n_out, ops, outputs = static
    for op in ops:
        if op[0] != "xor":
            raise ValueError(f"bitmatrix schedules hold xor ops only: {op}")
    outs = tuple(range(n_out)) if outs is None else tuple(outs)
    need: Set[int] = set()
    stack = [outputs[o] for o in outs if outputs[o] >= n_in]
    while stack:
        n = stack.pop()
        if n not in need:
            need.add(n)
            stack.extend(x for x in ops[n - n_in][1:3] if x >= n_in)
    reads: Dict[int, int] = {}
    for n in need:
        for x in ops[n - n_in][1:3]:
            reads[x] = reads.get(x, 0) + 1
    rows_of: Dict[int, List[int]] = {}
    for row in outs:
        rows_of.setdefault(outputs[row], []).append(row)
    kept = set(n for n in need if reads.get(n, 0) >= 2 or n in rows_of)
    leaves: Dict[int, List[int]] = {}
    for n in sorted(need):
        _, a, b = ops[n - n_in]
        leaves[n] = [x for y in (a, b) for x in (
            [y] if y < n_in or y in kept else leaves[y])]
    # a zero row per output of no node, a copy row per input output, a
    # row per made node, and a copy row for each store of a node past
    # its first.  Made nodes come as the outputs, in order, first need
    # them (each after the made nodes under it), so a temp is made just
    # before its first reader and holds its slot for less of the walk
    plan: List[tuple] = [((), -1, row) for row in rows_of.get(-1, [])]
    for node in range(n_in):
        plan += [((node,), -1, row) for row in rows_of.get(node, [])]
    done: Set[int] = set()
    for top in (outputs[o] for o in outs if outputs[o] >= n_in):
        stack = [(top, False)]
        while stack:
            n, ready = stack.pop()
            if n in done:
                continue
            if not ready:
                stack.append((n, True))
                stack += [(x, False) for x in reversed(leaves[n])
                          if x >= n_in and x not in done]
                continue
            done.add(n)
            rws = rows_of.get(n, [])
            plan.append((tuple(leaves[n]), n, rws[0] if rws else -1))
            plan += [((n,), -1, row) for row in rws[1:]]
    return lower_rows([(lv, node, None if row < 0 else divmod(row, w))
                       for lv, node, row in plan], n_in)


@functools.lru_cache(maxsize=4096)
def plain_row_program(bitmatrix_rows: tuple, n_in: int, w: int,
                      outs: Optional[tuple] = None) -> RowProgram:
    """The packet kernel's rows of the plain product for output packets
    ``outs`` (default: all): output packet o is the row of the input
    packets its mask ``bitmatrix_rows[o]`` sets, stored to packet o % w
    of chunk o // w; nothing is kept."""
    outs = tuple(range(len(bitmatrix_rows))) if outs is None else outs
    return lower_rows([(tuple(c for c in range(n_in)
                              if (int(bitmatrix_rows[o]) >> c) & 1),
                        -1, divmod(o, w)) for o in outs], n_in)


_UNARY = ("xt", "shl", "shr")


@functools.lru_cache(maxsize=1024)
def word_program(static: tuple) -> Tuple[int, tuple]:
    """``(n_slots, instructions)`` of a GF(2^8) schedule, in the form the
    CUDA word kernel runs: the counterpart of :func:`row_program` for
    schedules with ``xt`` / ``shl`` / ``shr`` planes.

    A node is made (computed by one instruction) when it is an output,
    is read by two ops, or is read by a unary op (whose operand must be
    a value); every other node is folded into its one reader.  An
    instruction XORs its leaves in a register.  A leaf is
    ``(from_memory, index, op, sh)``: input chunk ``index``, read from
    memory (an input read twice is read twice, from the cache), or slot
    ``index``, with the unary ``op`` ("id", "xt", "shl", "shr"; shift
    ``sh``) applied as it is read — so a plane read once, such as the
    ring schedule's ``shl``/``shr`` of an input, is never stored.  An
    instruction is ``(leaves, dst, row)``: the slot that keeps the
    result for later instructions (None: not kept) and the output row it
    is stored to (None: not an output).  Zero leaves make an all-zero
    row; one identity leaf of an input or a kept node is a copy.  Slots
    are assigned by liveness: a slot is free once its last reader has
    read it, and an instruction may write the slot it reads (reads come
    first)."""
    _, n_in, n_out, ops, outputs = static
    n_nodes = n_in + len(ops)
    readers: List[List[int]] = [[] for _ in range(n_nodes)]
    for i, op in enumerate(ops):
        if op[0] not in _UNARY and op[0] != "xor":
            raise ValueError(f"unknown schedule op {op}")
        for x in (op[1:3] if op[0] == "xor" else op[1:2]):
            readers[x].append(n_in + i)
    rows_of: Dict[int, List[int]] = {}
    for row, node in enumerate(outputs):
        rows_of.setdefault(node, []).append(row)

    def is_xor(n: int) -> bool:
        return n >= n_in and ops[n - n_in][0] == "xor"

    made = [n for n in range(n_in, n_nodes)
            if n in rows_of or len(readers[n]) >= 2
            or (len(readers[n]) == 1 and not is_xor(readers[n][0]))]
    kept = set(made)
    # the leaves of each node as its reader sees it: (node, op, sh)
    leaves: Dict[int, List[tuple]] = {}
    for i, op in enumerate(ops):
        n = n_in + i
        if op[0] == "xor":
            leaves[n] = [leaf for y in op[1:3] for leaf in (
                [(y, "id", 0)] if y < n_in or y in kept else leaves[y])]
        else:
            leaves[n] = [(op[1], op[0], op[2] if len(op) > 2 else 0)]
    plan: List[Tuple[List[tuple], int, int]] = []   # (leaves, node, row)
    for row in rows_of.get(-1, []):
        plan.append(([], -1, row))
    for node in range(n_in):
        for row in rows_of.get(node, []):
            plan.append(([(node, "id", 0)], -1, row))
    for n in made:
        rws = rows_of.get(n, [])
        plan.append((leaves[n], n, rws[0] if rws else -1))
        for row in rws[1:]:
            plan.append(([(n, "id", 0)], -1, row))
    users = [0] * n_nodes
    for lv, _, _ in plan:
        for x, _, _ in lv:
            users[x] += 1
    slot: Dict[int, int] = {}
    free: List[int] = []
    n_live = 0
    instrs = []
    for lv, node, row in plan:
        ids = tuple((x < n_in, x if x < n_in else slot[x], op, sh)
                    for x, op, sh in lv)
        for x, _, _ in lv:
            users[x] -= 1
            if users[x] == 0 and x >= n_in:
                free.append(slot[x])
        dst = None
        if node >= 0 and users[node]:
            if free:
                slot[node] = free.pop()
            else:
                slot[node] = n_live
                n_live += 1
            dst = slot[node]
        instrs.append((ids, dst, None if row < 0 else row))
    return n_live, tuple(instrs)


__all__ = [
    "BITMATRIX_MIN_SAVINGS", "CSE_MAX_TEMPS", "CSE_TOPK",
    "DEFAULT_MAX_ONES", "XOR_DENSE_CUTOVER", "XorSchedule",
    "apply_schedule_numpy", "build_schedule", "dense_vpu_cost",
    "eval_schedule", "eval_schedule_u8", "host_matrix_apply",
    "naive_bitmatrix_xors", "preferred_schedule",
    "RowProgram", "lower_rows", "plain_row_program",
    "probe_bitmatrix_schedule", "probe_schedule", "row_program",
    "tuned_cse_topk", "tuned_xor_cutover", "word_program",
    "xtime_words_xor",
]
