"""GF(2^w) matrix and GF(2) bitmatrix applies on the card: the kernel
wrappers and the engine-selection table.

Counterpart of the kernel part of ``ceph_tpu/ops/pallas_gf.py`` and of
the MXU path of ``ceph_tpu/ops/xla_ops.py``.  Four hand-written CUDA
sources stand in for nine TPU kernels and the MXU path, behind eleven
wrappers:

- ``csrc/gf8_matrix.cu`` (GF(2^w) matrix, field width a template
  parameter; the doubling chain per output row over inputs staged in
  shared memory, every row in one launch; the row program,
  :func:`dense_program`, is kernel data cached per matrix):

  - :func:`apply_matrix_cuda` — w=8 bytes layout, (..., s, C) uint8 ->
    (..., r, C); any C (a tail that is not a whole 16-byte vector is
    masked).  Replaces ``apply_matrix_pallas``.
  - :func:`apply_matrix_cuda_packed` — w=8 packed layout, (..., s, R,
    128) uint32 -> (..., r, R, 128), the public resident-word shape of
    the reference.  Replaces ``apply_matrix_pallas_packed``.
  - :func:`apply_matrix_cuda_words` — w=16/32, (..., s, Ce)
    uint16/uint32 word views -> (..., r, Ce).  Replaces
    ``apply_matrix_pallas_words``.
  - :func:`apply_matrix_cuda_ragged` — w=8 over a page pool (P, s, page)
    uint8 under a (P,) activity mask -> (P, r, page), dead pages zero
    (the dense kernel with a mask pointer; a dead page reads nothing).
    Replaces ``apply_matrix_pallas_ragged``.
  - :func:`apply_matrix_cuda_packed_ragged` — the same on a (P, s, R,
    128) uint32 pool.  Replaces ``apply_matrix_pallas_packed_ragged``.

  Any table size (:func:`matrix_kernel_fits`): up to BY_VALUE_MAX_PROG
  words the row program is a kernel parameter, above that a device
  buffer cached per matrix (clay's 64 x 704 repair composites).

- ``csrc/gf2_bitmatrix.cu`` (jerasure packet layout, any packetsize; one
  kernel that runs "rows", each the XOR of a list of slots; the rows are
  a program of int32 words, :func:`packet_program`, uploaded once per
  (matrix, row groups) and staged by each block into shared memory;
  :func:`packet_plan` picks the unit, the block,
  the row groups on grid y and one persistent wave):

  - :func:`apply_bitmatrix_cuda` — the plain product, one row per output
    packet.  Replaces ``apply_bitmatrix_pallas``.
  - :func:`apply_bitmatrix_xor_cuda` — the product through a CSE
    schedule (``ops/xor_schedule.py``): one row per node the schedule
    must make, shared temps XORed once.  Replaces
    ``apply_bitmatrix_xor_pallas``.

- ``csrc/gf8_xor_schedule.cu`` (a GF(2^8) matrix through its XOR
  schedule, ``xt`` / ``shl`` / ``shr`` / ``xor`` on SWAR words; the
  instructions of ``xor_schedule.word_program``):

  - :func:`apply_matrix_xor_cuda` — bytes layout, (..., s, C) uint8, C
    % 4 == 0.  Replaces ``apply_matrix_xor_pallas``.
  - :func:`apply_matrix_xor_cuda_packed` — packed layout.  Replaces
    ``apply_matrix_xor_packed``.

- ``csrc/gf8_column_walk.cu`` (a GF(2^8) matrix as a sparse column
  walk: each input column's doubling chain once, folded into the rows
  its nonzero coefficients feed; the column-compressed matrix,
  :func:`walk_data`, is kernel data cached per matrix):

  - :func:`apply_matrix_mxu_cuda` — bytes layout.  Replaces
    ``ceph_tpu/ops/xla_ops.py::apply_matrix_mxu`` (the reference's MXU
    tier; the name of the row stays).
  - :func:`apply_matrix_mxu_cuda_packed` — packed layout (the same
    kernel on the words' uint8 view).

  Any r (:func:`walk_row_tile`: a matrix of more rows than one tile's
  accumulators hold is walked in row tiles).

A uint8 buffer read as little-endian uint32 is already the packed
layout (and a uint16/uint32 word view is the same bytes), so the matrix
wrappers hand one kernel the same bytes and differ only in how they
describe them; the two bitmatrix wrappers hand one kernel different
rows.  The matrix or schedule is kernel data, never code: one build
serves every matrix.  On a CPU tensor a wrapper runs the plain
torch version (``ops/torch_ops.py``), because that is where the caller
put the tensor; on a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in ``.launches``; every kernel
module's counts are read together through ``ops/launches.py``.

:func:`select_matrix_engine` keeps the reference's table reduced to the
rows this package has (xor / mxu / cuda / torch / numpy); :func:`apply_matrix_best`,
:func:`apply_matrix_packed_best` and :func:`apply_bitmatrix_best`
dispatch through it.  :func:`select_ragged_engine` projects it onto the
ragged tiers (cuda / mask / numpy) for :func:`apply_matrix_best_ragged`
and :func:`apply_matrix_packed_best_ragged`, the paged serving path's
ops entries.  Those four are the supervised seams ``ops.apply_matrix``,
``ops.apply_matrix_packed``, ``ops.apply_matrix_ragged`` and
``ops.apply_matrix_packed_ragged`` (``ops/supervisor.py``): each has a
rebuild that re-runs the selection under the live tier and, for w=8, a
numpy twin.  A forced torch or numpy tier, and the supervisor's live
demotion, apply to CPU tensors only: a CUDA tensor launches its kernel
or raises (``ops/fallback.py``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import regionops
from ..parallel import plane as _planes
from ._build import load
from .fallback import FallbackPolicy, global_policy
from .launches import device_and_stream, launch_counts, register, \
    reset_launch_counts
from .supervisor import _tls as _seam_tls
from .supervisor import global_supervisor
from .torch_ops import WORD_DTYPE, StaticMatrix, apply_bitmatrix_torch, \
    apply_bitmatrix_xor_torch, apply_matrix_packed_ragged_torch, \
    apply_matrix_ragged_torch, apply_matrix_torch, apply_matrix_walk_torch, \
    apply_matrix_xor_torch, column_walk_data, mask_pages
from .xor_schedule import RowProgram, XorSchedule, host_matrix_apply, \
    plain_row_program, preferred_schedule, probe_schedule, row_program, \
    word_program
from ..telemetry import metrics as tel
from ..telemetry import spans
from ..tune import table as _tune
from ..utils.errors import KernelLaunchError
from ..utils.shard import shard_batch

LANE = 128             # words per row of the packed layout
PACKED_ROW_BYTES = 4 * LANE

# the dense cost model of the xtime/XOR walk (ceph_tpu's
# ops/xor_schedule.py::dense_vpu_cost): one xtime is 5 integer ops
DENSE_XT_COST = 5

# the least sm_90 instructions of one SWAR xtime per 32-bit word.  w=8
# and w=16: AND with the elements' top bits, one IMAD.HI by the feedback
# shifted up by 32 - (w - 1) (the reduction term), SHL, and one LOP3
# computing ((v << 1) & ~carries) ^ term — 4.  w=32: SHL, SHF.R.S32.HI
# for the sign mask and one LOP3 computing (v << 1) ^ (mask & 0x400007)
# — 3.
SM90_XT_COST = {8: 4, 16: 4, 32: 3}


def dense_op_count(matrix_t) -> int:
    """Integer ops per 32-bit word position of the dense xtime/XOR walk:
    per input column, the doubling chain up to its highest used bit
    plus one XOR per set coefficient bit."""
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


def sm90_op_count(matrix_t, w: int = 8) -> int:
    """Integer instructions per 32-bit word position that the GF(2^w)
    xtime/XOR walk needs at least on sm_90; the ops side of the kernel's
    bound.  Each column's doubling chain costs SM90_XT_COST[w] per xtime,
    and a row's n planes fold in ceil((n - 1) / 2) three-input XORs
    (LOP3), not n."""
    xt_cost = SM90_XT_COST[w]
    r = len(matrix_t)
    s = len(matrix_t[0])
    cost = 0
    for j in range(s):
        top = max(int(matrix_t[i][j]).bit_length() for i in range(r))
        if top > 1:
            cost += xt_cost * (top - 1)
    for row in matrix_t:
        planes = sum(int(c).bit_count() for c in row)
        cost += planes // 2
    return cost


def sm90_row_op_count(matrix_t, w: int = 8) -> int:
    """The same count for the doubling chain per output row (Horner:
    out_i = (...(y_i,top-1 * x) ^ ...) ^ y_i,0, y_i,t the XOR of the
    inputs whose coefficient has bit t set): each row's chain costs
    SM90_XT_COST[w] per xtime below its highest bit, and its set bits
    fold two per LOP3."""
    xt_cost = SM90_XT_COST[w]
    cost = 0
    for row in matrix_t:
        top = max(int(c).bit_length() for c in row)
        if top > 1:
            cost += xt_cost * (top - 1)
        cost += sum(int(c).bit_count() for c in row) // 2
    return cost


def sm90_op_floor(matrix_t, w: int = 8) -> int:
    """The least integer instructions per 32-bit word position of a
    GF(2^w) matrix apply on sm_90: the cheaper of the chain per input
    column (``sm90_op_count``) and the chain per output row
    (``sm90_row_op_count``); the ops side of the function's bound."""
    return min(sm90_op_count(matrix_t, w), sm90_row_op_count(matrix_t, w))


def bitmatrix_op_count(bitmatrix_rows) -> int:
    """INT32 instructions per 32-bit word position that the plain packet
    product needs at least on sm_90: each output row's n ones fold in
    ceil((n - 1) / 2) three-input XORs (LOP3)."""
    return sum(int(m).bit_count() // 2 for m in bitmatrix_rows)


def schedule_op_count(sched_static) -> int:
    """The same count for a pure-XOR schedule: a node that is an output
    or is read twice must exist; each such node folds the inputs and
    existing nodes under it (through nodes read once) in
    ceil((leaves - 1) / 2) LOP3s."""
    _, n_in, _, ops, outputs = sched_static
    reads = [0] * (n_in + len(ops))
    for _, a, b in ops:
        reads[a] += 1
        reads[b] += 1
    kept = set(o for o in outputs if o >= n_in)
    kept.update(n for n in range(n_in, len(reads)) if reads[n] >= 2)
    leaves = [1] * (n_in + len(ops))
    cost = 0
    for i, (_, a, b) in enumerate(ops):
        node = n_in + i
        leaves[node] = sum(1 if x < n_in or x in kept else leaves[x]
                           for x in (a, b))
        if node in kept:
            cost += leaves[node] // 2
    return cost


def xor_schedule_op_count(sched_static) -> int:
    """The same count for a GF(2^8) schedule, as the word kernel's
    instructions (``xor_schedule.word_program``) make its nodes: each
    instruction folds its leaves in ceil((leaves - 1) / 2) LOP3s; an
    ``xt`` costs SM90_XT_COST[8] and a byte-local shift 2 (shift + AND),
    once each."""
    cost = 0
    for leaves, _, _ in word_program(sched_static)[1]:
        cost += len(leaves) // 2
        for _, _, op, _ in leaves:
            cost += SM90_XT_COST[8] if op == "xt" else (
                2 if op in ("shl", "shr") else 0)
    return cost


# -- the GF(2^w) matrix kernel -----------------------------------------------

# csrc/gf8_matrix.cu's limits, checked against the library when it loads:
# the int32 row-program words it takes as a by-value kernel parameter
# (GF_PROG_MAX; a longer program goes to the table variant through a
# device buffer), the output rows of a row block (GF_ROWS_MAX), the
# threads of a block, one 16-byte unit each (GF_UNITS), and the input
# columns of one staged tile (GF_TILE_COLS: a block's two buffers of
# tiles and their zero slots fill 48 KB)
BY_VALUE_MAX_PROG = 960
DENSE_ROWS_MAX = 8
DENSE_UNITS = 128
DENSE_TILE_COLS = 11
# the largest table the kernel takes: its row program (at most
# r * s * (2w + 6) + 3 words) is indexed with 32-bit ints
MAX_TABLE_COEF = 1 << 24

# the library, set on first use; the per-call path reads it without a lock
_lib_state = None


def _lib():
    global _lib_state
    if _lib_state is None:
        lib = load("gf8_matrix")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf8_matrix_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, vp, vp, vp, i, vp]
        lib.gf8_matrix_apply.restype = i
        lib.gfw_matrix_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, i, vp, vp, i, vp]
        lib.gfw_matrix_apply.restype = i
        lib.gf8_matrix_plan.argtypes = [ll, ll, i, i, i, i,
                                        ctypes.POINTER(i)]
        lib.gf8_matrix_plan.restype = i
        lib.gf8_geometry.argtypes = [i, i, ctypes.POINTER(i)]
        lib.gf8_geometry.restype = None
        lib.gf8_max_prog.restype = i
        lib.gf8_error_string.argtypes = [i]
        lib.gf8_error_string.restype = ctypes.c_char_p
        if lib.gf8_max_prog() != BY_VALUE_MAX_PROG:
            raise KernelLaunchError(
                f"the GF(2^w) matrix kernel takes {lib.gf8_max_prog()} "
                f"program words by value; the wrapper plans for "
                f"{BY_VALUE_MAX_PROG}")
        got = (ctypes.c_int * 4)()
        for r, s in itertools.product(range(1, 4 * DENSE_ROWS_MAX + 2),
                                      (1, DENSE_TILE_COLS,
                                       DENSE_TILE_COLS + 1)):
            lib.gf8_geometry(r, s, got)
            if tuple(got) != dense_geometry(r, s):
                raise KernelLaunchError(
                    f"the GF(2^w) matrix kernel lays out ({r}, {s}) as "
                    f"{tuple(got)}; the wrapper plans "
                    f"{dense_geometry(r, s)}")
        _lib_state = lib
    return _lib_state


def matrix_kernel_fits(r: int, s: int, w: int = 8) -> bool:
    """The dense GF(2^w) kernel's capacity rule, a pure function of the
    shape: any (r, s) table up to MAX_TABLE_COEF coefficients.  Its row
    program travels as a kernel parameter up to BY_VALUE_MAX_PROG words,
    above that through a device buffer."""
    return w in SM90_XT_COST and r >= 1 and s >= 1 \
        and r * s <= MAX_TABLE_COEF and dense_geometry(r, s)[0] <= 65535


@functools.lru_cache(maxsize=512)
def _matrix_info(matrix_t, w: int = 8) -> tuple[int, int]:
    """(r, s) of a GF(2^w) coefficient table; raises on a ragged or
    empty table or a coefficient outside [0, 2^w).  Cached: a code
    applies the same few matrices on every call (its encode matrix and
    one decode matrix per pattern)."""
    r = len(matrix_t)
    s = len(matrix_t[0]) if r else 0
    if r == 0 or s == 0 or any(len(row) != s for row in matrix_t):
        raise ValueError("matrix must be a non-empty (r, s) table")
    if any(not 0 <= int(x) < (1 << w) for row in matrix_t for x in row):
        raise ValueError(f"GF(2^{w}) coefficients must lie in "
                         f"[0, {(1 << w) - 1}]")
    return r, s


def dense_geometry(r: int, s: int) -> tuple[int, int, int, int]:
    """The dense kernel's launch geometry, a pure function of the shape
    (as csrc/gf8_matrix.cu's gf_geometry): (row blocks, rows per block,
    units per block, input columns per staged tile).  Rows go in
    balanced blocks of at most DENSE_ROWS_MAX when the s columns fit one
    tile, else one row per block (a block stages only its rows' nonzero
    columns); a block is DENSE_UNITS threads, each thread one unit and
    every row of its row block."""
    if r < 1 or s < 1:
        raise ValueError(f"a ({r}, {s}) matrix")
    nrb = r if s > DENSE_TILE_COLS else -(-r // DENSE_ROWS_MAX)
    return nrb, -(-r // nrb), DENSE_UNITS, DENSE_TILE_COLS


def _pairs(slots, zero: int) -> list[int]:
    """A level's tile slots as the kernel folds them, two at a time: the
    byte offsets of their 16-byte units (slot * DENSE_UNITS * 16), an
    odd one paired with the zero slot ``zero``."""
    slots = [int(c) for c in slots]
    if len(slots) % 2:
        slots.append(zero)
    return [c * DENSE_UNITS * 16 for c in slots]


@functools.lru_cache(maxsize=1024)
def dense_program(matrix_t, w: int = 8) -> np.ndarray:
    """The dense kernel's data for a static GF(2^w) table: its row
    program, int32, built once per matrix (csrc/gf8_matrix.cu describes
    the layout).  Each row block's nonzero columns, in tiles of
    ``dense_geometry(r, s)[3]``; per row and tile the highest coefficient
    bit, then from it down to bit 0 the pairs of tile slots whose
    coefficient has that bit set (``_pairs``; the zero slot follows the
    widest tile, at min(s, tile columns))."""
    r, s = _matrix_info(matrix_t, w)
    nrb, rows, _, tile_cols = dense_geometry(r, s)
    zero = min(s, tile_cols)
    m = np.array([[int(v) for v in row] for row in matrix_t],
                 dtype=np.int64)
    head = [0, nrb, rows] + [0] * (nrb + r)
    tile_streams, row_streams = [], [[] for _ in range(r)]
    for rb in range(nrb):
        block = range(rb * rows, min(r, (rb + 1) * rows))
        cols = np.flatnonzero(m[block.start:block.stop].any(axis=0))
        tiles = [cols[k:k + tile_cols]
                 for k in range(0, len(cols), tile_cols)]
        stream = [len(tiles)]
        for tile in tiles:
            stream += [len(tile)] + [int(j) for j in tile]
            for i in block:
                sub = m[i, tile]
                top = int(sub.max()).bit_length() if len(sub) else 0
                prog = [top]
                for t in range(top - 1, -1, -1):
                    pairs = _pairs(np.flatnonzero((sub >> t) & 1), zero)
                    prog += [len(pairs) // 2] + pairs
                row_streams[i] += prog
        tile_streams.append(stream)
    flat = head
    for rb, stream in enumerate(tile_streams):
        flat[3 + rb] = len(flat)
        flat += stream
    for i, stream in enumerate(row_streams):
        flat[3 + nrb + i] = len(flat)
        flat += stream
    flat[0] = len(flat)
    return np.asarray(flat, dtype=np.int32)


def program_op_count(matrix_t, w: int = 8) -> int:
    """Integer instructions per 32-bit word position that the dense
    kernel spends on its row program (``dense_program``): per row and
    tile, SM90_XT_COST[w] per xtime below the tile's top bit, one
    three-input XOR per pair of a level's set bits (an odd one paired
    with zero), and the XOR of the tile's partial row into the
    accumulator."""
    prog = dense_program(_static(matrix_t), w)
    nrb, r = int(prog[1]), len(matrix_t)
    cost = 0
    for i in range(r):
        rb = i // int(prog[2])
        ntiles = int(prog[int(prog[3 + rb])])
        at = int(prog[3 + nrb + i])
        for _ in range(ntiles):
            top = int(prog[at])
            at += 1
            cost += SM90_XT_COST[w] * max(top - 1, 0) + 1
            for _ in range(top):
                n = int(prog[at])
                cost += n
                at += 1 + 2 * n
    return cost


@functools.lru_cache(maxsize=256)
def _device_program(matrix_t, w: int, device: torch.device) -> torch.Tensor:
    """A row program above the by-value limit, on ``device``: uploaded
    once per matrix, then kernel data."""
    tel.note_kernel_setup()
    return torch.from_numpy(dense_program(matrix_t, w)).to(device)


def dense_plan(batch: int, nbytes: int, matrix_t,
               device: torch.device) -> tuple[int, int, int]:
    """The grid the dense kernel launches for ``batch`` stripes of
    ``nbytes``-byte chunks of the w=8 ``matrix_t`` on ``device``: (blocks
    of DENSE_UNITS 16-byte units of a chunk, blocks along the stripes,
    row blocks).  The stripes spread evenly over at most one wave of the
    card beside the other two, so below a wave each block takes one
    stripe.  A query; it launches nothing."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    lib = _lib()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    grid = (ctypes.c_int * 3)()
    table = int(len(dense_program(static, 8)) > BY_VALUE_MAX_PROG)
    err = lib.gf8_matrix_plan(batch, nbytes, r, s, table, index, grid)
    if err:
        raise KernelLaunchError(
            f"dense_plan failed: CUDA error {err} "
            f"({lib.gf8_error_string(err).decode()})", code=err)
    return tuple(grid)


def _merged_batch(x: torch.Tensor, nlead: int, elem: int
                  ) -> tuple[int, int]:
    """(batch, batch stride in bytes) of the leading ``nlead`` dims,
    which must collapse to one strided dimension."""
    sizes = [n for n in x.shape[:nlead]]
    strides = [st for st in x.stride()[:nlead]]
    dims = [(n, st) for n, st in zip(sizes, strides) if n != 1]
    for (n0, st0), (n1, st1) in zip(dims, dims[1:]):
        if st0 != st1 * n1:
            raise ValueError(
                f"leading dims {tuple(sizes)} with strides "
                f"{tuple(strides)} do not merge into one batch; pass a "
                f"contiguous tensor")
    batch = math.prod(sizes) if sizes else 1
    return batch, (dims[-1][1] * elem if dims else 0)


def _launch(x: torch.Tensor, out: torch.Tensor, batch: int, nbytes: int,
            in_strides: tuple[int, int], out_strides: tuple[int, int],
            matrix_t, w: int = 8, mask: torch.Tensor | None = None) -> int:
    """Launch the GF(2^w) matrix kernel on the current stream for every
    row of the static table ``matrix_t``; return how many launches it
    took (one).  A row program above BY_VALUE_MAX_PROG words goes
    through its cached device buffer.  ``mask`` (w=8 only): a (batch,)
    uint8 page mask on the card, the ragged variant."""
    r, s = len(matrix_t), len(matrix_t[0])
    if not matrix_kernel_fits(r, s, w):
        raise ValueError(f"({r}, {s}) matrix exceeds the kernel's "
                         f"{MAX_TABLE_COEF} coefficients")
    lib = _lib()
    prog = dense_program(matrix_t, w)
    table = None
    if len(prog) > BY_VALUE_MAX_PROG:
        table = _device_program(matrix_t, w, x.device).data_ptr()
    args = (x.data_ptr(), out.data_ptr(), batch, nbytes, in_strides[0],
            in_strides[1], out_strides[0], out_strides[1], r, s)
    where = device_and_stream(x)
    if w == 8:
        err = lib.gf8_matrix_apply(
            *args, prog.ctypes.data, table,
            None if mask is None else mask.data_ptr(), *where)
    else:
        err = lib.gfw_matrix_apply(*args, w, prog.ctypes.data, table,
                                   *where)
    if err:
        raise KernelLaunchError(
            f"GF(2^{w}) matrix kernel failed: CUDA error {err} "
            f"({lib.gf8_error_string(err).decode()})", code=err)
    return 1


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors run the plain version)")


def apply_matrix_cuda(chunks: torch.Tensor, matrix_t) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to (..., s, C) uint8 chunks ->
    (..., r, C).  The chunk dimension may be strided (a survivor slice)
    as long as each chunk's bytes are contiguous."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s:
        raise ValueError(f"need (..., {s}, C) uint8 chunks, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    if chunks.device.type == "cpu":
        return apply_matrix_torch(chunks, matrix_t, 8)
    _check_cuda(chunks)
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    out = torch.empty(lead + (r, c), dtype=torch.uint8,
                      device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    # the launch first, then the count: ``_launch`` releases the GIL
    # (ctypes), and a count read before it loses another thread's
    # launches
    launched = _launch(
        chunks, out, batch, c, (bstride, chunks.stride(-2)), (r * c, c),
        static)
    apply_matrix_cuda.launches += launched
    return out


def apply_matrix_cuda_packed(words: torch.Tensor, matrix_t) -> torch.Tensor:
    """Packed-layout apply: (..., s, R, 128) uint32 -> (..., r, R, 128).
    Each chunk's (R, 128) words must be contiguous; the chunk dimension
    may be strided."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if words.dtype != torch.uint32 or words.dim() < 3 \
            or words.shape[-3] != s or words.shape[-1] != LANE:
        raise ValueError(f"need (..., {s}, R, {LANE}) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return pack_chunks(apply_matrix_torch(unpack_chunks(words),
                                              matrix_t, 8))
    _check_cuda(words)
    if words.stride(-1) != 1 or (words.shape[-2] > 1
                                 and words.stride(-2) != LANE):
        raise ValueError("each chunk's (R, 128) words must be contiguous")
    lead, rows = tuple(words.shape[:-3]), words.shape[-2]
    nbytes = rows * PACKED_ROW_BYTES
    out = torch.empty(lead + (r, nbytes), dtype=torch.uint8,
                      device=words.device)
    if out.numel() == 0:
        return pack_chunks(out)
    batch, bstride = _merged_batch(words, words.dim() - 3, 4)
    launched = _launch(
        words, out, batch, nbytes, (bstride, words.stride(-3) * 4),
        (r * nbytes, nbytes), static)
    apply_matrix_cuda_packed.launches += launched
    return pack_chunks(out)


def apply_matrix_cuda_words(words: torch.Tensor, matrix_t, w: int
                            ) -> torch.Tensor:
    """GF(2^16) / GF(2^32) apply on word views: (..., s, Ce) uint16 or
    uint32 -> (..., r, Ce), each element a little-endian field word.
    The chunk dimension may be strided as long as each chunk's words
    are contiguous."""
    if w not in (16, 32):
        raise ValueError(f"the word kernel takes w=16 or w=32, got w={w}")
    static = _static(matrix_t)
    r, s = _matrix_info(static, w)
    if words.dtype != WORD_DTYPE[w] or words.dim() < 2 \
            or words.shape[-2] != s:
        raise ValueError(f"need (..., {s}, Ce) {WORD_DTYPE[w]} words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return apply_matrix_torch(words, matrix_t, w)
    _check_cuda(words)
    if words.stride(-1) != 1:
        raise ValueError("chunk words must be contiguous (stride 1)")
    lead, ce = tuple(words.shape[:-2]), words.shape[-1]
    out = torch.empty(lead + (r, ce), dtype=words.dtype, device=words.device)
    if out.numel() == 0:
        return out
    el = w // 8
    batch, bstride = _merged_batch(words, words.dim() - 2, el)
    launched = _launch(
        words, out, batch, ce * el, (bstride, words.stride(-2) * el),
        (r * ce * el, ce * el), static, w)
    apply_matrix_cuda_words.launches += launched
    return out


def _page_mask(pool: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Validate a (P,) activity mask against a (P, ...) pool: raises
    ValueError when it lies on another device or has another length.
    Returns it as contiguous uint8 {0,1} page flags on the pool's
    device (no copy when it already is)."""
    if not isinstance(mask, torch.Tensor):
        raise ValueError(f"the mask must be a tensor, got {type(mask)}")
    if mask.device != pool.device:
        raise ValueError(f"mask on {mask.device}, pool on {pool.device}: "
                         f"the mask must lie on the pool's device")
    if mask.dim() != 1 or mask.shape[0] != pool.shape[0]:
        raise ValueError(f"mask {tuple(mask.shape)} does not fit a pool of "
                         f"{pool.shape[0]} pages")
    if mask.dtype != torch.uint8:
        mask = (mask != 0).to(torch.uint8)
    return mask.contiguous()


def apply_matrix_cuda_ragged(pool: torch.Tensor, matrix_t,
                             mask: torch.Tensor) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to a page pool (P, s, page) uint8
    under a (P,) activity mask -> (P, r, page); a dead page (mask 0)
    reads nothing and comes back zero.  The mask lies on the pool's
    device, so one build serves every occupancy."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if pool.dtype != torch.uint8 or pool.dim() != 3 or pool.shape[1] != s:
        raise ValueError(f"need a (P, {s}, page) uint8 pool, got "
                         f"{tuple(pool.shape)} {pool.dtype}")
    mask = _page_mask(pool, mask)
    if pool.device.type == "cpu":
        return apply_matrix_ragged_torch(pool, matrix_t, mask)
    _check_cuda(pool)
    if pool.stride(-1) != 1:
        raise ValueError("page bytes must be contiguous (stride 1)")
    p, c = pool.shape[0], pool.shape[-1]
    out = torch.empty((p, r, c), dtype=torch.uint8, device=pool.device)
    if out.numel() == 0:
        return out
    launched = _launch(
        pool, out, p, c, (pool.stride(0), pool.stride(1)), (r * c, c),
        static, mask=mask)
    apply_matrix_cuda_ragged.launches += launched
    return out


def apply_matrix_cuda_packed_ragged(words: torch.Tensor, matrix_t,
                                    mask: torch.Tensor) -> torch.Tensor:
    """Packed-layout twin: a (P, s, R, 128) uint32 pool under a (P,)
    mask -> (P, r, R, 128), dead pages zero.  Each page chunk's (R, 128)
    words must be contiguous."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if words.dtype != torch.uint32 or words.dim() != 4 \
            or words.shape[1] != s or words.shape[-1] != LANE:
        raise ValueError(f"need a (P, {s}, R, {LANE}) uint32 pool, got "
                         f"{tuple(words.shape)} {words.dtype}")
    mask = _page_mask(words, mask)
    if words.device.type == "cpu":
        return apply_matrix_packed_ragged_torch(words, matrix_t, mask)
    _check_cuda(words)
    if words.stride(-1) != 1 or (words.shape[-2] > 1
                                 and words.stride(-2) != LANE):
        raise ValueError("each page chunk's (R, 128) words must be "
                         "contiguous")
    p, rows = words.shape[0], words.shape[-2]
    nbytes = rows * PACKED_ROW_BYTES
    out = torch.empty((p, r, nbytes), dtype=torch.uint8, device=words.device)
    if out.numel() == 0:
        return pack_chunks(out)
    launched = _launch(
        words, out, p, nbytes, (words.stride(0) * 4, words.stride(1) * 4),
        (r * nbytes, nbytes), static, mask=mask)
    apply_matrix_cuda_packed_ragged.launches += launched
    return pack_chunks(out)


# -- the GF(2) bitmatrix kernel -----------------------------------------------

# csrc/gf2_bitmatrix.cu's program format, checked against the library when
# it loads: a row's head holds its pairs of leaves (PACKET_PAIRS), three
# flags and the count of loads it hands on, its second word the stride to
# the next head, the case of its rest and its kept slot; a leaf or a kept
# result is a byte offset of 16 bytes a slot
PACKET_PAIRS = 0x3FF
PACKET_SINGLE = 1 << 10          # one more leaf
PACKET_KEEP = 1 << 11            # a later row reads the result
PACKET_STORE = 1 << 12           # the result is an output packet
PACKET_REFILL_SHIFT = 13         # loads handed on after the row, counted
PACKET_STRIDE = 0xFFF            # a row's 2nd word: words to the next head
PACKET_CASE_SHIFT = 12           # ... 2 * (pairs % 4) + odd leaf
PACKET_MAX_SLOTS = 0xFFFF // 16  # slots a 16-bit offset reaches
PACKET_MAX_THREADS = 256
# the plan's choices: units (bytes a thread walks at one offset), row
# groups, threads of a block; and the resident warps per SM the unit must
# leave room for
PACKET_UNITS = (16, 8, 4, 1)
PACKET_GROUPS = (1, 2, 4, 8)
PACKET_THREADS = (256, 128, 64, 32)
PACKET_MIN_WARPS = 8

_bitlib_state = None


def _bitlib():
    global _bitlib_state
    if _bitlib_state is None:
        lib = load("gf2_bitmatrix")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf2_packet_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, vp, i, vp, i, i, i, i, i,
            i, i, vp]
        lib.gf2_packet_apply.restype = i
        lib.gf2_device_limits.argtypes = [i, ctypes.POINTER(i)]
        lib.gf2_device_limits.restype = i
        lib.gf2_packet_format.argtypes = [ctypes.POINTER(i)]
        lib.gf2_packet_format.restype = None
        lib.gf2_error_string.argtypes = [i]
        lib.gf2_error_string.restype = ctypes.c_char_p
        got = (ctypes.c_int * 8)()
        lib.gf2_packet_format(got)
        want = (PACKET_PAIRS, PACKET_SINGLE, PACKET_KEEP, PACKET_STORE,
                PACKET_REFILL_SHIFT, PACKET_STRIDE, PACKET_CASE_SHIFT,
                PACKET_MAX_THREADS)
        if tuple(got) != want:
            raise KernelLaunchError(
                f"the packet kernel reads programs as {tuple(got)}; the "
                f"wrapper packs {want}")
        _bitlib_state = lib
    return _bitlib_state


def packet_groups(rw: int, groups: int) -> tuple:
    """The output packets of each of ``groups`` row groups: ``rw``
    outputs in balanced runs, in order."""
    if not 1 <= groups <= rw:
        raise ValueError(f"{groups} row groups of {rw} output packets")
    return tuple(tuple(range(g * rw // groups, (g + 1) * rw // groups))
                 for g in range(groups))


def _pack_group(prog: RowProgram, w: int) -> list[int]:
    """One row group's stream of the packet program (the layout is in
    csrc/gf2_bitmatrix.cu)."""
    flat = [len(prog.loads), len(prog.rows)]
    flat += [c // w | (c % w) << 16 for c in prog.loads]
    handed = 0
    for leaves, dst, store, refills in prog.rows:
        pairs, odd = divmod(len(leaves), 2)
        if pairs > PACKET_PAIRS:
            raise ValueError(f"a row of {len(leaves)} leaves")
        if refills != tuple(range(handed, handed + len(refills))):
            raise ValueError(f"a row hands on loads {refills} after "
                             f"{handed}: not in the order of the loads")
        handed += len(refills)
        flat += [0] * ((2 - len(flat)) % 4)       # leaves on 16 bytes
        size = 2 + len(leaves) + (store is not None)
        stride = size + (2 - len(flat) - size) % 4
        if stride > PACKET_STRIDE:
            raise ValueError(f"a row of {len(leaves)} leaves")
        flat.append(pairs | (PACKET_SINGLE if odd else 0)
                    | (0 if dst is None else PACKET_KEEP)
                    | (0 if store is None else PACKET_STORE)
                    | len(refills) << PACKET_REFILL_SHIFT)
        flat.append(stride | (2 * (pairs % 4) + odd) << PACKET_CASE_SHIFT
                    | (0 if dst is None else 16 * dst) << 16)
        flat += [16 * x for x in leaves]
        if store is not None:
            flat.append(store[0] | store[1] << 16)
    return flat


@functools.lru_cache(maxsize=2048)
def packet_program(kind: str, key: tuple, n_in: int, w: int,
                   groups: int) -> tuple[int, np.ndarray]:
    """(slots per thread, program) of the plain product of row masks
    ``key`` (kind "plain") or of the schedule ``key`` (kind "schedule")
    over ``n_in`` input packets, its outputs split into ``groups`` row
    groups (:func:`packet_groups`): the packet kernel's data, int32 words
    padded to whole 16-byte words (csrc/gf2_bitmatrix.cu has the
    layout).  Built once per (matrix, groups)."""
    if kind == "plain":
        rw = len(key)
        progs = [plain_row_program(key, n_in, w, outs)
                 for outs in packet_groups(rw, groups)]
    else:
        rw = key[2]
        progs = [row_program(key, w, outs)
                 for outs in packet_groups(rw, groups)]
    n_slots = max(max(p.n_slots for p in progs), 1)
    if n_slots > PACKET_MAX_SLOTS:
        raise ValueError(f"{n_slots} slots per thread; the kernel's "
                         f"offsets reach {PACKET_MAX_SLOTS}")
    flat = [0, groups] + [0] * groups
    for g, prog in enumerate(progs):
        flat[2 + g] = len(flat)
        flat += _pack_group(prog, w)
    flat += [0] * (-len(flat) % 4)
    flat[0] = len(flat)
    return n_slots, np.asarray(flat, dtype=np.uint32).view(np.int32)


@functools.lru_cache(maxsize=2048)
def _packet_data(kind: str, key: tuple, n_in: int, w: int, groups: int,
                 device: torch.device
                 ) -> tuple[np.ndarray, torch.Tensor, tuple[int, int]]:
    """(program, its copy on ``device``, its room in shared memory,
    :func:`packet_stream_room`): the packet kernel's data for one
    (matrix, row groups), made once (one kernel setup)."""
    prog = packet_program(kind, key, n_in, w, groups)[1]
    table = torch.from_numpy(prog).to(device)
    tel.note_kernel_setup()
    return prog, table, packet_stream_room(prog)


@functools.lru_cache(maxsize=64)
def _device_limits(index: int) -> tuple[int, int, int, int]:
    """(SMs, shared memory per SM, per-block reserve, most per block) of
    CUDA device ``index``."""
    lib = _bitlib()
    got = (ctypes.c_int * 4)()
    err = lib.gf2_device_limits(index, got)
    if err:
        raise KernelLaunchError(
            f"gf2_device_limits failed: CUDA error {err} "
            f"({lib.gf2_error_string(err).decode()})", code=err)
    return tuple(got)


class PacketPlan(NamedTuple):
    """One launch of the packet kernel: the unit in bytes, threads per
    block, blocks per row group (grid x), row groups (grid y) and 16-byte
    words per row of slots (the odd pitch; a thread's slots take pitch x
    unit bytes)."""
    unit: int
    threads: int
    blocks: int
    groups: int
    pitch: int


def _packet_block(n_slots: int, unit: int, extra: int,
                  limits) -> tuple[int, int]:
    """(threads per block, threads resident per SM) of the packet kernel
    with ``n_slots`` slots of ``unit`` bytes per thread and ``extra``
    bytes of program in shared memory: the block of PACKET_THREADS that
    keeps the most threads on an SM (the larger on a tie); (0, 0) when
    no block fits."""
    _, smem_sm, reserved, most = limits
    best = (0, 0)
    for t in PACKET_THREADS:
        block = extra + t * (n_slots | 1) * unit
        if block > most:
            continue
        resident = min(smem_sm // (block + reserved), 2048 // t, 32) * t
        if resident > best[1]:
            best = (t, resident)
    return best


def packet_plan(batch: int, nbytes: int, w: int, packetsize: int,
                widest: int, rw: int, slots, limits) -> PacketPlan:
    """The packet kernel's launch for ``batch`` stripes of ``nbytes``-byte
    chunks in packets of w x ``packetsize``, units of at most ``widest``
    bytes (what the pointers, strides and packet size allow), ``rw``
    output packets; ``slots(G)`` gives (slots per thread, program bytes
    in shared memory) of the program of G row groups; ``limits`` is
    (SMs, shared memory per SM, per-block reserve, most per block).

    The unit: the widest (bytes, not single bytes, where the packets
    allow) whose slots leave PACKET_MIN_WARPS warps per SM, else the
    narrowest.  The row groups: the fewest of PACKET_GROUPS (at most
    ``rw``) whose units fill one wave of the card.  The grid: one wave,
    each thread walking the units the wave leaves it."""
    widths = [u for u in PACKET_UNITS if u <= widest]
    if len(widths) > 1:
        widths = [u for u in widths if u > 1]
    n1, x1 = slots(1)
    unit = next((u for u in widths if _packet_block(n1, u, x1, limits)[1]
                 >= 32 * PACKET_MIN_WARPS), widths[-1])
    units = batch * (nbytes // (w * packetsize)) * (packetsize // unit)
    groups = 1
    for g in PACKET_GROUPS:
        if g > rw:
            break
        groups = g
        n, x = slots(g)
        if units * g >= _packet_block(n, unit, x, limits)[1] * limits[0]:
            break
    return _packet_grid(units, unit, groups, *slots(groups), limits)


def _packet_grid(units: int, unit: int, groups: int, n_slots: int,
                 extra: int, limits) -> PacketPlan:
    """The launch of ``units`` units of ``unit`` bytes per row group with
    ``n_slots`` slots a thread (``extra`` bytes of program in shared
    memory): the block of :func:`_packet_block`, and one wave of blocks
    over the ``groups`` row groups (fewer where the units run out), each
    thread walking the units the wave leaves it."""
    threads, resident = _packet_block(n_slots, unit, extra, limits)
    if threads == 0:
        raise ValueError(f"{n_slots} slots of {unit} bytes per thread do "
                         f"not fit a block of {PACKET_THREADS[-1]} threads")
    blocks = max(1, min(-(-units // threads),
                        resident // threads * limits[0] // groups))
    return PacketPlan(unit, threads, blocks, groups, n_slots | 1)


def _widest_unit(*vals: int) -> int:
    """The widest of PACKET_UNITS that divides every value (pointers,
    strides, the packet size)."""
    return next(u for u in PACKET_UNITS if all(v % u == 0 for v in vals))


def packet_stream_room(prog: np.ndarray) -> tuple[int, int]:
    """The shared memory, in int32 words, a block stages its row group's
    stream and its loads' 64-bit byte offsets into: the longest stream
    of the program, and 2 words a load of the group with the most, each
    rounded up to 16 bytes.  The kernel takes both and checks them."""
    groups = int(prog[1])
    starts = [int(prog[2 + g]) for g in range(groups)]
    ends = starts[1:] + [int(prog[0])]
    most = max(e - s for s, e in zip(starts, ends))
    loads = max(int(prog[s]) for s in starts)
    return 4 * -(-most // 4), 4 * -(-2 * loads // 4)


def packet_slots(kind: str, key: tuple, n_in: int, w: int):
    """``slots(G)`` for :func:`packet_plan`: the slots per thread of the
    program of G row groups, and the bytes of shared memory a block
    stages its row group's stream and loads' offsets into."""
    def slots(groups: int) -> tuple[int, int]:
        n, prog = packet_program(kind, key, n_in, w, groups)
        return n, 4 * sum(packet_stream_room(prog))
    return slots


@functools.lru_cache(maxsize=4096)
def _cached_plan(kind: str, key: tuple, n_in: int, w: int, batch: int,
                 nbytes: int, packetsize: int, widest: int,
                 device: torch.device) -> PacketPlan:
    rw = len(key) if kind == "plain" else key[2]
    return packet_plan(batch, nbytes, w, packetsize, widest, rw,
                       packet_slots(kind, key, n_in, w),
                       _device_limits(device.index))


def _check_packets(chunks: torch.Tensor, rw: int, w: int, packetsize: int
                   ) -> int:
    """Validate (..., s, C) uint8 chunks in packet layout for rw output
    packets per block; returns r = rw / w."""
    c = chunks.shape[-1] if chunks.dim() else 0
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 or c == 0 \
            or w < 1 or packetsize < 1 or c % (w * packetsize):
        raise ValueError(f"need (..., s, C) uint8 chunks with C a positive "
                         f"multiple of w*packetsize = {w * packetsize}, "
                         f"got {tuple(chunks.shape)} {chunks.dtype}")
    if rw == 0 or rw % w:
        raise ValueError(f"{rw} output packets are not a multiple of w={w}")
    return rw // w


def packet_launch_plan(chunks: torch.Tensor, r: int, w: int,
                       packetsize: int, kind: str, key: tuple, n_in: int,
                       out_ptr: int = 0) -> PacketPlan:
    """The plan the wrappers launch (..., s, C) chunks under into an
    output at ``out_ptr`` (default: an address on a 16-byte boundary,
    where torch's allocator puts every tensor): :func:`packet_plan`'s,
    cached per shape.  A query; it launches nothing."""
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    c = chunks.shape[-1]
    widest = _widest_unit(chunks.data_ptr(), out_ptr, bstride,
                          chunks.stride(-2), r * c, c, packetsize)
    return _cached_plan(kind, key, n_in, w, batch, c, packetsize, widest,
                        chunks.device)


def _packet_launch(chunks: torch.Tensor, r: int, w: int, packetsize: int,
                   kind: str, key: tuple, n_in: int,
                   plan: PacketPlan | None = None) -> torch.Tensor:
    """Run the packet kernel on (..., s, C) CUDA chunks -> (..., r, C):
    the program of ``kind`` / ``key`` (see :func:`packet_program`) under
    ``plan`` (default: :func:`packet_launch_plan`'s); one launch.  The
    wrappers count it; the timing tool's sweep passes other plans."""
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lib = _bitlib()
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    out = torch.empty(lead + (r, c), dtype=torch.uint8, device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    if plan is None:
        plan = packet_launch_plan(chunks, r, w, packetsize, kind, key, n_in,
                                  out.data_ptr())
    prog, table, room = _packet_data(kind, key, n_in, w, plan.groups,
                                     chunks.device)
    err = lib.gf2_packet_apply(
        chunks.data_ptr(), out.data_ptr(), batch, c, bstride,
        chunks.stride(-2), r * c, c, w, packetsize, prog.ctypes.data,
        prog.size, table.data_ptr(), *room, plan.unit, plan.threads,
        plan.blocks, plan.pitch, *device_and_stream(chunks))
    if err:
        raise KernelLaunchError(
            f"the packet kernel failed: CUDA error {err} "
            f"({lib.gf2_error_string(err).decode()})", code=err)
    return out


def apply_bitmatrix_cuda(chunks: torch.Tensor, bitmatrix_rows, w: int,
                         packetsize: int) -> torch.Tensor:
    """Packet-layout GF(2) bitmatrix apply: (..., s, C) uint8 -> (..., r,
    C), C a multiple of w * packetsize; bit (j*w + lb) of row mask
    (i*w + l) set means output packet (i, l) XORs input packet (j, lb).
    The chunk dimension may be strided (a survivor slice)."""
    rows = tuple(int(m) for m in bitmatrix_rows)
    r = _check_packets(chunks, len(rows), w, packetsize)
    s = chunks.shape[-2]
    if any(m < 0 or m >> (s * w) for m in rows):
        raise ValueError(f"bitmatrix rows reach past {s} input chunks")
    if chunks.device.type == "cpu":
        return apply_bitmatrix_torch(chunks, rows, w, packetsize)
    _check_cuda(chunks)
    out = _packet_launch(chunks, r, w, packetsize, "plain", rows, s * w)
    apply_bitmatrix_cuda.launches += 1
    return out


def apply_bitmatrix_xor_cuda(chunks: torch.Tensor, sched_static, w: int,
                             packetsize: int) -> torch.Tensor:
    """The same product through a pure-XOR schedule
    (``xor_schedule.probe_bitmatrix_schedule(rows, w).static``): CSE
    temps shared between output packets."""
    if not (isinstance(sched_static, tuple) and len(sched_static) == 5
            and sched_static[0] == "xorsched"):
        raise ValueError("need a schedule's static tuple")
    _, n_in, rw, _, _ = sched_static
    r = _check_packets(chunks, rw, w, packetsize)
    if n_in % w or n_in > chunks.shape[-2] * w:
        raise ValueError(f"schedule reads {n_in} packets, the chunks hold "
                         f"{chunks.shape[-2]} x {w}")
    if chunks.device.type == "cpu":
        return apply_bitmatrix_xor_torch(chunks, sched_static, w,
                                         packetsize)
    _check_cuda(chunks)
    out = _packet_launch(chunks, r, w, packetsize, "schedule", sched_static,
                         n_in)
    apply_bitmatrix_xor_cuda.launches += 1
    return out


# -- the GF(2^8) XOR-schedule kernel ------------------------------------------

# shared memory a block of csrc/gf8_xor_schedule.cu may use (GX_SMEM_BUDGET);
# checked against the library when it loads
XOR_SMEM_BUDGET = 96 * 1024
XOR_MIN_BLOCK = 32               # threads of 4-byte units, the smallest block
_XOR_OP = {"id": 0, "xt": 1, "shl": 2, "shr": 3}
_FROM_MEMORY = 1 << 28
_XOR_NONE = 0xFFFFFFFF           # a zero leaf; no slot kept; no row stored

_xorlib_state = None


def _xorlib():
    global _xorlib_state
    if _xorlib_state is None:
        lib = load("gf8_xor_schedule")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf8x_schedule_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, vp, i, i, i, i, vp]
        lib.gf8x_schedule_apply.restype = i
        lib.gf8x_error_string.argtypes = [i]
        lib.gf8x_error_string.restype = ctypes.c_char_p
        lib.gf8x_smem_budget.restype = i
        if lib.gf8x_smem_budget() != XOR_SMEM_BUDGET:
            raise KernelLaunchError(
                f"the XOR-schedule kernel has {lib.gf8x_smem_budget()} "
                f"bytes of shared memory; the wrapper plans for "
                f"{XOR_SMEM_BUDGET}")
        _xorlib_state = lib
    return _xorlib_state


@functools.lru_cache(maxsize=1024)
def pack_word_program(sched_static) -> tuple[int, int, np.ndarray]:
    """(slots, instructions, data) of a GF(2^8) schedule as the word
    kernel reads them: ``data`` is uint32, in 16-byte words — per
    instruction a header (groups, dst slot, output row, 0) and its
    leaves, 4 per group, padded with the zero leaf; then a pad word.  A
    leaf is ``index | sh << 20 | op << 24``, plus ``1 << 28`` for an
    input chunk read from memory (``xor_schedule.word_program``)."""
    n_slots, instrs = word_program(sched_static)
    flat = []
    for leaves, dst, row in instrs:
        codes = [idx | (sh << 20) | (_XOR_OP[op] << 24)
                 | (_FROM_MEMORY if mem else 0)
                 for mem, idx, op, sh in leaves]
        codes += [_XOR_NONE] * (-len(codes) % 4)
        flat += [len(codes) // 4, _XOR_NONE if dst is None else dst,
                 _XOR_NONE if row is None else row, 0] + codes
    flat += [_XOR_NONE] * 4
    return n_slots, len(instrs), np.asarray(flat, dtype=np.uint32)


def xor_program_fits(sched_static) -> bool:
    """The word kernel's capacity rule: the program and the slots of its
    smallest block (XOR_MIN_BLOCK threads of 4-byte units) fit
    XOR_SMEM_BUDGET bytes of shared memory."""
    n_slots, _, data = pack_word_program(sched_static)
    return (4 * data.size + (n_slots | 1) * XOR_MIN_BLOCK * 4
            <= XOR_SMEM_BUDGET)


@functools.lru_cache(maxsize=1024)
def _device_word_program(sched_static, device: torch.device
                         ) -> tuple[int, int, torch.Tensor]:
    """pack_word_program's data on ``device``: built once per schedule,
    then kernel data."""
    n_slots, n_instr, data = pack_word_program(sched_static)
    tel.note_kernel_setup()
    return n_slots, n_instr, torch.from_numpy(
        data.view(np.int32)).to(device)


def _check_sched(sched_static) -> tuple[int, int]:
    """(s, r) of a GF(2^8) schedule's static tuple."""
    if not (isinstance(sched_static, tuple) and len(sched_static) == 5
            and sched_static[0] == "xorsched"):
        raise ValueError("need a schedule's static tuple")
    return sched_static[1], sched_static[2]


def _launch_xor(fn, x: torch.Tensor, out: torch.Tensor, batch: int,
                nbytes: int, in_strides: tuple[int, int],
                out_strides: tuple[int, int], sched_static) -> None:
    """Run the word kernel on the current stream, counted on ``fn``."""
    if not xor_program_fits(sched_static):
        raise KernelLaunchError(
            f"{fn.__name__}: the schedule's program and slots exceed the "
            f"kernel's {XOR_SMEM_BUDGET} bytes of shared memory "
            f"(gf_kernels.xor_program_fits); the engine table routes "
            f"such a matrix to the dense kernel")
    if any(v % 4 for v in (x.data_ptr(), out.data_ptr(), *in_strides)):
        raise ValueError("the XOR-schedule kernel reads 4-byte words: "
                         "pointers and strides must be multiples of 4")
    lib = _xorlib()
    n_slots, n_instr, data = _device_word_program(sched_static, x.device)
    err = lib.gf8x_schedule_apply(
        x.data_ptr(), out.data_ptr(), batch, nbytes, *in_strides,
        *out_strides, data.data_ptr(), data.numel() // 4, n_instr, n_slots,
        *device_and_stream(x))
    if err:
        raise KernelLaunchError(
            f"{fn.__name__} failed: CUDA error {err} "
            f"({lib.gf8x_error_string(err).decode()})", code=err)
    fn.launches += 1


def apply_matrix_xor_cuda(chunks: torch.Tensor, sched_static
                          ) -> torch.Tensor:
    """Apply a GF(2^8) matrix through its XOR schedule
    (``xor_schedule.XorSchedule.static``): (..., s, C) uint8, C % 4 ==
    0 -> (..., r, C).  The chunk dimension may be strided (a survivor
    slice) as long as each chunk's bytes are contiguous."""
    s, r = _check_sched(sched_static)
    c = chunks.shape[-1] if chunks.dim() else 0
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s or c % 4:
        raise ValueError(f"need (..., {s}, C) uint8 chunks with C % 4 == "
                         f"0, got {tuple(chunks.shape)} {chunks.dtype}")
    if chunks.device.type == "cpu":
        return apply_matrix_xor_torch(chunks, sched_static)
    _check_cuda(chunks)
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lead = tuple(chunks.shape[:-2])
    out = torch.empty(lead + (r, c), dtype=torch.uint8, device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    _launch_xor(apply_matrix_xor_cuda, chunks, out, batch, c,
                (bstride, chunks.stride(-2)), (r * c, c), sched_static)
    return out


def apply_matrix_xor_cuda_packed(words: torch.Tensor, sched_static
                                 ) -> torch.Tensor:
    """Packed-layout twin: (..., s, R, 128) uint32 -> (..., r, R, 128).
    Each chunk's (R, 128) words must be contiguous; the chunk dimension
    may be strided."""
    s, r = _check_sched(sched_static)
    if words.dtype != torch.uint32 or words.dim() < 3 \
            or words.shape[-3] != s or words.shape[-1] != LANE:
        raise ValueError(f"need (..., {s}, R, {LANE}) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return pack_chunks(apply_matrix_xor_torch(unpack_chunks(words),
                                                  sched_static))
    _check_cuda(words)
    if words.stride(-1) != 1 or (words.shape[-2] > 1
                                 and words.stride(-2) != LANE):
        raise ValueError("each chunk's (R, 128) words must be contiguous")
    lead, rows = tuple(words.shape[:-3]), words.shape[-2]
    nbytes = rows * PACKED_ROW_BYTES
    out = torch.empty(lead + (r, nbytes), dtype=torch.uint8,
                      device=words.device)
    if out.numel() == 0:
        return pack_chunks(out)
    batch, bstride = _merged_batch(words, words.dim() - 3, 4)
    _launch_xor(apply_matrix_xor_cuda_packed, words, out, batch, nbytes,
                (bstride, words.stride(-3) * 4), (r * nbytes, nbytes),
                sched_static)
    return pack_chunks(out)


# -- the GF(2^8) sparse column walk (the mxu row) -------------------------------

# words per block, warps per block and the accumulators' shared memory of
# csrc/gf8_column_walk.cu (CW_WORDS, CW_WARPS, CW_SMEM_BUDGET), checked
# against the library when it loads
WALK_WORDS, WALK_WARPS, WALK_SMEM_BUDGET = 64, 16, 64 * 1024

_walklib_state = None


def _walklib():
    global _walklib_state
    if _walklib_state is None:
        lib = load("gf8_column_walk")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf8cw_apply.argtypes = [
            vp, vp, vp, ll, ll, ll, ll, ll, ll, i, i, i, i, i, i, i, i, vp]
        lib.gf8cw_apply.restype = i
        lib.gf8cw_splits.argtypes = [ll, ll, i, i, i, i, i,
                                     ctypes.POINTER(i)]
        lib.gf8cw_splits.restype = i
        lib.gf8cw_error_string.argtypes = [i]
        lib.gf8cw_error_string.restype = ctypes.c_char_p
        for name in ("gf8cw_words", "gf8cw_warps", "gf8cw_smem_budget"):
            getattr(lib, name).restype = i
        have = (lib.gf8cw_words(), lib.gf8cw_warps(), lib.gf8cw_smem_budget())
        if have != (WALK_WORDS, WALK_WARPS, WALK_SMEM_BUDGET):
            raise KernelLaunchError(
                f"the column-walk kernel takes (words, warps, shared "
                f"memory) {have}; the wrapper plans for "
                f"{(WALK_WORDS, WALK_WARPS, WALK_SMEM_BUDGET)}")
        _walklib_state = lib
    return _walklib_state


def walk_row_tile(r: int) -> int:
    """The column-walk kernel's capacity rule, a pure function of r: the
    rows of one row tile, whose accumulators (rows x WALK_WORDS words)
    fit WALK_SMEM_BUDGET bytes of shared memory.  Any r is taken: a
    matrix of more rows is walked in ceil(r / walk_row_tile(r)) tiles,
    each re-walking its own columns (clay's (256, 512) encode is one)."""
    if r < 1:
        raise ValueError(f"a matrix of {r} rows")
    return min(r, WALK_SMEM_BUDGET // (4 * WALK_WORDS))


@functools.lru_cache(maxsize=256)
def walk_data(matrix_t) -> np.ndarray:
    """The column-walk kernel's data for a static table (built once per
    matrix: clay's 78 decode composites are 78 entries)."""
    return column_walk_data(matrix_t, walk_row_tile(len(matrix_t)))


@functools.lru_cache(maxsize=256)
def _device_walk(matrix_t, device: torch.device
                 ) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(walk_data on ``device``, its launch arguments: rows per tile,
    tiles, tile pointers', records' and entries' offsets, nonzero columns
    of the sparsest tile): uploaded once per matrix, then kernel data."""
    data = walk_data(matrix_t)
    tiles, rows_per_tile, rec_base, ent_base = (int(x) for x in data[:4])
    min_cols = int(np.diff(data[4:5 + tiles]).min()) - 1
    tel.note_kernel_setup()
    return torch.from_numpy(data).to(device), (
        rows_per_tile, tiles, 4, rec_base, ent_base, min_cols)


def _walk_error(lib, fn, err: int) -> KernelLaunchError:
    return KernelLaunchError(f"{fn.__name__} failed: CUDA error {err} "
                             f"({lib.gf8cw_error_string(err).decode()})",
                             code=err)


def _launch_walk(fn, x: torch.Tensor, out: torch.Tensor, batch: int,
                 nbytes: int, in_strides: tuple[int, int],
                 out_strides: tuple[int, int], matrix_t) -> None:
    """Run the column-walk kernel on the current stream, counted on
    ``fn``."""
    lib = _walklib()
    data, args = _device_walk(matrix_t, x.device)
    err = lib.gf8cw_apply(
        x.data_ptr(), out.data_ptr(), data.data_ptr(), batch, nbytes,
        *in_strides, *out_strides, len(matrix_t), *args,
        *device_and_stream(x))
    if err:
        raise _walk_error(lib, fn, err)
    fn.launches += 1


def walk_splits(batch: int, nbytes: int, matrix_t,
                device: torch.device) -> int:
    """The column splits the column-walk kernel takes for ``batch``
    stripes of ``nbytes``-byte chunks of ``matrix_t`` on ``device``
    (into an output the wrappers allocate): more than one only where the
    blocks fill less than a wave of the card.  A query; it launches
    nothing."""
    static = _static(matrix_t)
    lib = _walklib()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    rows_per_tile, tiles, _, _, _, min_cols = _device_walk(
        static, torch.device("cuda", index))[1]
    got = ctypes.c_int(0)
    err = lib.gf8cw_splits(batch, nbytes, len(static), rows_per_tile, tiles,
                           min_cols, index, ctypes.byref(got))
    if err:
        raise _walk_error(lib, walk_splits, err)
    return got.value


def apply_matrix_mxu_cuda(chunks: torch.Tensor, matrix_t) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to (..., s, C) uint8 chunks ->
    (..., r, C) through the sparse column-walk kernel (the reference's
    MXU tier).  Any C; the chunk dimension may be strided as long as
    each chunk's bytes are contiguous.  The kernel splits the columns
    only to fill the card (:func:`walk_splits`)."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s:
        raise ValueError(f"need (..., {s}, C) uint8 chunks, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    if chunks.device.type == "cpu":
        return apply_matrix_walk_torch(chunks, walk_data(static), r)
    _check_cuda(chunks)
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    out = torch.empty(lead + (r, c), dtype=torch.uint8, device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    _launch_walk(apply_matrix_mxu_cuda, chunks, out, batch, c,
                 (bstride, chunks.stride(-2)), (r * c, c), static)
    return out


def apply_matrix_mxu_cuda_packed(words: torch.Tensor, matrix_t
                                 ) -> torch.Tensor:
    """Packed-layout twin: (..., s, R, 128) uint32 -> (..., r, R, 128),
    the same kernel on the free uint8 view of the words.  Each chunk's
    (R, 128) words must be contiguous; the chunk dimension may be
    strided."""
    static = _static(matrix_t)
    r, s = _matrix_info(static)
    if words.dtype != torch.uint32 or words.dim() < 3 \
            or words.shape[-3] != s or words.shape[-1] != LANE:
        raise ValueError(f"need (..., {s}, R, {LANE}) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return pack_chunks(apply_matrix_walk_torch(
            unpack_chunks(words), walk_data(static), r))
    _check_cuda(words)
    if words.stride(-1) != 1 or (words.shape[-2] > 1
                                 and words.stride(-2) != LANE):
        raise ValueError("each chunk's (R, 128) words must be contiguous")
    lead, rows = tuple(words.shape[:-3]), words.shape[-2]
    nbytes = rows * PACKED_ROW_BYTES
    out = torch.empty(lead + (r, nbytes), dtype=torch.uint8,
                      device=words.device)
    if out.numel() == 0:
        return pack_chunks(out)
    batch, bstride = _merged_batch(words, words.dim() - 3, 4)
    _launch_walk(apply_matrix_mxu_cuda_packed, words, out, batch, nbytes,
                 (bstride, words.stride(-3) * 4), (r * nbytes, nbytes),
                 static)
    return pack_chunks(out)


# this module's wrappers; launches.launch_counts reads them with every
# other kernel module's
WRAPPERS = register(
    apply_matrix_cuda, apply_matrix_cuda_packed, apply_matrix_cuda_words,
    apply_bitmatrix_cuda, apply_bitmatrix_xor_cuda, apply_matrix_xor_cuda,
    apply_matrix_xor_cuda_packed, apply_matrix_cuda_ragged,
    apply_matrix_cuda_packed_ragged, apply_matrix_mxu_cuda,
    apply_matrix_mxu_cuda_packed)


# -- layouts ------------------------------------------------------------------

def pack_chunks(chunks: torch.Tensor) -> torch.Tensor:
    """(..., s, C) uint8 -> (..., s, C/512, 128) uint32 view (no copy for
    a contiguous tensor; C must be a multiple of 512)."""
    c = chunks.shape[-1]
    if chunks.dtype != torch.uint8 or c % PACKED_ROW_BYTES:
        raise ValueError(f"packing needs uint8 chunks whose size is a "
                         f"multiple of {PACKED_ROW_BYTES}, got {c}")
    return chunks.contiguous().view(torch.uint32).reshape(
        chunks.shape[:-1] + (c // PACKED_ROW_BYTES, LANE))


def unpack_chunks(words: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_chunks: (..., s, R, 128) uint32 -> (..., s, C)."""
    rows = words.shape[-2]
    return words.contiguous().view(torch.uint8).reshape(
        words.shape[:-2] + (rows * PACKED_ROW_BYTES,))


# -- the numpy tier -----------------------------------------------------------

def _on_host(chunks: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a host array; a card tensor raises: the
    numpy tier never takes the card's work."""
    if chunks.device.type != "cpu":
        raise ValueError(f"tensor on {chunks.device}: the numpy tier "
                         f"takes CPU tensors")
    return chunks.detach().numpy()


def apply_matrix_numpy(chunks: torch.Tensor, matrix_t, w: int = 8
                       ) -> torch.Tensor:
    """The host tier on a CPU tensor's bytes: for w=8
    ``xor_schedule.host_matrix_apply`` (the identical XOR schedule when
    one is preferred, the regionops ground truth otherwise), for w=16/32
    ``regionops.matrix_encode``."""
    mat = np.asarray(matrix_t, dtype=np.int64)
    if w == 8:
        out = host_matrix_apply(_on_host(chunks), mat, _static(matrix_t), 8)
    else:
        out = regionops.matrix_encode(_on_host(chunks), mat, w)
    return torch.from_numpy(out)


# -- selection and dispatch ---------------------------------------------------

# nonzeros at or above which the reference sends a matrix without a
# preferred schedule to its MXU tier (mxu_matrix_min's default); the
# preference probe reads it
MXU_MATRIX_MIN = 2048


def mxu_matrix_min() -> int:
    """The mxu row's nonzero cutover: the tuned value from the installed
    best-config table (kind ``engine-select``), else MXU_MATRIX_MIN.
    Every tier is byte-identical, so a tuned cutover moves only WHERE
    the product runs."""
    cfg = _tune.consult("engine-select")
    if cfg:
        v = cfg.get("mxu_matrix_min")
        if isinstance(v, int) and not isinstance(v, bool) and v > 0:
            return v
    return MXU_MATRIX_MIN


def _static(matrix_t) -> tuple:
    """A coefficient table as the hashable tuple of tuples the schedule
    and kernel-data caches key on: a StaticMatrix as it is (its hash is
    kept), a tuple of tuples as it is, anything else converted."""
    if isinstance(matrix_t, StaticMatrix) or (
            isinstance(matrix_t, tuple)
            and all(isinstance(row, tuple) for row in matrix_t)):
        return matrix_t
    return StaticMatrix(tuple(int(x) for x in row) for row in matrix_t)


def _xor_static(matrix_t):
    """The static tuple of the schedule the table routed ``matrix_t``
    to: the probe's, which the preference test and a tuned pin both
    route on (the probe is cached: a dict hit per call)."""
    return probe_schedule(_static(matrix_t), 8).static


@functools.lru_cache(maxsize=256)
def _matrix_nnz(matrix_t) -> int:
    """Nonzero coefficients of a static table.  Cached: it runs in the
    per-call dispatch, and a clay composite has 45k coefficients."""
    return sum(1 for row in matrix_t for v in row if v)


def _tuned_engine_pin(shape, static, packed: bool, eng: str) -> str | None:
    """The autotuner's per-matrix tier pin: the measured winner for this
    static w=8 matrix from the best-config table (kind
    ``matrix-engine``, profile slot ``m:<digest>``), validated against
    what this tensor can dispatch — an undispatchable pin falls back to
    the heuristic rows byte-identically, it never errors.  ``torch``
    runs only on CPU tensors, ``cuda`` and ``mxu`` only on the card,
    ``xor`` where the xor row could run it."""
    digest = "m:" + _tune.matrix_digest(static)
    cfg = _tune.consult("matrix-engine", profile=digest,
                        layout="packed" if packed else "bytes",
                        device_count=1)
    if cfg is None:
        # most pins are written under the bytes layout; a packed
        # dispatch of the same matrix runs the same tier
        cfg = _tune.consult("matrix-engine", profile=digest,
                            layout="bytes", device_count=1)
    if not cfg:
        return None
    pin = cfg.get("engine")
    if pin == "torch":
        return "torch" if eng == "torch" else None
    if pin == "xor":
        sched = probe_schedule(static, 8)
        ok = ((packed or (shape is not None and len(shape) >= 2
                          and shape[-1] % 4 == 0))
              and sched is not None and xor_program_fits(sched.static))
        return "xor" if ok else None
    if eng != "cuda":
        return None          # mxu/cuda pins need the card
    if pin in ("mxu", "cuda"):
        return pin
    return None


def select_matrix_engine(w: int = 8, device=None,
                         engine: str | None = None, *, shape=None,
                         matrix_t=None, packed: bool = False,
                         mesh=None) -> str:
    """THE engine-selection table for GF(2^w) matrix applies (w in
    {8, 16, 32}) and GF(2) bitmatrix applies (``w`` then names the
    packet count of a block), reduced to the rows the port has.
    Returns one of:

    - "numpy": the host tier: forced, or at the supervisor's live
               numpy floor, on CPU tensors;
    - "mesh":  an active data plane (``parallel/plane.py``; ``mesh``
               overrides it: a DataPlane, or falsy to disable the row)
               with two or more members of the tensor's device kind, and
               a stripe-batched shape (rank >= 3, >= 4 packed) of two or
               more stripes: equal stripe shards, one per member, each
               on the single-device tier below (``_apply_matrix_mesh``);
    - "xor":   a w=8 matrix (``matrix_t``, applied to chunks of
               ``shape``) whose XOR schedule the probe prefers
               (``xor_schedule.preferred_schedule``: it beats the dense
               cost model by XOR_DENSE_CUTOVER, its bit-matrix expansion
               has at most DEFAULT_MAX_ONES ones, and at MXU_MATRIX_MIN
               nonzeros or more it undercuts one op per nonzero), when
               the layout is packed or C % 4 == 0, and — the word
               kernel's capacity rule — its program fits the kernel
               (``xor_program_fits``).  On a CUDA tensor the
               XOR-schedule kernel runs it, on a CPU tensor the plain
               torch schedule;
    - "mxu":   a w=8 matrix with MXU_MATRIX_MIN nonzeros or more on a
               CUDA tensor (clay's composites): the sparse column-walk
               kernel (``apply_matrix_mxu_cuda``; the row keeps the
               reference's name);
    - "cuda":  a hand-written kernel for every other CUDA tensor: the
               dense w=8 bytes or packed kernel (any table size:
               ``matrix_kernel_fits``), the w=16/32 word kernel, or a
               bitmatrix kernel;
    - "torch": the plain torch tier — CPU tensors (a forced torch tier
               or the supervisor's live demotion, ops/supervisor.py,
               applies to CPU tensors only).

    The order is the reference's (``ceph_tpu/ops/pallas_gf.py``): the
    numpy tier first, then the mesh row, the tuned pin, the xor row,
    then the mxu row and the device tier, which only a device tensor
    reaches (the reference's "xla" is the port's "torch", its "pallas"
    the port's "cuda").  The installed best-config table (tune/table.py)
    can pin a w=8 matrix to a tier (``_tuned_engine_pin``, consulted
    after the numpy and mesh rows: a pin chooses a kernel, it never
    unshards a plane) and tune the mxu and XOR cutovers
    (``mxu_matrix_min``, ``xor_schedule.tuned_xor_cutover``); without a
    table every row is the reference's default.  ``engine`` forces a
    tier for this call in place of the process policy; like the
    policy's, a forced torch or numpy tier raises for a CUDA
    ``device``, so a card tensor never leaves the kernels.
    """
    if w < 1:
        raise ValueError(f"w={w} must be positive")
    policy = global_policy() if engine is None else FallbackPolicy(engine)
    eng = policy.engine(device)
    if eng == "numpy":
        return "numpy"
    if (shape is not None and len(shape) >= (4 if packed else 3)
            and shape[0] >= 2
            # no plane and no override: one module-global read, no call
            and (mesh is not None or _planes._active is not None
                 or not _planes._env_resolved)
            and _planes.plane_for(mesh, device) is not None):
        return "mesh"
    static = _static(matrix_t) if matrix_t else None
    # no table installed: one module-global read, no digest
    if w == 8 and static and _tune.active_table() is not None:
        pin = _tuned_engine_pin(shape, static, packed, eng)
        if pin is not None:
            return pin
    if (w == 8 and static
            and (packed or (shape is not None and len(shape) >= 2
                            and shape[-1] % 4 == 0))):
        sched = preferred_schedule(static, 8, mxu_min=mxu_matrix_min())
        if sched is not None and xor_program_fits(sched.static):
            return "xor"
    if eng == "cuda" and w == 8 and static \
            and _matrix_nnz(static) >= mxu_matrix_min():
        return "mxu"
    return eng


def _run_matrix_bytes(chunks: torch.Tensor, matrix_t, w: int, eng: str,
                      mesh=None) -> torch.Tensor:
    """Execute ONE engine tier on bytes/words-layout chunks (the body of
    apply_matrix_best, and of the ragged mask tier, unrecorded)."""
    if eng == "mesh":
        return _apply_matrix_mesh(chunks, matrix_t, w, False, mesh)
    if eng == "xor":
        return apply_matrix_xor_cuda(chunks, _xor_static(matrix_t))
    if eng == "mxu":
        return apply_matrix_mxu_cuda(chunks, matrix_t)
    if eng == "cuda":
        if w == 8:
            return apply_matrix_cuda(chunks, matrix_t)
        return apply_matrix_cuda_words(chunks, matrix_t, w)
    if eng == "torch":
        return apply_matrix_torch(chunks, matrix_t, w)
    return apply_matrix_numpy(chunks, matrix_t, w)


def _run_matrix_packed(words: torch.Tensor, matrix_t, eng: str, mesh=None
                       ) -> torch.Tensor:
    """Packed-layout twin of _run_matrix_bytes."""
    if eng == "mesh":
        return _apply_matrix_mesh(words, matrix_t, 8, True, mesh)
    if eng == "xor":
        return apply_matrix_xor_cuda_packed(words, _xor_static(matrix_t))
    if eng == "mxu":
        return apply_matrix_mxu_cuda_packed(words, matrix_t)
    if eng == "cuda":
        return apply_matrix_cuda_packed(words, matrix_t)
    byts = unpack_chunks(words)
    if eng == "torch":
        return pack_chunks(apply_matrix_torch(byts, matrix_t, 8))
    return pack_chunks(apply_matrix_numpy(byts, matrix_t, 8))


def _apply_matrix_mesh(x: torch.Tensor, matrix_t, w: int, packed: bool,
                       mesh) -> torch.Tensor:
    """The mesh tier: the stripe batch cut into equal shards, one per
    plane member (zero-padded to a multiple of the member count, the
    pad rows dropped from the output: GF region math is row-local),
    each shard on the single-device tier, the output gathered on
    ``x``'s device; byte-identical to the single-device tier by
    construction (``utils/shard.py``).  One supervised dispatch at the
    seam above it; the per-member applies run bare."""
    plane = _planes.plane_for(mesh, x.device)
    # the per-member tier, selected on a one-stripe shape with the mesh
    # row off (the batch size never changes the other rows)
    inner = select_matrix_engine(w, x.device, shape=(1,) + tuple(x.shape[1:]),
                                 matrix_t=matrix_t, packed=packed, mesh=0)
    if plane is None:
        # the plane went away between selection and dispatch (a
        # reshrink): the single-device tier, never the host
        if packed:
            return _run_matrix_packed(x, matrix_t, inner)
        return _run_matrix_bytes(x, matrix_t, w, inner)
    tel.counter("engine_mesh_dispatches",
                tier=f"apply-{'packed' if packed else 'bytes'}",
                devices=str(plane.n_devices))
    if packed:
        return shard_batch(lambda v: _run_matrix_packed(v, matrix_t, inner),
                           plane, (x,))
    return shard_batch(lambda v: _run_matrix_bytes(v, matrix_t, w, inner),
                       plane, (x,))


# -- the supervised seams (ops/supervisor.py).  Their bodies, numpy twins
# and rebuilds are module functions taking the tier as an argument, so a
# clean dispatch builds nothing; a rebuilt callable re-runs selection
# under the live tier

def _bytes_twin(v, matrix_t, w, eng, mesh=None):
    return _run_matrix_bytes(v, matrix_t, w, "numpy")


def _bytes_reselected(v, matrix_t, w, eng, mesh=None):
    return _run_matrix_bytes(v, matrix_t, w, select_matrix_engine(
        w, v.device, shape=tuple(v.shape), matrix_t=matrix_t), None)


def _bytes_rebuild():
    return _bytes_reselected


def _packed_twin(v, matrix_t, eng, mesh=None):
    return _run_matrix_packed(v, matrix_t, "numpy")


def _packed_reselected(v, matrix_t, eng, mesh=None):
    return _run_matrix_packed(v, matrix_t, select_matrix_engine(
        8, v.device, shape=tuple(v.shape), matrix_t=matrix_t, packed=True),
        None)


def _packed_rebuild():
    return _packed_reselected


def apply_matrix_best(chunks: torch.Tensor, matrix_t, w: int = 8,
                      mesh=None) -> torch.Tensor:
    """Bytes/words-layout dispatch through select_matrix_engine and the
    supervised seam ``ops.apply_matrix``; byte-identical in every
    branch.  ``mesh`` overrides the active data plane (a DataPlane, or
    falsy for the single-device tiers).  Each call is timed and counted
    in ``ops_apply_matrix_{seconds,calls}{engine,layout=bytes}``, as the
    reference's eager dispatch is; an armed span ``engine.dispatch``
    (telemetry/spans.py) covers the choice, the seam and the launch."""
    if w not in WORD_DTYPE:
        raise ValueError(f"GF(2^w) matrix applies take w in 8, 16, 32, "
                         f"got w={w}")
    with spans.child("engine.dispatch"):
        eng = select_matrix_engine(w, chunks.device,
                                   shape=tuple(chunks.shape),
                                   matrix_t=matrix_t, mesh=mesh)
        with tel.record_dispatch("ops_apply_matrix", engine=eng,
                                 layout="bytes"):
            if _seam_tls.depth:
                return _run_matrix_bytes(chunks, matrix_t, w, eng, mesh)
            return global_supervisor().dispatch(
                "ops.apply_matrix", _run_matrix_bytes,
                (chunks, matrix_t, w, eng, mesh),
                host_fn=_bytes_twin if w == 8 else None,
                rebuild=_bytes_rebuild)


def apply_matrix_packed_best(words: torch.Tensor, matrix_t, mesh=None
                             ) -> torch.Tensor:
    """Packed-layout dispatch through the supervised seam
    ``ops.apply_matrix_packed``: (..., s, R, 128) uint32 ->
    (..., r, R, 128); byte-identical in every branch.  ``mesh`` as in
    apply_matrix_best.  Recorded in
    ``ops_apply_matrix_*{engine,layout=packed}``; an armed span
    ``engine.dispatch``, as in apply_matrix_best."""
    with spans.child("engine.dispatch"):
        eng = select_matrix_engine(8, words.device,
                                   shape=tuple(words.shape),
                                   matrix_t=matrix_t, packed=True,
                                   mesh=mesh)
        with tel.record_dispatch("ops_apply_matrix", engine=eng,
                                 layout="packed"):
            if _seam_tls.depth:
                return _run_matrix_packed(words, matrix_t, eng, mesh)
            return global_supervisor().dispatch(
                "ops.apply_matrix_packed", _run_matrix_packed,
                (words, matrix_t, eng, mesh), host_fn=_packed_twin,
                rebuild=_packed_rebuild)


# -- the ragged (paged) tier ---------------------------------------------------
#
# The paged serving path (serve/pool.py, codes/engine.py ::
# serve_dispatch_ragged) co-batches requests of different stripe sizes
# into one pool (P, s, page) plus a per-fire (P,) activity mask; dead
# pages carry stale bytes.  Every tier writes zeros for dead pages, so
# the three are byte-identical (GF(2^w) applies are linear):
#
# - "cuda":  the dense kernel with the mask pointer (a dead page reads
#            nothing and stores zeros);
# - "mask":  zero the dead pages (mask_pages), then the dense table on
#            the product (the XOR-schedule kernel, the torch tier);
# - "numpy": the host ground truth on the live pages only, forced.

RAGGED_MIN_PAGES = 2


def tuned_ragged_cutover() -> int:
    """The least pool page count for the page-skipping kernel: the tuned
    value from the installed best-config table (kind
    ``ragged-cutover``), else RAGGED_MIN_PAGES.  Below it the mask tier
    runs, byte-identically."""
    cfg = _tune.consult("ragged-cutover")
    if cfg:
        v = cfg.get("min_pages")
        if isinstance(v, int) and not isinstance(v, bool) and v >= 1:
            return v
    return RAGGED_MIN_PAGES


def select_ragged_engine(shape, matrix_t, w: int = 8, packed: bool = False,
                         engine: str | None = None, device=None) -> str:
    """The engine table of the ragged family: select_matrix_engine
    projected onto the ragged tiers, as the reference's
    ``select_ragged_engine`` does (its "pallas" is the port's "cuda"):

    - "cuda":  the dense table picked the dense device kernel (not
               "xor" or "mxu") and the pool has at least
               tuned_ragged_cutover() pages;
    - "mask":  mask_pages, then the dense table on the product (the
               XOR-schedule or column-walk kernel on the card);
    - "numpy": the numpy tier was forced (CPU tensors only).
    """
    inner = select_matrix_engine(w, device, engine, shape=tuple(shape),
                                 matrix_t=matrix_t, packed=packed, mesh=0)
    if inner == "numpy":
        return "numpy"
    if inner == "cuda" and shape[0] >= tuned_ragged_cutover():
        return "cuda"
    return "mask"


def _host_apply_bytes_ragged(pool: torch.Tensor, matrix_t,
                             mask: torch.Tensor) -> torch.Tensor:
    """Numpy ground truth of the ragged bytes dispatch: the host apply
    on the live pages only, scattered into zeros."""
    arr = _on_host(pool)
    live = _on_host(mask) != 0
    out = np.zeros((arr.shape[0], len(matrix_t), arr.shape[-1]), np.uint8)
    if live.any():
        out[live] = apply_matrix_numpy(torch.from_numpy(
            np.ascontiguousarray(arr[live])), matrix_t, 8).numpy()
    return torch.from_numpy(out)


def _host_apply_packed_ragged(words: torch.Tensor, matrix_t,
                              mask: torch.Tensor) -> torch.Tensor:
    """Packed twin of _host_apply_bytes_ragged."""
    out = _host_apply_bytes_ragged(unpack_chunks(words), matrix_t, mask)
    return pack_chunks(out)


def _run_ragged(pool: torch.Tensor, matrix_t, mask: torch.Tensor,
                packed: bool, eng: str) -> torch.Tensor:
    """Execute ONE ragged tier (the body of the ragged ops entries)."""
    if eng == "cuda":
        return (apply_matrix_cuda_packed_ragged(pool, matrix_t, mask)
                if packed else apply_matrix_cuda_ragged(pool, matrix_t, mask))
    if eng == "numpy":
        return (_host_apply_packed_ragged(pool, matrix_t, mask) if packed
                else _host_apply_bytes_ragged(pool, matrix_t, mask))
    x = mask_pages(pool, mask)
    inner = select_matrix_engine(8, x.device, shape=tuple(x.shape),
                                 matrix_t=matrix_t, packed=packed, mesh=0)
    if packed:
        return _run_matrix_packed(x, matrix_t, inner)
    return _run_matrix_bytes(x, matrix_t, 8, inner)


def _ragged_twin(pool, matrix_t, mask, packed, eng):
    return _run_ragged(pool, matrix_t, mask, packed, "numpy")


def _ragged_reselected(pool, matrix_t, mask, packed, eng):
    return _run_ragged(pool, matrix_t, mask, packed, select_ragged_engine(
        pool.shape, matrix_t, 8, packed=packed, device=pool.device))


def _ragged_rebuild():
    return _ragged_reselected


def _supervised_ragged_dispatch(seam: str, pool: torch.Tensor, mask,
                                matrix_t, packed: bool, eng: str
                                ) -> torch.Tensor:
    """Supervised-plane routing for one ragged dispatch (a rung split
    cuts the pool and its mask alike)."""
    if _seam_tls.depth:
        return _run_ragged(pool, matrix_t, mask, packed, eng)
    return global_supervisor().dispatch(
        seam, _run_ragged, (pool, matrix_t, mask, packed, eng),
        host_fn=_ragged_twin, rebuild=_ragged_rebuild)


def apply_matrix_best_ragged(pool: torch.Tensor, matrix_t,
                             mask: torch.Tensor, w: int = 8
                             ) -> torch.Tensor:
    """Ragged dispatch over a page pool (P, s, page) of w-bit words under
    a (P,) activity mask -> (P, r, page), dead pages zero in every
    branch, through the supervised seam ``ops.apply_matrix_ragged``.
    w=16/32 pools take the mask tier, unsupervised, as in the reference
    (the word kernel has no ragged variant)."""
    if pool.dim() != 3:
        raise ValueError(f"need a (P, s, page) pool, got "
                         f"{tuple(pool.shape)}")
    mask = _page_mask(pool, mask)
    if w != 8:
        x = mask_pages(pool, mask)
        return _run_matrix_bytes(x, matrix_t, w, select_matrix_engine(
            w, x.device, shape=tuple(x.shape), matrix_t=matrix_t, mesh=0))
    eng = select_ragged_engine(pool.shape, matrix_t, 8, device=pool.device)
    with tel.record_dispatch("ops_apply_matrix_ragged", engine=eng,
                             layout="bytes"):
        return _supervised_ragged_dispatch("ops.apply_matrix_ragged", pool,
                                           mask, matrix_t, False, eng)


def apply_matrix_packed_best_ragged(words: torch.Tensor, matrix_t,
                                    mask: torch.Tensor) -> torch.Tensor:
    """Packed-layout ragged dispatch: a (P, s, R, 128) uint32 pool under
    a (P,) mask -> (P, r, R, 128), dead pages zero in every branch,
    through the supervised seam ``ops.apply_matrix_packed_ragged``."""
    if words.dim() != 4:
        raise ValueError(f"need a (P, s, R, 128) pool, got "
                         f"{tuple(words.shape)}")
    mask = _page_mask(words, mask)
    eng = select_ragged_engine(words.shape, matrix_t, 8, packed=True,
                               device=words.device)
    with tel.record_dispatch("ops_apply_matrix_ragged", engine=eng,
                             layout="packed"):
        return _supervised_ragged_dispatch(
            "ops.apply_matrix_packed_ragged", words, mask, matrix_t, True,
            eng)


def apply_bitmatrix_numpy(chunks: torch.Tensor, bitmatrix_rows, w: int,
                          packetsize: int) -> torch.Tensor:
    """The host ground truth (``regionops.bitmatrix_encode``) on a CPU
    tensor's bytes."""
    sw = chunks.shape[-2] * w
    bits = np.array([[(int(m) >> c) & 1 for c in range(sw)]
                     for m in bitmatrix_rows], dtype=np.uint8)
    return torch.from_numpy(regionops.bitmatrix_encode(
        _on_host(chunks), bits, w, packetsize))


def apply_bitmatrix_best(chunks: torch.Tensor, bitmatrix_rows, w: int,
                         packetsize: int, sched: XorSchedule | None
                         ) -> torch.Tensor:
    """Dispatch for packet-layout bitmatrix codes: the CSE-scheduled
    product when the greedy sharing pays, the plain packet product
    otherwise; the kernels on the card, the torch tier on the CPU.
    ``sched`` is the rows' schedule as ``probe_bitmatrix_schedule``
    (jerasure's smart scheduling) returns it, None when no schedule
    pays; callers cache it per matrix.  Byte-identical in every branch.
    Any packetsize the techniques allow is taken: the reference's
    ``packetsize % 512`` gate is a fact of the TPU's tiling, not of the
    math.  An armed span ``engine.dispatch``, as in apply_matrix_best."""
    with spans.child("engine.dispatch"):
        rows = tuple(int(m) for m in bitmatrix_rows)
        eng = select_matrix_engine(w, chunks.device)
        if eng == "cuda":
            if sched is not None:
                return apply_bitmatrix_xor_cuda(chunks, sched.static, w,
                                                packetsize)
            return apply_bitmatrix_cuda(chunks, rows, w, packetsize)
        if eng == "torch":
            if sched is not None:
                return apply_bitmatrix_xor_torch(chunks, sched.static, w,
                                                 packetsize)
            return apply_bitmatrix_torch(chunks, rows, w, packetsize)
        return apply_bitmatrix_numpy(chunks, rows, w, packetsize)


__all__ = [
    "BY_VALUE_MAX_PROG", "DENSE_ROWS_MAX", "DENSE_TILE_COLS", "DENSE_UNITS",
    "MAX_TABLE_COEF", "MXU_MATRIX_MIN", "mxu_matrix_min",
    "RAGGED_MIN_PAGES", "WALK_SMEM_BUDGET", "WALK_WARPS", "WALK_WORDS",
    "WRAPPERS", "XOR_SMEM_BUDGET",
    "apply_bitmatrix_best", "apply_bitmatrix_cuda", "apply_bitmatrix_numpy",
    "apply_bitmatrix_xor_cuda", "apply_matrix_best",
    "apply_matrix_best_ragged", "apply_matrix_cuda",
    "apply_matrix_cuda_packed", "apply_matrix_cuda_packed_ragged",
    "apply_matrix_cuda_ragged", "apply_matrix_cuda_words",
    "apply_matrix_mxu_cuda", "apply_matrix_mxu_cuda_packed",
    "apply_matrix_numpy", "apply_matrix_packed_best",
    "apply_matrix_packed_best_ragged", "apply_matrix_xor_cuda",
    "apply_matrix_xor_cuda_packed", "bitmatrix_op_count", "dense_geometry",
    "dense_op_count", "dense_plan", "dense_program",
    "launch_counts", "mask_pages", "matrix_kernel_fits", "pack_chunks",
    "PACKET_GROUPS", "PACKET_MIN_WARPS", "PACKET_UNITS", "PacketPlan",
    "packet_groups", "packet_launch_plan", "packet_plan", "packet_program",
    "packet_slots", "packet_stream_room",
    "pack_word_program", "program_op_count", "reset_launch_counts",
    "schedule_op_count", "select_matrix_engine", "select_ragged_engine",
    "sm90_op_count", "sm90_op_floor", "sm90_row_op_count",
    "tuned_ragged_cutover", "unpack_chunks", "walk_data", "walk_row_tile",
    "walk_splits", "xor_program_fits",
    "xor_schedule_op_count",
]
