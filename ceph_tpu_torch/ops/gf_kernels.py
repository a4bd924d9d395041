"""GF(2^w) matrix and GF(2) bitmatrix applies on the card: the kernel
wrappers and the engine-selection table.

Counterpart of the kernel part of ``ceph_tpu/ops/pallas_gf.py`` and of
the MXU path of ``ceph_tpu/ops/xla_ops.py``.  Four hand-written CUDA
sources stand in for nine TPU kernels and the MXU path, behind eleven
wrappers:

- ``csrc/gf8_matrix.cu`` (GF(2^w) matrix, field width a template
  parameter):

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

  Any table size (:func:`matrix_kernel_fits`): up to BY_VALUE_MAX_COEF
  coefficients the matrix is a kernel parameter, above that a device
  buffer cached per matrix (clay's 64 x 704 repair composites).

- ``csrc/gf2_bitmatrix.cu`` (jerasure packet layout, any packetsize; one
  kernel that runs "rows", each the XOR of a list of slots):

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

- ``csrc/gf2_bitplane_mma.cu`` (a GF(2^8) matrix as a GF(2) product of
  its (8r, 8s) bitmatrix with the input's bit-planes, int8 ``mma.sync``
  on the tensor cores; the bitmatrix is kernel data cached per matrix):

  - :func:`apply_matrix_mxu_cuda` — bytes layout.  Replaces
    ``ceph_tpu/ops/xla_ops.py::apply_matrix_mxu``.
  - :func:`apply_matrix_mxu_cuda_packed` — packed layout (the same
    kernel on the words' uint8 view).

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
ops entries.  A forced torch or numpy tier applies to CPU
tensors only and raises for CUDA tensors (``ops/fallback.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import regionops
from ._build import load
from .fallback import FallbackPolicy, global_policy
from .launches import device_and_stream, launch_counts, register, \
    reset_launch_counts
from .torch_ops import WORD_DTYPE, StaticMatrix, apply_bitmatrix_torch, \
    apply_bitmatrix_xor_torch, apply_matrix_mxu_torch, \
    apply_matrix_packed_ragged_torch, apply_matrix_ragged_torch, \
    apply_matrix_torch, apply_matrix_xor_torch, mask_pages, mxu_bitmatrix
from .xor_schedule import XorSchedule, host_matrix_apply, \
    preferred_schedule, row_program, word_program
from ..telemetry import metrics as tel
from ..utils.errors import KernelLaunchError

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

# coefficients the kernel takes as a by-value kernel parameter
# (csrc/gf8_matrix.cu GF8_MAX_COEF / GFW_MAX_COEF), checked against the
# library when it loads; a larger table goes to the kernel's table
# variant through a device buffer (slower on small tables, so not used
# for them: PERF.md)
BY_VALUE_MAX_COEF = {8: 2048, 16: 512, 32: 512}
# the largest table either variant takes: the kernel indexes rows with
# 32-bit ints
MAX_TABLE_COEF = (1 << 31) - 1

# (library, output rows per launch), set on first use; the per-call path
# reads it without a lock
_lib_state = None


def _lib():
    global _lib_state
    if _lib_state is None:
        lib = load("gf8_matrix")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf8_matrix_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, ctypes.c_char_p, vp, vp,
            i, vp]
        lib.gf8_matrix_apply.restype = i
        lib.gfw_matrix_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, i, ctypes.c_char_p, vp, i,
            vp]
        lib.gfw_matrix_apply.restype = i
        lib.gf8_max_coef.restype = i
        lib.gfw_max_coef.restype = i
        lib.gf8_row_group.restype = i
        lib.gf8_error_string.argtypes = [i]
        lib.gf8_error_string.restype = ctypes.c_char_p
        have = (lib.gf8_max_coef(), lib.gfw_max_coef())
        if have != (BY_VALUE_MAX_COEF[8], BY_VALUE_MAX_COEF[16]):
            raise KernelLaunchError(
                f"the GF(2^w) matrix kernel takes {have} coefficients by "
                f"value; the wrapper plans for {BY_VALUE_MAX_COEF}")
        _lib_state = (lib, lib.gf8_row_group())
    return _lib_state


def matrix_kernel_fits(r: int, s: int, w: int = 8) -> bool:
    """The dense GF(2^w) kernel's capacity rule, a pure function of the
    shape: any (r, s) table up to MAX_TABLE_COEF coefficients.  Up to
    BY_VALUE_MAX_COEF[w] it travels as a kernel parameter, above that
    through a device buffer staged into shared memory."""
    return w in BY_VALUE_MAX_COEF and r >= 1 and s >= 1 \
        and r * s <= MAX_TABLE_COEF


@functools.lru_cache(maxsize=512)
def _matrix_info(matrix_t, w: int = 8) -> tuple[int, int, bytes]:
    """(r, s, row-major coefficient bytes) of a GF(2^w) coefficient
    table: one byte per coefficient for w=8, little-endian uint32 for
    w=16/32; raises on a ragged or empty table or a coefficient outside
    [0, 2^w).  Cached: a code applies the same few matrices on every
    call (its encode matrix and one decode matrix per pattern)."""
    r = len(matrix_t)
    s = len(matrix_t[0]) if r else 0
    if r == 0 or s == 0 or any(len(row) != s for row in matrix_t):
        raise ValueError("matrix must be a non-empty (r, s) table")
    flat = [int(x) for row in matrix_t for x in row]
    if any(not 0 <= x < (1 << w) for x in flat):
        raise ValueError(f"GF(2^{w}) coefficients must lie in "
                         f"[0, {(1 << w) - 1}]")
    if w == 8:
        return r, s, bytes(flat)
    return r, s, np.asarray(flat, dtype="<u4").tobytes()


@functools.lru_cache(maxsize=256)
def _device_table(coef: bytes, device: torch.device) -> torch.Tensor:
    """A coefficient table above the by-value limit, on ``device``:
    uploaded once per matrix, then kernel data."""
    tel.note_kernel_setup()
    return torch.frombuffer(bytearray(coef), dtype=torch.uint8).to(device)


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
            r: int, s: int, coef: bytes, w: int = 8,
            mask: torch.Tensor | None = None) -> int:
    """Launch the GF(2^w) matrix kernel on the current stream; return how
    many launches it took (one per group of output rows).  A table above
    BY_VALUE_MAX_COEF[w] goes through its cached device buffer.
    ``mask`` (w=8 only): a (batch,) uint8 page mask on the card, the
    ragged variant."""
    if not matrix_kernel_fits(r, s, w):
        raise ValueError(f"({r}, {s}) matrix exceeds the kernel's "
                         f"{MAX_TABLE_COEF} coefficients")
    lib, row_group = _lib()
    table = None
    if r * s > BY_VALUE_MAX_COEF[w]:
        table = _device_table(coef, x.device).data_ptr()
    args = (x.data_ptr(), out.data_ptr(), batch, nbytes, in_strides[0],
            in_strides[1], out_strides[0], out_strides[1], r, s)
    where = device_and_stream(x)
    if w == 8:
        err = lib.gf8_matrix_apply(
            *args, coef, table, None if mask is None else mask.data_ptr(),
            *where)
    else:
        err = lib.gfw_matrix_apply(*args, w, coef, table, *where)
    if err:
        raise KernelLaunchError(
            f"GF(2^{w}) matrix kernel failed: CUDA error {err} "
            f"({lib.gf8_error_string(err).decode()})")
    return -(-r // row_group)


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"tensor on {x.device}: the kernel takes CUDA "
                         f"tensors (CPU tensors run the plain version)")


def apply_matrix_cuda(chunks: torch.Tensor, matrix_t) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to (..., s, C) uint8 chunks ->
    (..., r, C).  The chunk dimension may be strided (a survivor slice)
    as long as each chunk's bytes are contiguous."""
    r, s, coef = _matrix_info(_static(matrix_t))
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
    apply_matrix_cuda.launches += _launch(
        chunks, out, batch, c, (bstride, chunks.stride(-2)), (r * c, c),
        r, s, coef)
    return out


def apply_matrix_cuda_packed(words: torch.Tensor, matrix_t) -> torch.Tensor:
    """Packed-layout apply: (..., s, R, 128) uint32 -> (..., r, R, 128).
    Each chunk's (R, 128) words must be contiguous; the chunk dimension
    may be strided."""
    r, s, coef = _matrix_info(_static(matrix_t))
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
    apply_matrix_cuda_packed.launches += _launch(
        words, out, batch, nbytes, (bstride, words.stride(-3) * 4),
        (r * nbytes, nbytes), r, s, coef)
    return pack_chunks(out)


def apply_matrix_cuda_words(words: torch.Tensor, matrix_t, w: int
                            ) -> torch.Tensor:
    """GF(2^16) / GF(2^32) apply on word views: (..., s, Ce) uint16 or
    uint32 -> (..., r, Ce), each element a little-endian field word.
    The chunk dimension may be strided as long as each chunk's words
    are contiguous."""
    if w not in (16, 32):
        raise ValueError(f"the word kernel takes w=16 or w=32, got w={w}")
    r, s, coef = _matrix_info(_static(matrix_t), w)
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
    apply_matrix_cuda_words.launches += _launch(
        words, out, batch, ce * el, (bstride, words.stride(-2) * el),
        (r * ce * el, ce * el), r, s, coef, w)
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
    r, s, coef = _matrix_info(_static(matrix_t))
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
    apply_matrix_cuda_ragged.launches += _launch(
        pool, out, p, c, (pool.stride(0), pool.stride(1)), (r * c, c), r, s,
        coef, mask=mask)
    return out


def apply_matrix_cuda_packed_ragged(words: torch.Tensor, matrix_t,
                                    mask: torch.Tensor) -> torch.Tensor:
    """Packed-layout twin: a (P, s, R, 128) uint32 pool under a (P,)
    mask -> (P, r, R, 128), dead pages zero.  Each page chunk's (R, 128)
    words must be contiguous."""
    r, s, coef = _matrix_info(_static(matrix_t))
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
    apply_matrix_cuda_packed_ragged.launches += _launch(
        words, out, p, nbytes, (words.stride(0) * 4, words.stride(1) * 4),
        (r * nbytes, nbytes), r, s, coef, mask=mask)
    return pack_chunks(out)


# -- the GF(2) bitmatrix kernel -----------------------------------------------

ROW_GROUP = 4          # leaves a row step of the packet kernel reads at once
NO_STORE = 0xFFFF      # a row that stores no output packet

_bitlib_state = None


def _bitlib():
    global _bitlib_state
    if _bitlib_state is None:
        lib = load("gf2_bitmatrix")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf2_rows_apply.argtypes = [
            vp, vp, ll, ll, ll, ll, ll, ll, i, i, i, i, vp, i, i, i, i, i, vp]
        lib.gf2_rows_apply.restype = i
        lib.gf2_error_string.argtypes = [i]
        lib.gf2_error_string.restype = ctypes.c_char_p
        lib.gf2_row_group.restype = i
        lib.gf2_no_store.restype = i
        if (lib.gf2_row_group(), lib.gf2_no_store()) != (ROW_GROUP, NO_STORE):
            raise KernelLaunchError(
                f"the packet kernel reads rows of {lib.gf2_row_group()} "
                f"leaves and marks stores with {lib.gf2_no_store()}; the "
                f"wrapper packs {ROW_GROUP} and {NO_STORE}")
        _bitlib_state = lib
    return _bitlib_state


def pack_rows(rows, n_slots: int) -> np.ndarray:
    """The packet kernel's data: one (groups, dst, chunk, packet) uint16
    header per row, then each row's leaves padded to whole groups of
    ROW_GROUP with the zero slot (``n_slots - 2``), then a pad group, in
    whole 16-byte words.  A row is ``(leaves, dst, store)`` as
    ``xor_schedule.row_program`` makes them: dst None keeps no result
    (the trash slot, ``n_slots - 1``), store None writes no output."""
    zero, trash = n_slots - 2, n_slots - 1
    heads, leaves = [], []
    for lv, dst, store in rows:
        lv = list(lv) + [zero] * (-len(lv) % ROW_GROUP)
        chunk, packet = store if store is not None else (NO_STORE, 0)
        heads += [len(lv) // ROW_GROUP, trash if dst is None else dst,
                  chunk, packet]
        leaves += lv
    flat = heads + leaves + [zero] * ROW_GROUP
    flat += [0] * (-len(flat) % 8)
    return np.asarray(flat, dtype=np.uint16)


def _plain_rows(bitmatrix_rows: tuple, n_cols: int, w: int):
    """(slots, rows) of the plain product: output packet o is the row of
    its mask's input packets, stored to packet o % w of chunk o // w."""
    rows = tuple((tuple(c for c in range(n_cols) if (int(m) >> c) & 1),
                  None, divmod(o, w))
                 for o, m in enumerate(bitmatrix_rows))
    return n_cols + 2, rows


@functools.lru_cache(maxsize=1024)
def _device_rows(kind: str, key: tuple, n_in: int, w: int,
                 device: torch.device) -> tuple[int, int, torch.Tensor]:
    """(slots, rows, data on ``device``) of the plain product of row
    masks ``key`` (kind "plain") or of the schedule ``key`` (kind
    "schedule"): built once per matrix, then kernel data."""
    if kind == "plain":
        n_slots, rows = _plain_rows(key, n_in, w)
    else:
        n_slots, rows = row_program(key, w)
    data = pack_rows(rows, n_slots).view(np.int16)
    tel.note_kernel_setup()
    return n_slots, len(rows), torch.from_numpy(data).to(device)


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


def _launch_rows(fn, chunks: torch.Tensor, r: int, w: int, packetsize: int,
                 kind: str, key: tuple, n_in: int) -> torch.Tensor:
    """Run the packet kernel on (..., s, C) chunks -> (..., r, C): the
    rows of ``kind`` / ``key`` (see _device_rows), counted on ``fn``."""
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lib = _bitlib()
    n_slots, n_rows, data = _device_rows(kind, key, n_in, w, chunks.device)
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    out = torch.empty(lead + (r, c), dtype=torch.uint8, device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    err = lib.gf2_rows_apply(
        chunks.data_ptr(), out.data_ptr(), batch, c, bstride,
        chunks.stride(-2), r * c, c, chunks.shape[-2], r * w, w, packetsize,
        data.data_ptr(), data.numel() // 8, n_rows, n_in, n_slots,
        *device_and_stream(chunks))
    if err:
        raise KernelLaunchError(
            f"{fn.__name__} failed: CUDA error {err} "
            f"({lib.gf2_error_string(err).decode()})")
    fn.launches += 1
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
    return _launch_rows(apply_bitmatrix_cuda, chunks, r, w, packetsize,
                        "plain", rows, s * w)


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
    return _launch_rows(apply_bitmatrix_xor_cuda, chunks, r, w, packetsize,
                        "schedule", sched_static, n_in)


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
            f"({lib.gf8x_error_string(err).decode()})")
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


# -- the GF(2) bit-plane product on the tensor cores ---------------------------

_mmalib_state = None


def _mmalib():
    global _mmalib_state
    if _mmalib_state is None:
        lib = load("gf2_bitplane_mma")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.gf2_mma_apply.argtypes = [
            vp, vp, vp, ll, ll, ll, ll, ll, ll, i, i, i, i, i, vp]
        lib.gf2_mma_apply.restype = i
        lib.gf2_mma_error_string.argtypes = [i]
        lib.gf2_mma_error_string.restype = ctypes.c_char_p
        lib.gf2_mma_tile_m.restype = i
        lib.gf2_mma_tile_k.restype = i
        tiles = (lib.gf2_mma_tile_m(), lib.gf2_mma_tile_k())
        if tiles != (MMA_TILE_M, MMA_TILE_K):
            raise KernelLaunchError(
                f"the bit-plane kernel takes tiles of {tiles}; the wrapper "
                f"pads the bitmatrix to {(MMA_TILE_M, MMA_TILE_K)}")
        _mmalib_state = lib
    return _mmalib_state


MMA_TILE_M, MMA_TILE_K = 64, 32   # bitmatrix rows / columns per kernel tile


@functools.lru_cache(maxsize=256)
def _device_bitmatrix(matrix_t, device: torch.device) -> torch.Tensor:
    """The (8r, 8s) GF(2) bitmatrix of ``matrix_t`` as int8 0/1 on
    ``device``, zero-padded to whole (MMA_TILE_M, MMA_TILE_K) tiles:
    built once per matrix, then kernel data."""
    bm = mxu_bitmatrix(matrix_t)
    rows = -(-bm.shape[0] // MMA_TILE_M) * MMA_TILE_M
    cols = -(-bm.shape[1] // MMA_TILE_K) * MMA_TILE_K
    padded = np.zeros((rows, cols), dtype=np.int8)
    padded[:bm.shape[0], :bm.shape[1]] = bm
    tel.note_kernel_setup()
    return torch.from_numpy(padded).to(device)


def _launch_mma(fn, x: torch.Tensor, out: torch.Tensor, batch: int,
                nbytes: int, in_strides: tuple[int, int],
                out_strides: tuple[int, int], matrix_t) -> None:
    """Run the bit-plane kernel on the current stream, counted on
    ``fn``."""
    lib = _mmalib()
    bm = _device_bitmatrix(matrix_t, x.device)
    err = lib.gf2_mma_apply(
        x.data_ptr(), out.data_ptr(), bm.data_ptr(), batch, nbytes,
        *in_strides, *out_strides, len(matrix_t), len(matrix_t[0]),
        bm.shape[0], bm.shape[1], *device_and_stream(x))
    if err:
        raise KernelLaunchError(
            f"{fn.__name__} failed: CUDA error {err} "
            f"({lib.gf2_mma_error_string(err).decode()})")
    fn.launches += 1


def apply_matrix_mxu_cuda(chunks: torch.Tensor, matrix_t) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to (..., s, C) uint8 chunks ->
    (..., r, C) as a GF(2) bit-plane product on the tensor cores (the
    reference's MXU tier).  Any C; the chunk dimension may be strided
    as long as each chunk's bytes are contiguous."""
    static = _static(matrix_t)
    r, s, _ = _matrix_info(static)
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s:
        raise ValueError(f"need (..., {s}, C) uint8 chunks, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    if chunks.device.type == "cpu":
        return apply_matrix_mxu_torch(chunks, static)
    _check_cuda(chunks)
    if chunks.stride(-1) != 1:
        raise ValueError("chunk bytes must be contiguous (stride 1)")
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    out = torch.empty(lead + (r, c), dtype=torch.uint8, device=chunks.device)
    if out.numel() == 0:
        return out
    batch, bstride = _merged_batch(chunks, chunks.dim() - 2, 1)
    _launch_mma(apply_matrix_mxu_cuda, chunks, out, batch, c,
                (bstride, chunks.stride(-2)), (r * c, c), static)
    return out


def apply_matrix_mxu_cuda_packed(words: torch.Tensor, matrix_t
                                 ) -> torch.Tensor:
    """Packed-layout twin: (..., s, R, 128) uint32 -> (..., r, R, 128),
    the same kernel on the free uint8 view of the words.  Each chunk's
    (R, 128) words must be contiguous; the chunk dimension may be
    strided."""
    static = _static(matrix_t)
    r, s, _ = _matrix_info(static)
    if words.dtype != torch.uint32 or words.dim() < 3 \
            or words.shape[-3] != s or words.shape[-1] != LANE:
        raise ValueError(f"need (..., {s}, R, {LANE}) uint32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return pack_chunks(apply_matrix_mxu_torch(unpack_chunks(words),
                                                  static))
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
    _launch_mma(apply_matrix_mxu_cuda_packed, words, out, batch, nbytes,
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

def apply_matrix_numpy(chunks: torch.Tensor, matrix_t, w: int = 8
                       ) -> torch.Tensor:
    """The host tier on a CPU tensor's bytes: for w=8
    ``xor_schedule.host_matrix_apply`` (the identical XOR schedule when
    one is preferred, the regionops ground truth otherwise), for w=16/32
    ``regionops.matrix_encode``."""
    if chunks.device.type != "cpu":
        raise ValueError(f"tensor on {chunks.device}: the numpy tier "
                         f"takes CPU tensors")
    mat = np.asarray(matrix_t, dtype=np.int64)
    if w == 8:
        out = host_matrix_apply(chunks.detach().numpy(), mat,
                                _static(matrix_t), 8)
    else:
        out = regionops.matrix_encode(chunks.detach().numpy(), mat, w)
    return torch.from_numpy(out)


# -- selection and dispatch ---------------------------------------------------

# nonzeros at or above which the reference sends a matrix without a
# preferred schedule to its MXU tier (mxu_matrix_min's default); the
# preference probe reads it
MXU_MATRIX_MIN = 2048


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
    to (the probe is cached: a dict hit per call)."""
    return preferred_schedule(_static(matrix_t), 8,
                              mxu_min=MXU_MATRIX_MIN).static


@functools.lru_cache(maxsize=256)
def _matrix_nnz(matrix_t) -> int:
    """Nonzero coefficients of a static table.  Cached: it runs in the
    per-call dispatch, and a clay composite has 45k coefficients."""
    return sum(1 for row in matrix_t for v in row if v)


def select_matrix_engine(w: int = 8, device=None,
                         engine: str | None = None, *, shape=None,
                         matrix_t=None, packed: bool = False) -> str:
    """THE engine-selection table for GF(2^w) matrix applies (w in
    {8, 16, 32}) and GF(2) bitmatrix applies (``w`` then names the
    packet count of a block), reduced to the rows the port has.
    Returns one of:

    - "numpy": the host tier, only when forced on CPU tensors;
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
               CUDA tensor (clay's composites): the GF(2) bit-plane
               product on the tensor cores (``apply_matrix_mxu_cuda``);
    - "cuda":  a hand-written kernel for every other CUDA tensor: the
               dense w=8 bytes or packed kernel (any table size:
               ``matrix_kernel_fits``), the w=16/32 word kernel, or a
               bitmatrix kernel;
    - "torch": the plain torch tier — CPU tensors, and a forced torch
               tier on CPU tensors.

    The order is the reference's (``ceph_tpu/ops/pallas_gf.py``): the
    numpy tier first, then the xor row, then the mxu row and the device
    tier, which only a device tensor reaches (the reference's "xla" is
    the port's "torch").  ``engine`` forces a tier for this call in
    place of the process policy; like the policy's, a forced torch or
    numpy tier raises for a CUDA ``device``, so a card tensor never
    leaves the kernels.  Not ported: the mesh row (it comes with the
    data plane) and the tuned pins and cutover (with the tuning table).
    """
    if w < 1:
        raise ValueError(f"w={w} must be positive")
    policy = global_policy() if engine is None else FallbackPolicy(engine)
    eng = policy.engine(device)
    if eng == "numpy":
        return "numpy"
    static = _static(matrix_t) if matrix_t else None
    if (w == 8 and static
            and (packed or (shape is not None and len(shape) >= 2
                            and shape[-1] % 4 == 0))):
        sched = preferred_schedule(static, 8, mxu_min=MXU_MATRIX_MIN)
        if sched is not None and xor_program_fits(sched.static):
            return "xor"
    if eng == "cuda" and w == 8 and static \
            and _matrix_nnz(static) >= MXU_MATRIX_MIN:
        return "mxu"
    return eng


def apply_matrix_best(chunks: torch.Tensor, matrix_t, w: int = 8
                      ) -> torch.Tensor:
    """Bytes/words-layout dispatch through select_matrix_engine;
    byte-identical in every branch."""
    if w not in WORD_DTYPE:
        raise ValueError(f"GF(2^w) matrix applies take w in 8, 16, 32, "
                         f"got w={w}")
    eng = select_matrix_engine(w, chunks.device, shape=tuple(chunks.shape),
                               matrix_t=matrix_t)
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


def apply_matrix_packed_best(words: torch.Tensor, matrix_t) -> torch.Tensor:
    """Packed-layout dispatch: (..., s, R, 128) uint32 ->
    (..., r, R, 128); byte-identical in every branch."""
    eng = select_matrix_engine(8, words.device, shape=tuple(words.shape),
                               matrix_t=matrix_t, packed=True)
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
    """The least pool page count for the page-skipping kernel: the
    reference's ``tuned_ragged_cutover`` seam, here always
    RAGGED_MIN_PAGES (the port has no tune table).  Below it the mask
    tier runs, byte-identically."""
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
               XOR-schedule or bit-plane kernel on the card);
    - "numpy": the numpy tier was forced (CPU tensors only).
    """
    inner = select_matrix_engine(w, device, engine, shape=tuple(shape),
                                 matrix_t=matrix_t, packed=packed)
    if inner == "numpy":
        return "numpy"
    if inner == "cuda" and shape[0] >= tuned_ragged_cutover():
        return "cuda"
    return "mask"


def _host_apply_bytes_ragged(pool: torch.Tensor, matrix_t,
                             mask: torch.Tensor) -> torch.Tensor:
    """Numpy ground truth of the ragged bytes dispatch: the host apply
    on the live pages only, scattered into zeros."""
    arr = pool.detach().numpy()
    live = mask.numpy() != 0
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


def apply_matrix_best_ragged(pool: torch.Tensor, matrix_t,
                             mask: torch.Tensor, w: int = 8
                             ) -> torch.Tensor:
    """Ragged dispatch over a page pool (P, s, page) of w-bit words under
    a (P,) activity mask -> (P, r, page), dead pages zero in every
    branch.  w=16/32 pools take the mask tier, as in the reference (the
    word kernel has no ragged variant)."""
    if pool.dim() != 3:
        raise ValueError(f"need a (P, s, page) pool, got "
                         f"{tuple(pool.shape)}")
    mask = _page_mask(pool, mask)
    if w != 8:
        return apply_matrix_best(mask_pages(pool, mask), matrix_t, w)
    eng = select_ragged_engine(pool.shape, matrix_t, 8, device=pool.device)
    with tel.record_dispatch("ops_apply_matrix_ragged", engine=eng,
                             layout="bytes"):
        if eng == "cuda":
            return apply_matrix_cuda_ragged(pool, matrix_t, mask)
        if eng == "numpy":
            return _host_apply_bytes_ragged(pool, matrix_t, mask)
        return apply_matrix_best(mask_pages(pool, mask), matrix_t, 8)


def apply_matrix_packed_best_ragged(words: torch.Tensor, matrix_t,
                                    mask: torch.Tensor) -> torch.Tensor:
    """Packed-layout ragged dispatch: a (P, s, R, 128) uint32 pool under
    a (P,) mask -> (P, r, R, 128), dead pages zero in every branch."""
    if words.dim() != 4:
        raise ValueError(f"need a (P, s, R, 128) pool, got "
                         f"{tuple(words.shape)}")
    mask = _page_mask(words, mask)
    eng = select_ragged_engine(words.shape, matrix_t, 8, packed=True,
                               device=words.device)
    with tel.record_dispatch("ops_apply_matrix_ragged", engine=eng,
                             layout="packed"):
        if eng == "cuda":
            return apply_matrix_cuda_packed_ragged(words, matrix_t, mask)
        if eng == "numpy":
            return _host_apply_packed_ragged(words, matrix_t, mask)
        return apply_matrix_packed_best(mask_pages(words, mask), matrix_t)


def apply_bitmatrix_numpy(chunks: torch.Tensor, bitmatrix_rows, w: int,
                          packetsize: int) -> torch.Tensor:
    """The host ground truth (``regionops.bitmatrix_encode``) on a CPU
    tensor's bytes."""
    if chunks.device.type != "cpu":
        raise ValueError(f"tensor on {chunks.device}: the numpy tier "
                         f"takes CPU tensors")
    sw = chunks.shape[-2] * w
    bits = np.array([[(int(m) >> c) & 1 for c in range(sw)]
                     for m in bitmatrix_rows], dtype=np.uint8)
    return torch.from_numpy(regionops.bitmatrix_encode(
        chunks.detach().numpy(), bits, w, packetsize))


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
    math."""
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
    "BY_VALUE_MAX_COEF", "MAX_TABLE_COEF", "MXU_MATRIX_MIN",
    "RAGGED_MIN_PAGES", "WRAPPERS", "XOR_SMEM_BUDGET",
    "apply_bitmatrix_best", "apply_bitmatrix_cuda", "apply_bitmatrix_numpy",
    "apply_bitmatrix_xor_cuda", "apply_matrix_best",
    "apply_matrix_best_ragged", "apply_matrix_cuda",
    "apply_matrix_cuda_packed", "apply_matrix_cuda_packed_ragged",
    "apply_matrix_cuda_ragged", "apply_matrix_cuda_words",
    "apply_matrix_mxu_cuda", "apply_matrix_mxu_cuda_packed",
    "apply_matrix_numpy", "apply_matrix_packed_best",
    "apply_matrix_packed_best_ragged", "apply_matrix_xor_cuda",
    "apply_matrix_xor_cuda_packed", "bitmatrix_op_count", "dense_op_count",
    "launch_counts", "mask_pages", "matrix_kernel_fits", "pack_chunks",
    "pack_rows",
    "pack_word_program", "reset_launch_counts", "schedule_op_count",
    "select_matrix_engine", "select_ragged_engine", "sm90_op_count",
    "tuned_ragged_cutover", "unpack_chunks", "xor_program_fits",
    "xor_schedule_op_count",
]
