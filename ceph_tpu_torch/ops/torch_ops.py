"""The torch tier: GF(2^w) matrix and GF(2) bitmatrix applies written
in plain torch ops.

Counterpart of ``ceph_tpu/ops/xla_ops.py`` (``apply_matrix_xla``, its
SWAR helpers, ``apply_bitmatrix_xla``) and of
``ceph_tpu/ops/pallas_gf.py::apply_bitmatrix_xor_xla``.  These are the
plain versions that stand beside the hand-written CUDA kernels
(``ops/gf_kernels.py``): the CPU tests run them, and ``chip_smoke.py``
holds each kernel against its plain version on the card.

- :func:`apply_matrix_torch` — GF(2^w) matrix, w in {8, 16, 32};
- :func:`apply_bitmatrix_torch` — jerasure packet-layout GF(2)
  bitmatrix, one XOR chain per output packet (the row-mask walk);
- :func:`apply_bitmatrix_xor_torch` — the same product through a CSE
  schedule (``ops/xor_schedule.py``) over packet views;
- :func:`apply_matrix_xor_torch` — a GF(2^8) matrix through its XOR
  schedule (``xt`` / ``shl`` / ``shr`` / ``xor`` on SWAR words), the twin
  of ``ceph_tpu/ops/pallas_gf.py::apply_matrix_xor_xla``;
- :func:`apply_matrix_ragged_torch` / :func:`apply_matrix_packed_ragged_torch`
  — the GF(2^8) matrix over a page pool under a (P,) activity mask: the
  dead pages zeroed by :func:`mask_pages`, then :func:`apply_matrix_torch`
  (the reference's mask tier);
- :func:`apply_matrix_mxu_torch` — a GF(2^8) matrix as one GF(2)
  product of its (8r, 8s) bitmatrix (:func:`mxu_bitmatrix`) with the
  input's LSB-first bit-planes, the twin of
  ``ceph_tpu/ops/xla_ops.py::apply_matrix_mxu``.

The math is the reference's SWAR walk: four GF(2^8) field bytes (or
two GF(2^16) halfwords, or one GF(2^32) word) packed in a 32-bit
lane, one xtime doubling chain per input chunk, and plane ``t`` of
chunk ``j`` XORed into every output row whose coefficient has bit
``t`` set.  torch has little ``uint32`` arithmetic, so the lanes are
``int32`` with explicit masks: ``>>`` on a negative ``int32``
sign-extends, which is why every ``hi >> (w-1)`` is masked back to the
per-element low bit before the feedback multiply.  Left shifts wrap
(two's complement) on both CPU and CUDA, and the element MSBs are
cleared before the shift, so no bit crosses an element boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..gf.bitmatrix import value_to_bitmatrix
from ..gf.gf8 import DEFAULT_POLY

# w-bit word dtype of each field width (the words view of a byte region)
WORD_DTYPE = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}


class StaticMatrix(tuple):
    """A coefficient table as a tuple of row tuples that hashes once.

    The schedule and kernel-data caches key on the table on every call,
    and a tuple does not keep its hash: a clay composite of 131072
    coefficients would be hashed anew by each lookup.  Equal to, and
    hashing as, the plain tuple of tuples."""

    def __hash__(self) -> int:
        try:
            return self._hash
        except AttributeError:
            self._hash = tuple.__hash__(self)
            return self._hash


def matrix_to_static(matrix) -> StaticMatrix:
    """Numpy (r, k) matrix -> hashable tuple-of-tuples (cache keys, and
    the coefficient list the kernel wrappers take)."""
    return StaticMatrix(tuple(int(x) for x in row)
                        for row in np.asarray(matrix))


def bitmatrix_to_static(bitmatrix) -> tuple[int, ...]:
    """Numpy (rw, kw) 0/1 matrix -> tuple of per-row column bitmasks
    (bit c of row i set when bitmatrix[i, c] is 1)."""
    bm = np.asarray(bitmatrix)
    return tuple(int("".join(str(int(b)) for b in row[::-1]), 2)
                 for row in bm)


def _s32(x: int) -> int:
    """An unsigned 32-bit constant as the int32 scalar with its bits."""
    return x - (1 << 32) if x >= (1 << 31) else x


_HI8, _LO8 = _s32(0x80808080), 0x01010101
_HI16, _LO16 = _s32(0x80008000), 0x00010001
_HI32 = _s32(0x80000000)
GF8_FEEDBACK = DEFAULT_POLY[8] & 0xFF            # 0x1d
GF16_FEEDBACK = DEFAULT_POLY[16] & 0xFFFF        # 0x100b
GF32_FEEDBACK = DEFAULT_POLY[32] & 0xFFFFFFFF    # 0x400007


def xtime_swar8(v: torch.Tensor) -> torch.Tensor:
    """xtime on int32 lanes each packing 4 independent GF(2^8) bytes."""
    hi = v & _HI8
    return ((v ^ hi) << 1) ^ (((hi >> 7) & _LO8) * GF8_FEEDBACK)


def xtime_swar16(v: torch.Tensor) -> torch.Tensor:
    """xtime on int32 lanes each packing 2 little-endian GF(2^16)
    halfwords."""
    hi = v & _HI16
    return ((v ^ hi) << 1) ^ (((hi >> 15) & _LO16) * GF16_FEEDBACK)


def xtime_swar32(v: torch.Tensor) -> torch.Tensor:
    """xtime on int32 lanes, one GF(2^32) word per lane."""
    hi = v & _HI32
    return ((v ^ hi) << 1) ^ (((hi >> 31) & 1) * GF32_FEEDBACK)


def xtime_swar(v: torch.Tensor, w: int) -> torch.Tensor:
    """Dispatch: xtime over int32 SWAR lanes for w in {8, 16, 32}."""
    if w == 8:
        return xtime_swar8(v)
    if w == 16:
        return xtime_swar16(v)
    if w == 32:
        return xtime_swar32(v)
    raise ValueError(f"no SWAR xtime for w={w}")


def torch_words_view(data: torch.Tensor, w: int) -> torch.Tensor:
    """(..., C) uint8 tensor -> (..., C/(w/8)) w-bit word view (no copy
    when the last dimension is contiguous)."""
    if w == 8:
        return data
    if data.shape[-1] % (w // 8):
        raise ValueError(f"chunk size {data.shape[-1]} is not a whole "
                         f"number of {w}-bit words")
    if data.stride(-1) != 1:
        data = data.contiguous()
    return data.view(WORD_DTYPE[w])


def torch_bytes_view(words: torch.Tensor) -> torch.Tensor:
    """w-bit word tensor -> uint8 bytes (inverse of torch_words_view)."""
    if words.dtype == torch.uint8:
        return words
    if words.stride(-1) != 1:
        words = words.contiguous()
    return words.view(torch.uint8)


def _lanes(byts: torch.Tensor) -> torch.Tensor:
    """(..., c) uint8 -> (..., ceil(c/4)) int32 lanes; a tail short of a
    whole lane is zero-padded (zero bytes map to zero bytes under any
    GF(2^w) matrix, and the pad is cut off again by the caller)."""
    pad = (-byts.shape[-1]) % 4
    if pad:
        byts = F.pad(byts, (0, pad))
    elif byts.stride(-1) != 1 or byts.storage_offset() % 4 or any(
            st % 4 for st in byts.stride()[:-1]):
        byts = byts.contiguous()
        if byts.storage_offset() % 4:
            byts = byts.clone()
    return byts.view(torch.int32)


def apply_matrix_torch(chunks: torch.Tensor, matrix_t, w: int = 8
                       ) -> torch.Tensor:
    """Apply a (r, s) GF(2^w) matrix to (..., s, C) words -> (..., r, C).

    ``chunks`` has the w-bit word dtype (uint8, uint16 or uint32), on
    any device; the result has the same dtype and device.  The same
    contract as ``ceph_tpu.ops.xla_ops.apply_matrix_xla``.
    """
    r = len(matrix_t)
    s = len(matrix_t[0]) if r else 0
    if w not in WORD_DTYPE or chunks.dtype != WORD_DTYPE[w]:
        raise ValueError(f"w={w} needs {WORD_DTYPE.get(w)} words, "
                         f"got {chunks.dtype}")
    if chunks.dim() < 2 or chunks.shape[-2] != s or r == 0:
        raise ValueError(f"chunks {tuple(chunks.shape)} do not fit a "
                         f"({r}, {s}) matrix")
    byts = torch_bytes_view(chunks)
    c = byts.shape[-1]
    lanes = _lanes(byts)
    accs: list = [None] * r
    for j in range(s):
        col = [int(matrix_t[i][j]) for i in range(r)]
        top = max(x.bit_length() for x in col)
        if top == 0:
            continue
        plane = lanes[..., j, :]
        for t in range(top):
            if t:
                plane = xtime_swar(plane, w)
            for i in range(r):
                if (col[i] >> t) & 1:
                    accs[i] = plane if accs[i] is None else accs[i] ^ plane
    zero = torch.zeros_like(lanes[..., 0, :])
    out = torch.stack([zero if a is None else a for a in accs], dim=-2)
    out = out.view(torch.uint8)[..., :c]
    return out.contiguous().view(chunks.dtype)


def mask_pages(pool: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the dead pages of a (P, ...) pool by multiplying with the
    (P,) {0,1} mask, on the pool's bytes (any word dtype; torch has no
    uint32 multiply).  The twin of ``ceph_tpu.ops.pallas_gf.mask_pages``:
    a page's values are field elements, so scaling by 0 or 1 is the page
    predicate, and GF linearity makes a zero page's product zero."""
    if mask.dim() != 1 or mask.shape[0] != pool.shape[0]:
        raise ValueError(f"mask {tuple(mask.shape)} does not fit a pool "
                         f"of {pool.shape[0]} pages")
    byts = pool.contiguous().view(torch.uint8)
    live = (mask != 0).to(torch.uint8).reshape(
        (pool.shape[0],) + (1,) * (pool.dim() - 1))
    return (byts * live).view(pool.dtype)


def apply_matrix_ragged_torch(pool: torch.Tensor, matrix_t,
                              mask: torch.Tensor, w: int = 8
                              ) -> torch.Tensor:
    """Apply a (r, s) GF(2^w) matrix to a page pool (P, s, page) of
    w-bit words under a (P,) activity mask -> (P, r, page), dead pages
    zero.  The plain version of ``gf_kernels.apply_matrix_cuda_ragged``."""
    if pool.dim() != 3:
        raise ValueError(f"need a (P, s, page) pool, got "
                         f"{tuple(pool.shape)}")
    return apply_matrix_torch(mask_pages(pool, mask), matrix_t, w)


def apply_matrix_packed_ragged_torch(words: torch.Tensor, matrix_t,
                                     mask: torch.Tensor) -> torch.Tensor:
    """Packed twin: a (P, s, R, 128) uint32 pool -> (P, r, R, 128),
    dead pages zero.  The plain version of
    ``gf_kernels.apply_matrix_cuda_packed_ragged``."""
    if words.dtype != torch.uint32 or words.dim() != 4:
        raise ValueError(f"need a (P, s, R, 128) uint32 pool, got "
                         f"{tuple(words.shape)} {words.dtype}")
    p, s, rows, lanes = words.shape
    byts = mask_pages(words, mask).view(torch.uint8).reshape(
        p, s, rows * lanes * 4)
    out = apply_matrix_torch(byts, matrix_t, 8)
    return out.contiguous().view(torch.uint32).reshape(
        p, out.shape[1], rows, lanes)


_LMASK8 = tuple(_s32(0x01010101 * ((0xFF << sh) & 0xFF)) for sh in range(8))
_RMASK8 = tuple(_s32(0x01010101 * (0xFF >> sh)) for sh in range(8))


def _xtime_taps8(v: torch.Tensor) -> torch.Tensor:
    """The schedule's mul-free xtime on int32 lanes: the feedback 0x1d
    as ``t ^ t<<2 ^ t<<3 ^ t<<4`` (``xor_schedule.xtime_words_xor``),
    with ``hi >> 7`` masked back to each byte's low bit."""
    hi = v & _HI8
    t = (hi >> 7) & _LO8
    return ((v ^ hi) << 1) ^ t ^ (t << 2) ^ (t << 3) ^ (t << 4)


def apply_matrix_xor_torch(chunks: torch.Tensor, sched_static
                           ) -> torch.Tensor:
    """Run a GF(2^8) XOR schedule (``xor_schedule.XorSchedule.static``)
    over (..., s, C) uint8 chunks, C % 4 == 0 -> (..., r, C): the
    schedule's op list on int32 SWAR lanes.  ``shr`` masks off what the
    arithmetic ``>>`` drags in from the sign bit.  The same contract as
    ``ceph_tpu.ops.pallas_gf.apply_matrix_xor_xla``."""
    _, s, r, ops, outputs = sched_static
    c = chunks.shape[-1] if chunks.dim() else 0
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s or c % 4:
        raise ValueError(f"need (..., {s}, C) uint8 chunks with C % 4 == "
                         f"0, got {tuple(chunks.shape)} {chunks.dtype}")
    lanes = _lanes(chunks)
    nodes = [lanes[..., j, :] for j in range(s)]
    for op in ops:
        kind = op[0]
        if kind == "xor":
            nodes.append(nodes[op[1]] ^ nodes[op[2]])
        elif kind == "xt":
            nodes.append(_xtime_taps8(nodes[op[1]]))
        elif kind == "shl":
            nodes.append((nodes[op[1]] << op[2]) & _LMASK8[op[2]])
        elif kind == "shr":
            nodes.append((nodes[op[1]] >> op[2]) & _RMASK8[op[2]])
        else:
            raise ValueError(f"unknown schedule op {op}")
    zero = torch.zeros_like(lanes[..., 0, :])
    out = torch.stack([nodes[o] if o >= 0 else zero for o in outputs],
                      dim=-2)
    return out.view(torch.uint8).reshape(chunks.shape[:-2] + (r, c))


def _packet_view(chunks: torch.Tensor, w: int, packetsize: int
                 ) -> torch.Tensor:
    """(..., s, C) uint8 -> (..., s, nb, w, packetsize) packet view."""
    c = chunks.shape[-1]
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 or c == 0 \
            or c % (w * packetsize):
        raise ValueError(f"need (..., s, C) uint8 chunks with C a "
                         f"multiple of w*packetsize = {w * packetsize}, "
                         f"got {tuple(chunks.shape)} {chunks.dtype}")
    return chunks.reshape(chunks.shape[:-1] + (c // (w * packetsize), w,
                                               packetsize))


def _from_packet_rows(rows: list, lead: tuple, r: int, w: int, c: int
                      ) -> torch.Tensor:
    """r*w (..., nb, packetsize) output packets -> (..., r, C)."""
    out = torch.stack(rows, dim=-3)                  # (..., rw, nb, p)
    out = out.reshape(lead + (r, w) + out.shape[-2:])
    return out.transpose(-3, -2).reshape(lead + (r, c))


def apply_bitmatrix_torch(chunks: torch.Tensor, bitmatrix_rows, w: int,
                          packetsize: int) -> torch.Tensor:
    """Apply a GF(2) bitmatrix in jerasure packet layout: (..., s, C)
    uint8 -> (..., r, C), C a multiple of w * packetsize.  Bit
    (j*w + lb) of row mask (i*w + l) set means output packet (i, l)
    XORs input packet (j, lb).  The same contract as
    ``ceph_tpu.ops.xla_ops.apply_bitmatrix_xla``."""
    rw = len(bitmatrix_rows)
    if rw == 0 or rw % w:
        raise ValueError(f"{rw} bitmatrix rows are not a multiple of w={w}")
    dv = _packet_view(chunks, w, packetsize)
    s = chunks.shape[-2]
    if any(int(m) >> (s * w) for m in bitmatrix_rows):
        raise ValueError(f"bitmatrix rows reach past {s} input chunks")
    rows = []
    for mask in bitmatrix_rows:
        mask = int(mask)
        acc = None
        col = 0
        while mask:
            if mask & 1:
                j, lb = divmod(col, w)
                p = dv[..., j, :, lb, :]
                acc = p if acc is None else acc ^ p
            mask >>= 1
            col += 1
        rows.append(torch.zeros_like(dv[..., 0, :, 0, :]) if acc is None
                    else acc)
    return _from_packet_rows(rows, tuple(chunks.shape[:-2]), rw // w, w,
                             chunks.shape[-1])


def apply_bitmatrix_xor_torch(chunks: torch.Tensor, sched_static, w: int,
                              packetsize: int) -> torch.Tensor:
    """The packet-layout bitmatrix product through a pure-XOR schedule
    (``xor_schedule.probe_bitmatrix_schedule(...).static``): inputs are
    the s*w packets of each block, CSE temps are shared, outputs are the
    r*w parity packets.  The same contract as
    ``ceph_tpu.ops.pallas_gf.apply_bitmatrix_xor_xla``."""
    from .xor_schedule import eval_schedule_u8
    _, n_in, rw, _, _ = sched_static
    if rw % w or n_in % w:
        raise ValueError(f"schedule ({n_in} in, {rw} out) does not fit "
                         f"w={w}")
    dv = _packet_view(chunks, w, packetsize)
    if chunks.shape[-2] * w < n_in:
        raise ValueError(f"schedule reads {n_in // w} chunks, got "
                         f"{chunks.shape[-2]}")
    ins = [dv[..., idx // w, :, idx % w, :] for idx in range(n_in)]
    outs = eval_schedule_u8(sched_static, ins,
                            lambda: torch.zeros_like(ins[0]))
    return _from_packet_rows(outs, tuple(chunks.shape[:-2]), rw // w, w,
                             chunks.shape[-1])


@functools.lru_cache(maxsize=1)
def _value_bitmatrices() -> np.ndarray:
    """(256, 8, 8): the GF(2) bitmatrix of every GF(2^8) value."""
    return np.stack([value_to_bitmatrix(e, 8) for e in range(256)])


@functools.lru_cache(maxsize=256)
def mxu_bitmatrix(matrix_t) -> np.ndarray:
    """The (8r, 8s) uint8 GF(2) bitmatrix of a (r, s) GF(2^8) table
    (hashable tuple of tuples): block (i, j) is the bitmatrix of M[i][j]
    (column x = the bits of M[i][j] * 2^x), as
    ``gf.bitmatrix.matrix_to_bitmatrix(s, r, 8, M)`` lays it out, built
    by table lookup."""
    mat = np.asarray(matrix_t, dtype=np.int64)
    r, s = mat.shape
    blocks = _value_bitmatrices()[mat]              # (r, s, 8, 8)
    return np.ascontiguousarray(blocks.transpose(0, 2, 1, 3).reshape(
        8 * r, 8 * s))


def apply_matrix_mxu_torch(chunks: torch.Tensor, matrix_t) -> torch.Tensor:
    """Apply a (r, s) GF(2^8) matrix to (..., s, C) uint8 -> (..., r, C)
    as one GF(2) product: the (8r, 8s) bitmatrix times the LSB-first
    bit-planes of the input (row 8j + x = bit x of chunk j), in float32
    (exact: 0/1 operands, sums at most 8s < 2^24), then ``& 1`` and the
    bit repack.  The same contract as
    ``ceph_tpu.ops.xla_ops.apply_matrix_mxu``; the plain version of
    ``gf_kernels.apply_matrix_mxu_cuda``."""
    static = tuple(tuple(int(x) for x in row) for row in matrix_t)
    r = len(static)
    s = len(static[0]) if r else 0
    if chunks.dtype != torch.uint8 or chunks.dim() < 2 \
            or chunks.shape[-2] != s or r == 0:
        raise ValueError(f"need (..., {s}, C) uint8 chunks for a ({r}, "
                         f"{s}) matrix, got {tuple(chunks.shape)} "
                         f"{chunks.dtype}")
    if 8 * s >= 1 << 24:
        raise ValueError(f"a matrix {s} columns wide overflows the exact "
                         f"float32 sum")
    lead, c = tuple(chunks.shape[:-2]), chunks.shape[-1]
    bm = torch.from_numpy(mxu_bitmatrix(static)).to(chunks.device,
                                                     torch.float32)
    planes = torch.arange(8, dtype=torch.uint8, device=chunks.device)
    bits = (chunks[..., :, None, :] >> planes[:, None]) & 1
    x = bits.reshape(lead + (8 * s, c)).to(torch.float32)
    par = (torch.matmul(bm, x).to(torch.int32) & 1).to(torch.uint8)
    par = par.reshape(lead + (r, 8, c)) << planes[:, None]
    return par.sum(dim=-2).to(torch.uint8)
