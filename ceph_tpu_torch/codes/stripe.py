"""ECUtil analog — stripe geometry + batched whole-object EC transforms.

A copy of ``ceph_tpu/codes/stripe.py`` (pure numpy).  Reference:
src/osd/ECUtil.{h,cc} → stripe_info_t (stripe_width / chunk_size,
logical↔chunk offset math used by ECBackend to turn client extents into
shard extents), ECUtil::encode / ECUtil::decode (the per-stripe loops
feeding the plugin), and ECUtil::HashInfo (cumulative per-shard crc32c
guarding recovered shards); src/common/crc32c.h → ceph_crc32c
(sctp/Castagnoli table form).

The reference encodes stripe by stripe (ECUtil.cc loops ``for (uint64_t
i = 0; i < in.length(); i += sinfo.stripe_width)``); here the whole
object is reshaped to (n_stripes, k, chunk_size) and runs through the
plugin's batched array API in ONE call (``encode_chunks_batch`` /
``decode_chunks_batch``: the host tier below the code's
``min_xla_bytes``, its device above) — the batch dimension is the
parallelism axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

# -- ceph_crc32c (src/common/crc32c.h; sctp table implementation) --------

_CRC32C_POLY = 0x82F63B78  # Castagnoli, reflected


def _make_table() -> np.ndarray:
    tab = np.empty(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        tab[i] = c
    return tab


_CRC_TABLE = _make_table()
_CRC_TABLE32 = _CRC_TABLE.astype(np.uint32)


def _crc_scalar(crc: int, data: np.ndarray) -> int:
    tab = _CRC_TABLE
    for b in data:
        crc = ((crc >> 8) ^ int(tab[(crc ^ int(b)) & 0xFF])) & 0xFFFFFFFF
    return crc


def _advance1_matrix() -> np.ndarray:
    """GF(2) matrix (as 32 uint32 basis images) advancing a CRC state
    through ONE zero byte: s' = (s >> 8) ^ T[s & 0xFF].  The CRC step
    is GF(2)-linear in the state, so zero-byte advancement composes by
    matrix multiplication (the zlib crc32_combine construction)."""
    cols = np.empty(32, dtype=np.uint32)
    for bit in range(32):
        s = np.uint32(1 << bit)
        cols[bit] = (s >> np.uint32(8)) ^ _CRC_TABLE32[int(s) & 0xFF]
    return cols


def _mat_apply(mat: np.ndarray, v: int) -> int:
    bits = (v >> np.arange(32, dtype=np.uint64)) & 1
    sel = mat[bits.astype(bool)[:mat.size]]
    return int(np.bitwise_xor.reduce(sel)) if sel.size else 0


def _mat_apply_vec(mat: np.ndarray, v: np.ndarray) -> np.ndarray:
    """_mat_apply over a VECTOR of CRC states at once (uint32 in/out):
    out = XOR of basis images mat[b] wherever state bit b is set."""
    out = np.zeros_like(v)
    for b in range(32):
        out ^= np.where((v >> np.uint32(b)) & np.uint32(1),
                        mat[b], np.uint32(0))
    return out


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([_mat_apply(a, int(c)) for c in b], dtype=np.uint32)


_ADVANCE_CACHE: Dict[int, np.ndarray] = {}


def _advance_matrix(n: int) -> np.ndarray:
    """Matrix advancing a CRC through n zero bytes (binary powering)."""
    hit = _ADVANCE_CACHE.get(n)
    if hit is not None:
        return hit
    result = None
    sq = _advance1_matrix()
    k = n
    while k:
        if k & 1:
            result = sq if result is None else _mat_mul(sq, result)
        k >>= 1
        if k:
            sq = _mat_mul(sq, sq)
    if result is None:
        result = np.array([np.uint32(1 << b) for b in range(32)],
                          dtype=np.uint32)
    _ADVANCE_CACHE[n] = result
    return result


_BLOCK = 4096  # lanes process one block column per python-level step


def ceph_crc32c(crc: int, data: bytes) -> int:
    """crc32c.h → ceph_crc32c: raw sctp CRC step, NO pre/post
    inversion (callers seed with -1 where the standard demands it).

    Large buffers run block-parallel: the buffer splits into _BLOCK-byte
    lanes whose states step together in numpy (byte position i of every
    lane per iteration), then fold left-to-right with the zero-advance
    matrix — exact, by GF(2) linearity of the CRC step.  Verified
    against the scalar loop in tests/test_torch_stripe.py."""
    crc &= 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size < 2 * _BLOCK:
        return _crc_scalar(crc, buf)
    n_blocks = buf.size // _BLOCK
    body = buf[:n_blocks * _BLOCK].reshape(n_blocks, _BLOCK)
    # all lanes from state 0, stepping one byte column at a time
    states = np.zeros(n_blocks, dtype=np.uint32)
    tab = _CRC_TABLE32
    for i in range(_BLOCK):
        states = (states >> np.uint32(8)) ^ tab[
            (states ^ body[:, i]) & np.uint32(0xFF)]
    # fold: crc(A||B) = advance(crc(A), len(B)) ^ crc0(B)
    adv = _advance_matrix(_BLOCK)
    out = crc
    for s in states:
        out = _mat_apply(adv, out) ^ int(s)
    return _crc_scalar(out, buf[n_blocks * _BLOCK:])


def ceph_crc32c_batch(crcs, bufs: np.ndarray) -> np.ndarray:
    """Vectorized ceph_crc32c across MANY equal-length buffers: (B,)
    seed states + (B, L) uint8 rows -> (B,) uint32 CRCs.

    The scrub pipeline's verify step: all shards of an object (or all
    chunks of a stripe batch) hash in ONE call.  Same construction as
    ceph_crc32c — every _BLOCK-byte lane of every row steps together
    (one numpy op per byte column, B*n_blocks lanes wide), then the
    GF(2) zero-advance fold runs vectorized across rows
    (_mat_apply_vec).  Byte-identical to the scalar loop; pinned in
    tests/test_torch_stripe.py."""
    bufs = np.ascontiguousarray(bufs)
    if bufs.dtype != np.uint8 or bufs.ndim != 2:
        raise ValueError("bufs must be a (B, L) uint8 array")
    b_rows, length = bufs.shape
    out = np.asarray(crcs, dtype=np.uint64).astype(np.uint32)
    if out.shape != (b_rows,):
        raise ValueError(f"need {b_rows} seed crcs, got {out.shape}")
    if length < 2 * _BLOCK:
        return np.array([_crc_scalar(int(out[i]), bufs[i])
                         for i in range(b_rows)], dtype=np.uint32)
    n_blocks = length // _BLOCK
    body = bufs[:, :n_blocks * _BLOCK].reshape(b_rows, n_blocks, _BLOCK)
    states = np.zeros((b_rows, n_blocks), dtype=np.uint32)
    tab = _CRC_TABLE32
    for i in range(_BLOCK):
        states = (states >> np.uint32(8)) ^ tab[
            (states ^ body[:, :, i]) & np.uint32(0xFF)]
    adv = _advance_matrix(_BLOCK)
    for j in range(n_blocks):
        out = _mat_apply_vec(adv, out) ^ states[:, j]
    tail = bufs[:, n_blocks * _BLOCK:]
    return np.array([_crc_scalar(int(out[i]), tail[i])
                     for i in range(b_rows)], dtype=np.uint32)


class HashInfo:
    """ECUtil.h → ECUtil::HashInfo: cumulative per-shard crc32c over
    everything ever appended to each shard (seeded -1, like the
    reference's `cumulative_shard_hashes(num_shards, -1)`)."""

    def __init__(self, num_shards: int) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * num_shards

    def append(self, old_size: int, to_append: Dict[int, bytes]) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError("append at wrong offset "
                             f"({old_size} != {self.total_chunk_size})")
        sizes = {len(v) for v in to_append.values()}
        if len(sizes) > 1:
            raise ValueError("uneven shard appends")
        for shard, data in to_append.items():
            self.cumulative_shard_hashes[shard] = ceph_crc32c(
                self.cumulative_shard_hashes[shard], data)
        self.total_chunk_size += sizes.pop() if sizes else 0

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]


# -- stripe_info_t -------------------------------------------------------

class StripeInfo:
    """ECUtil.h → stripe_info_t: the logical↔shard geometry of an EC
    object.  ``stripe_size`` is k (data chunk count), exactly like the
    reference constructor's first argument."""

    def __init__(self, stripe_size: int, stripe_width: int) -> None:
        if stripe_width % stripe_size:
            raise ValueError("stripe_width must divide evenly by k")
        self.stripe_size = stripe_size          # k
        self.stripe_width = stripe_width        # k * chunk_size
        self.chunk_size = stripe_width // stripe_size

    # offset math, names 1:1 with ECUtil.h
    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset + (self.stripe_width - rem if rem else 0)

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def aligned_offset_len_to_chunk(
            self, off: int, length: int) -> Tuple[int, int]:
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(
            self, off: int, length: int) -> Tuple[int, int]:
        start = self.logical_to_prev_stripe_offset(off)
        end = self.logical_to_next_stripe_offset(off + length)
        return start, end - start


def _chunk_mapping(ec) -> List[int]:
    """get_chunk_mapping(), defaulting to identity (ErasureCode.cc:
    an empty mapping means chunk i lives on shard i).

    Codes whose mapping names only the k DATA positions (lrc) are
    completed with the parity positions in ascending order — exactly
    the order encode_chunks_batch emits parity rows — so mapping[i]
    is the shard of data chunk i for i < k and of parity j for
    i == k + j, for every plugin."""
    n = ec.get_chunk_count()
    mapping = list(ec.get_chunk_mapping() or [])
    if not mapping:
        return list(range(n))
    if len(mapping) < n:
        data = set(mapping)
        mapping = mapping + [p for p in range(n) if p not in data]
    return mapping


# -- ECUtil::encode / ECUtil::decode, batched ----------------------------

def encode(sinfo: StripeInfo, ec, data: bytes,
           want: Iterable[int] | None = None) -> Dict[int, bytes]:
    """ECUtil.cc → ECUtil::encode: logical object bytes (must be
    stripe-aligned, like the reference's assert) → per-shard bytes.

    All stripes run through ONE encode_chunks_batch call; shard i's
    buffer is the concatenation of its chunk from every stripe."""
    if len(data) % sinfo.stripe_width:
        raise ValueError("input must be stripe-width aligned "
                         f"({len(data)} % {sinfo.stripe_width})")
    k = ec.get_data_chunk_count()
    m = ec.get_coding_chunk_count()
    if k != sinfo.stripe_size or sinfo.chunk_size != ec.get_chunk_size(
            sinfo.stripe_width):
        raise ValueError("stripe_info_t does not match the code profile")
    n_stripes = len(data) // sinfo.stripe_width
    arr = np.frombuffer(data, dtype=np.uint8).reshape(
        n_stripes, k, sinfo.chunk_size)
    parity = ec.encode_chunks_batch(arr)        # (n_stripes, m, C)
    mapping = _chunk_mapping(ec)
    out: Dict[int, bytes] = {}
    for i in range(k):
        out[mapping[i]] = np.ascontiguousarray(arr[:, i, :]).tobytes()
    for j in range(m):
        out[mapping[k + j]] = np.ascontiguousarray(
            parity[:, j, :]).tobytes()
    if want is not None:
        want = set(want)
        out = {s: b for s, b in out.items() if s in want}
    return out


def _touched_range(sinfo: StripeInfo, shards: Dict[int, bytes],
                   offset: int, length: int):
    """Shared validation + stripe geometry for the logical-extent I/O
    paths (read/overwrite): -> (start, n_stripes, c0, c1)."""
    lengths = {len(v) for v in shards.values()}
    if len(lengths) != 1:
        raise ValueError("uneven shard buffers")
    shard_len = lengths.pop()
    if shard_len % sinfo.chunk_size:
        raise ValueError("shard length not chunk-aligned")
    obj_len = shard_len // sinfo.chunk_size * sinfo.stripe_width
    if offset < 0 or length < 0 or offset + length > obj_len:
        raise ValueError("extent outside the object")
    start, span = sinfo.offset_len_to_stripe_bounds(offset, length)
    n_stripes = span // sinfo.stripe_width
    c0 = sinfo.logical_to_prev_chunk_offset(start)
    c1 = c0 + n_stripes * sinfo.chunk_size
    return start, n_stripes, c0, c1


def _window_bytes(sinfo: StripeInfo, sub: Dict[int, bytes], k: int,
                  n_stripes: int) -> bytes:
    """Reassemble logical bytes of a touched range from per-chunk
    slices (one reshape, the same layout math as encode/decode)."""
    return np.stack([
        np.frombuffer(sub[c], np.uint8).reshape(n_stripes,
                                                sinfo.chunk_size)
        for c in range(k)], axis=1).tobytes()


def read(sinfo: StripeInfo, ec, shards: Dict[int, bytes],
         offset: int, length: int) -> bytes:
    """ECBackend reconstructing-read math (ECBackend::objects_read_async
    → get_min_avail_to_read_shards, SURVEY.md §2.1): return the logical
    bytes [offset, offset+length) of the object, decoding erased data
    chunks for the touched stripes only.

    ``shards`` holds whatever shard buffers survive (full-length each);
    data shards present are used directly, missing ones are
    reconstructed via minimum_to_decode over the touched chunk range —
    one batched decode call for all touched stripes."""
    k = ec.get_data_chunk_count()
    mapping = _chunk_mapping(ec)
    start, n_stripes, c0, c1 = _touched_range(sinfo, shards, offset,
                                              length)
    if length == 0:
        return b""

    # minimum_to_decode / decode speak SHARD space (identical to chunk
    # ids for identity-mapped plugins; global positions for lrc)
    have_shards = set(shards)
    missing_shards = {mapping[c] for c in range(k)} - have_shards
    sub: Dict[int, bytes] = {}
    for chunk in range(k):
        if mapping[chunk] in have_shards:
            sub[chunk] = shards[mapping[chunk]][c0:c1]
    if missing_shards:
        plan = ec.minimum_to_decode(missing_shards, have_shards)
        reads = {s: shards[s][c0:c1] for s in plan}
        rec = decode(sinfo, ec, reads, missing_shards)
        for chunk in range(k):
            if mapping[chunk] in missing_shards:
                sub[chunk] = rec[mapping[chunk]]

    window = _window_bytes(sinfo, sub, k, n_stripes)
    lo = offset - start
    return window[lo:lo + length]


def overwrite(sinfo: StripeInfo, ec, shards: Dict[int, bytes],
              offset: int, data: bytes) -> Dict[int, bytes]:
    """ECBackend read-modify-write math (ECTransaction::
    generate_transactions → the RMW path, SURVEY.md §3.3): apply a
    logical overwrite at ``offset`` to an encoded object.

    The touched stripe range is rounded to stripe bounds
    (offset_len_to_stripe_bounds), the old bytes of that range are
    reassembled from the data shards, merged with ``data``, re-encoded
    in one batched call, and spliced back — returning the full new
    shard set.  Shards outside the touched chunk range are unchanged
    (byte-wise), mirroring how the reference writes only the affected
    shard extents."""
    k = ec.get_data_chunk_count()
    mapping = _chunk_mapping(ec)
    start, n_stripes, c0, c1 = _touched_range(sinfo, shards, offset,
                                              len(data))

    # reassemble the old logical bytes of the touched range from the
    # data shards, merge, re-encode through the validating encode()
    old = {i: shards[mapping[i]][c0:c1] for i in range(k)}
    merged = bytearray(_window_bytes(sinfo, old, k, n_stripes))
    lo = offset - start
    merged[lo:lo + len(data)] = data
    sub = encode(sinfo, ec, bytes(merged))
    out = {}
    for shard_id, buf in shards.items():
        out[shard_id] = buf[:c0] + sub[shard_id] + buf[c1:]
    return out


def decode(sinfo: StripeInfo, ec, to_decode: Dict[int, bytes],
           want_to_read: Iterable[int]) -> Dict[int, bytes]:
    """ECUtil.cc → ECUtil::decode: surviving shard buffers → wanted
    shard buffers, all stripes in one batched call.

    available/erased are passed to the plugin in SHARD space — the
    space decode_chunks_batch already speaks for every plugin
    (identity chunk ids for jerasure/isa/shec/clay, global positions
    for lrc)."""
    want = sorted(set(want_to_read))
    lengths = {len(v) for v in to_decode.values()}
    if len(lengths) != 1:
        raise ValueError("uneven shard buffers")
    shard_len = lengths.pop()
    if shard_len % sinfo.chunk_size:
        raise ValueError("shard length not chunk-aligned")
    n_stripes = shard_len // sinfo.chunk_size
    have = {shard: s for shard, s in to_decode.items()}
    missing = [s for s in want if s not in have]
    out: Dict[int, bytes] = {s: have[s] for s in want if s in have}
    if not missing:
        return out
    available = tuple(sorted(have))
    erased = tuple(sorted(missing))
    stack = np.stack([
        np.frombuffer(have[s], dtype=np.uint8).reshape(
            n_stripes, sinfo.chunk_size)
        for s in available], axis=1)            # (n_stripes, n_avail, C)
    rec = ec.decode_chunks_batch(stack, available, erased)
    for idx, s in enumerate(erased):
        out[s] = np.ascontiguousarray(rec[:, idx, :]).tobytes()
    return out
