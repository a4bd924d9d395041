"""Incremental wire encode/decode — OSDMap::Incremental::encode/decode
(placement subset), so the epoch-catch-up "resume" story round-trips
through storage; a copy of ``ceph_tpu/crush/inc_binary.py``, whose
blobs it reads and writes byte for byte.

Reference: src/osd/OSDMap.h → OSDMap::Incremental::encode/decode.
Upstream's encoding is feature-bit conditional and carries daemon-side
fields (up_thru, blocklists, mon addrs) that are SURVEY §7 non-goals;
this module serializes exactly the placement-relevant subset
`incremental.Incremental` carries, in the same little-endian
section style as crush/binary.py, behind its own magic + version so a
foreign blob fails loudly instead of misparsing.

Byte-compatibility with upstream's encoding is not claimed; what IS
pinned is
encode → decode → apply ≡ direct apply over randomized deltas
(tests/test_torch_incremental.py, which also decodes each package's
blobs with the other).

Layout (all little-endian):

    u32 magic (0x0001C511)  u32 version (1)  u32 epoch
    u8  has_crush      [u32 len, crush blob (crush/binary.py form)]
    u8  has_max_osd    [s32 new_max_osd]
    u32 n_new_pools    n x {s32 pool_id, u32 pg_num, u32 pgp_num,
                            u8 size, u8 min_size, u32 crush_rule,
                            u8 erasure, u8 hashpspool}
    u32 n_old_pools    n x s32
    u32 n_new_weight   n x {s32 osd, u32 weight}
    u32 n_new_state    n x {s32 osd, u32 state_xor}
    u32 n_new_affinity n x {s32 osd, u32 affinity}
    u32 n_new_pg_temp  n x {s32 pool, u32 seed, u32 len, s32 osds[len]}
    u32 n_new_primary_temp  n x {s32 pool, u32 seed, s32 primary}
    u32 n_new_pg_upmap n x {s32 pool, u32 seed, u32 len, s32 osds[len]}
    u32 n_old_pg_upmap n x {s32 pool, u32 seed}
    u32 n_new_upmap_items  n x {s32 pool, u32 seed, u32 len,
                                len x (s32 from, s32 to)}
    u32 n_old_upmap_items  n x {s32 pool, u32 seed}
"""

from __future__ import annotations

from typing import List, Tuple

from .binary import _R, _W, decode_map, encode_map
from .incremental import Incremental
from .osdmap import PGPool

INC_MAGIC = 0x0001C511
INC_VERSION = 1


def _pgid(w: _W, pgid: Tuple[int, int]) -> None:
    w.s32(pgid[0])
    w.u32(pgid[1])


def _read_pgid(r: _R) -> Tuple[int, int]:
    return (r.s32(), r.u32())


def encode_incremental(inc: Incremental) -> bytes:
    """OSDMap::Incremental::encode equivalent (placement subset)."""
    w = _W()
    w.u32(INC_MAGIC)
    w.u32(INC_VERSION)
    w.u32(inc.epoch)
    if inc.new_crush is not None:
        w.u8(1)
        blob = encode_map(inc.new_crush)
        w.u32(len(blob))
        w.parts.append(blob)
    else:
        w.u8(0)
    if inc.new_max_osd is not None:
        w.u8(1)
        w.s32(inc.new_max_osd)
    else:
        w.u8(0)
    w.u32(len(inc.new_pools))
    for pid in sorted(inc.new_pools):
        p = inc.new_pools[pid]
        w.s32(pid)
        w.u32(p.pg_num)
        w.u32(p.pgp_num)
        w.u8(p.size)
        w.u8(p.min_size)
        w.u32(p.crush_rule)
        w.u8(1 if p.erasure else 0)
        w.u8(1 if p.hashpspool else 0)
    w.u32(len(inc.old_pools))
    for pid in inc.old_pools:
        w.s32(pid)
    for m in (inc.new_weight, inc.new_state, inc.new_primary_affinity):
        w.u32(len(m))
        for osd in sorted(m):
            w.s32(osd)
            w.u32(m[osd])
    w.u32(len(inc.new_pg_temp))
    for pgid in sorted(inc.new_pg_temp):
        _pgid(w, pgid)
        osds = inc.new_pg_temp[pgid]
        w.u32(len(osds))
        for o in osds:
            w.s32(o)
    w.u32(len(inc.new_primary_temp))
    for pgid in sorted(inc.new_primary_temp):
        _pgid(w, pgid)
        w.s32(inc.new_primary_temp[pgid])
    w.u32(len(inc.new_pg_upmap))
    for pgid in sorted(inc.new_pg_upmap):
        _pgid(w, pgid)
        osds = inc.new_pg_upmap[pgid]
        w.u32(len(osds))
        for o in osds:
            w.s32(o)
    w.u32(len(inc.old_pg_upmap))
    for pgid in inc.old_pg_upmap:
        _pgid(w, pgid)
    w.u32(len(inc.new_pg_upmap_items))
    for pgid in sorted(inc.new_pg_upmap_items):
        _pgid(w, pgid)
        pairs = inc.new_pg_upmap_items[pgid]
        w.u32(len(pairs))
        for frm, to in pairs:
            w.s32(frm)
            w.s32(to)
    w.u32(len(inc.old_pg_upmap_items))
    for pgid in inc.old_pg_upmap_items:
        _pgid(w, pgid)
    return w.blob()


def decode_incremental(blob: bytes) -> Incremental:
    """OSDMap::Incremental::decode equivalent (placement subset)."""
    r = _R(blob)
    if r.u32() != INC_MAGIC:
        raise ValueError("not an incremental blob (bad magic)")
    ver = r.u32()
    if ver != INC_VERSION:
        raise ValueError(f"incremental version {ver} not supported")
    inc = Incremental(epoch=r.u32())
    if r.u8():
        n = r.u32()
        if r.off + n > len(r.data):
            raise EOFError
        inc.new_crush = decode_map(r.data[r.off:r.off + n])
        r.off += n
    if r.u8():
        inc.new_max_osd = r.s32()
    for _ in range(r.u32()):
        pid = r.s32()
        pg_num = r.u32()
        pgp_num = r.u32()
        size = r.u8()
        min_size = r.u8()
        crush_rule = r.u32()
        erasure = bool(r.u8())
        hashpspool = bool(r.u8())
        inc.new_pools[pid] = PGPool(
            pool_id=pid, pg_num=pg_num, size=size, min_size=min_size,
            crush_rule=crush_rule, pgp_num=pgp_num, erasure=erasure,
            hashpspool=hashpspool)
    inc.old_pools = [r.s32() for _ in range(r.u32())]
    for m in (inc.new_weight, inc.new_state, inc.new_primary_affinity):
        for _ in range(r.u32()):
            osd = r.s32()
            m[osd] = r.u32()
    for _ in range(r.u32()):
        pgid = _read_pgid(r)
        inc.new_pg_temp[pgid] = [r.s32() for _ in range(r.u32())]
    for _ in range(r.u32()):
        pgid = _read_pgid(r)
        inc.new_primary_temp[pgid] = r.s32()
    for _ in range(r.u32()):
        pgid = _read_pgid(r)
        inc.new_pg_upmap[pgid] = [r.s32() for _ in range(r.u32())]
    inc.old_pg_upmap = [_read_pgid(r) for _ in range(r.u32())]
    for _ in range(r.u32()):
        pgid = _read_pgid(r)
        pairs: List[Tuple[int, int]] = []
        for _ in range(r.u32()):
            frm = r.s32()
            pairs.append((frm, r.s32()))
        inc.new_pg_upmap_items[pgid] = pairs
    inc.old_pg_upmap_items = [_read_pgid(r) for _ in range(r.u32())]
    if not r.eof:
        raise ValueError(
            f"trailing bytes after incremental ({len(r.data) - r.off})")
    return inc
