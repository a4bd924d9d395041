"""Binary crushmap encode/decode — CrushWrapper::encode/::decode.

The wire/storage form: what `ceph osd getcrushmap` emits and
`crushtool -c`'s binary output contains.  Little-endian, laid out as
upstream CrushWrapper::encode writes it:

    u32 magic (CRUSH_MAGIC 0x00010000)
    s32 max_buckets, u32 max_rules, s32 max_devices
    max_buckets bucket slots:
        u32 alg (0 = empty slot), else
        s32 id, u16 type, u8 alg, u8 hash, u32 weight, u32 size,
        s32 items[size], then the per-alg payload:
          uniform: u32 item_weight
          list:    (u32 item_weight, u32 sum_weight)[size]
          tree:    u8 num_nodes, u32 node_weights[num_nodes]
          straw:   (u32 item_weight, u32 straw)[size]
          straw2:  u32 item_weights[size]
    max_rules rule slots:
        u32 exists (0 = empty), else
        u32 len, crush_rule_mask {u8 ruleset, u8 type, u8 min_size,
        u8 max_size}, len steps of {u32 op, s32 arg1, s32 arg2}
    name maps (each: u32 n, then n x (s32 key, u32 strlen, bytes)):
        type_map, name_map, rule_name_map
    tunables, appended over history (decode stops at EOF for maps from
    older releases): u32 choose_local_tries, u32
    choose_local_fallback_tries, u32 choose_total_tries,
    u32 chooseleaf_descend_once, u8 chooseleaf_vary_r,
    u8 straw_calc_version, u32 allowed_bucket_algs,
    u8 chooseleaf_stable
    class maps (Luminous+): class_map (s32 item -> s32 class id),
    class_name (s32 class id -> string), class_bucket
    (s32 bucket -> u32 n x (s32 class id, s32 shadow id)),
    choose_args (u32 n sets; each: s32/string name is NOT stored here —
    upstream keys sets by u64 id; we store the numeric id — then u32
    n_buckets entries of {s32 bucket_id, u32 n_weight_sets x
    (u32 size, u32 weights[size]), u32 n_ids, s32 ids[n_ids]})

⚠ Vintage: the reference mount has been empty every session
(SURVEY.md §0), so this layout is reconstructed from upstream-ceph
knowledge and is NOT byte-verified against a real `getcrushmap` blob;
the magic gate means a mismatched map fails loudly rather than
misparsing.  Round-trips (encode -> decode -> identical placements and
fields) are pinned in tests; re-verify against real blobs when the
mount is repaired.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .types import (
    BUCKET_ALG_IDS,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    Bucket,
    ChooseArg,
    CrushMap,
    Rule,
    Tunables,
)

CRUSH_MAGIC = 0x00010000


class _W:
    def __init__(self) -> None:
        self.parts: List[bytes] = []

    def u8(self, v): self.parts.append(struct.pack("<B", v & 0xFF))
    def u16(self, v): self.parts.append(struct.pack("<H", v & 0xFFFF))
    def u32(self, v): self.parts.append(struct.pack("<I", v & 0xFFFFFFFF))
    def s32(self, v): self.parts.append(struct.pack("<i", v))

    def string(self, s: str) -> None:
        b = s.encode()
        self.u32(len(b))
        self.parts.append(b)

    def blob(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def _take(self, fmt: str, n: int):
        if self.off + n > len(self.data):
            raise EOFError
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += n
        return v

    def u8(self): return self._take("<B", 1)
    def u16(self): return self._take("<H", 2)
    def u32(self): return self._take("<I", 4)
    def s32(self): return self._take("<i", 4)

    def string(self) -> str:
        n = self.u32()
        if self.off + n > len(self.data):
            raise EOFError
        s = self.data[self.off:self.off + n].decode()
        self.off += n
        return s

    @property
    def eof(self) -> bool:
        return self.off >= len(self.data)


def encode_map(cmap: CrushMap) -> bytes:
    """CrushWrapper::encode equivalent."""
    w = _W()
    w.u32(CRUSH_MAGIC)
    bucket_ids = sorted(cmap.buckets)  # most negative last slot
    max_buckets = max((-b for b in bucket_ids), default=0)
    w.s32(max_buckets)
    max_rules = max(cmap.rules, default=-1) + 1
    w.u32(max_rules)
    w.s32(cmap.max_devices)
    for slot in range(max_buckets):
        b = cmap.buckets.get(-1 - slot)
        if b is None:
            w.u32(0)
            continue
        w.u32(b.alg)
        w.s32(b.id)
        w.u16(b.type)
        w.u8(b.alg)
        w.u8(b.hash)
        w.u32(b.weight)
        w.u32(b.size)
        for it in b.items:
            w.s32(it)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            w.u32(b.item_weights[0] if b.item_weights else 0)
        elif b.alg == CRUSH_BUCKET_LIST:
            for iw, sw in zip(b.item_weights, b.sum_weights):
                w.u32(iw)
                w.u32(sw)
        elif b.alg == CRUSH_BUCKET_TREE:
            w.u8(b.num_nodes)
            for nw in b.node_weights:
                w.u32(nw)
        elif b.alg == CRUSH_BUCKET_STRAW:
            for iw, st in zip(b.item_weights, b.straws):
                w.u32(iw)
                w.u32(st)
        elif b.alg == CRUSH_BUCKET_STRAW2:
            for iw in b.item_weights:
                w.u32(iw)
        else:
            raise ValueError(f"cannot encode bucket alg {b.alg}")
    for rid in range(max_rules):
        r = cmap.rules.get(rid)
        if r is None:
            w.u32(0)
            continue
        w.u32(1)
        w.u32(len(r.steps))
        w.u8(rid)          # crush_rule_mask.ruleset (== id post-luminous)
        w.u8(r.type)
        w.u8(r.min_size)
        w.u8(r.max_size)
        for op, a1, a2 in r.steps:
            w.u32(op)
            w.s32(a1)
            w.s32(a2)
    # name maps
    types = dict(cmap.type_names)
    types.setdefault(0, "osd")
    w.u32(len(types))
    for k in sorted(types):
        w.s32(k)
        w.string(types[k])
    w.u32(len(cmap.item_names))
    for k in sorted(cmap.item_names):
        w.s32(k)
        w.string(cmap.item_names[k])
    rule_names = {rid: r.name for rid, r in cmap.rules.items() if r.name}
    w.u32(len(rule_names))
    for k in sorted(rule_names):
        w.s32(k)
        w.string(rule_names[k])
    # tunables (historical append order)
    t = cmap.tunables
    x = cmap.extra_tunables
    w.u32(t.choose_local_tries)
    w.u32(t.choose_local_fallback_tries)
    w.u32(t.choose_total_tries)
    w.u32(t.chooseleaf_descend_once)
    w.u8(t.chooseleaf_vary_r)
    w.u8(x.get("straw_calc_version", 1))
    w.u32(x.get("allowed_bucket_algs",
                (1 << CRUSH_BUCKET_STRAW) | (1 << CRUSH_BUCKET_STRAW2)))
    w.u8(t.chooseleaf_stable)
    # device classes
    classes = sorted(set(cmap.device_classes.values()))
    class_id = {c: i for i, c in enumerate(classes)}
    w.u32(len(cmap.device_classes))
    for dev in sorted(cmap.device_classes):
        w.s32(dev)
        w.s32(class_id[cmap.device_classes[dev]])
    w.u32(len(classes))
    for c in classes:
        w.s32(class_id[c])
        w.string(c)
    by_bucket: Dict[int, List[Tuple[int, int]]] = {}
    for (orig, cls), sid in cmap.class_bucket.items():
        by_bucket.setdefault(orig, []).append((class_id[cls], sid))
    w.u32(len(by_bucket))
    for orig in sorted(by_bucket):
        w.s32(orig)
        w.u32(len(by_bucket[orig]))
        for cid, sid in sorted(by_bucket[orig]):
            w.s32(cid)
            w.s32(sid)
    # choose_args sets (numeric set ids)
    w.u32(len(cmap.choose_args))
    for name in sorted(cmap.choose_args):
        try:
            w.s32(int(name))
        except ValueError:
            w.s32(0)
        args = cmap.choose_args[name]
        w.u32(len(args))
        for bid in sorted(args):
            ca = args[bid]
            w.s32(bid)
            ws = ca.weight_set or []
            w.u32(len(ws))
            for row in ws:
                w.u32(len(row))
                for v in row:
                    w.u32(v)
            ids = ca.ids or []
            w.u32(len(ids))
            for i in ids:
                w.s32(i)
    return w.blob()


def decode_map(blob: bytes) -> CrushMap:
    """CrushWrapper::decode equivalent (tail-tolerant: tunables and
    class/choose_args sections may be absent in older maps)."""
    r = _R(blob)
    if r.u32() != CRUSH_MAGIC:
        raise ValueError("not a crushmap: bad magic")
    cmap = CrushMap()
    max_buckets = r.s32()
    max_rules = r.u32()
    cmap.max_devices = r.s32()
    for slot in range(max_buckets):
        alg = r.u32()
        if alg == 0:
            continue
        bid = r.s32()
        btype = r.u16()
        alg2 = r.u8()
        hash_ = r.u8()
        weight = r.u32()
        size = r.u32()
        items = [r.s32() for _ in range(size)]
        b = Bucket(id=bid, type=btype, alg=alg2, hash=hash_,
                   weight=weight, items=items)
        if alg2 == CRUSH_BUCKET_UNIFORM:
            iw = r.u32()
            b.item_weights = [iw] * size
        elif alg2 == CRUSH_BUCKET_LIST:
            for _ in range(size):
                b.item_weights.append(r.u32())
                b.sum_weights.append(r.u32())
        elif alg2 == CRUSH_BUCKET_TREE:
            b.num_nodes = r.u8()
            b.node_weights = [r.u32() for _ in range(b.num_nodes)]
            # leaf weights live at odd nodes 2i+1
            b.item_weights = [
                b.node_weights[2 * i + 1] if 2 * i + 1 < b.num_nodes
                else 0 for i in range(size)]
        elif alg2 == CRUSH_BUCKET_STRAW:
            for _ in range(size):
                b.item_weights.append(r.u32())
                b.straws.append(r.u32())
        elif alg2 == CRUSH_BUCKET_STRAW2:
            b.item_weights = [r.u32() for _ in range(size)]
        else:
            raise ValueError(f"cannot decode bucket alg {alg2}")
        cmap.buckets[bid] = b
    for rid in range(max_rules):
        if r.u32() == 0:
            continue
        nsteps = r.u32()
        r.u8()  # ruleset (folded into id post-luminous)
        rtype = r.u8()
        min_size = r.u8()
        max_size = r.u8()
        steps = [(r.u32(), r.s32(), r.s32()) for _ in range(nsteps)]
        cmap.rules[rid] = Rule(rule_id=rid, type=rtype,
                               min_size=min_size, max_size=max_size,
                               steps=steps)
    for _ in range(r.u32()):
        k = r.s32()
        cmap.type_names[k] = r.string()
    for _ in range(r.u32()):
        k = r.s32()
        cmap.item_names[k] = r.string()
    for _ in range(r.u32()):
        k = r.s32()
        name = r.string()
        if k in cmap.rules:
            cmap.rules[k].name = name
    t = Tunables()
    try:
        t.choose_local_tries = r.u32()
        t.choose_local_fallback_tries = r.u32()
        t.choose_total_tries = r.u32()
        t.chooseleaf_descend_once = r.u32()
        t.chooseleaf_vary_r = r.u8()
        cmap.extra_tunables["straw_calc_version"] = r.u8()
        cmap.extra_tunables["allowed_bucket_algs"] = r.u32()
        t.chooseleaf_stable = r.u8()
        cmap.tunables = t
        n = r.u32()
        dev_class_ids = [(r.s32(), r.s32()) for _ in range(n)]
        class_names = {}
        for _ in range(r.u32()):
            cid = r.s32()
            class_names[cid] = r.string()
        for dev, cid in dev_class_ids:
            cmap.device_classes[dev] = class_names.get(cid, str(cid))
        for _ in range(r.u32()):
            orig = r.s32()
            for _ in range(r.u32()):
                cid = r.s32()
                sid = r.s32()
                cls = class_names.get(cid, str(cid))
                cmap.class_bucket[(orig, cls)] = sid
        for _ in range(r.u32()):
            set_id = r.s32()
            args: Dict[int, ChooseArg] = {}
            for _ in range(r.u32()):
                bid = r.s32()
                ws = [[r.u32() for _ in range(r.u32())]
                      for _ in range(r.u32())]
                ids = [r.s32() for _ in range(r.u32())]
                args[bid] = ChooseArg(weight_set=ws or None,
                                      ids=ids or None)
            cmap.choose_args[str(set_id)] = args
    except EOFError:
        cmap.tunables = t  # pre-tunables-era map: keep what we parsed
    return cmap
