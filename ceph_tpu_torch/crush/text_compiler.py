"""crushtool text crushmap grammar — compile/decompile.

The real-world interchange format: the grammar `crushtool -d` emits and
`crushtool -c` parses (src/crush/CrushCompiler.{h,cc} ->
CrushCompiler::decompile / CrushCompiler::compile), so cluster maps
decompiled from live clusters drive this framework's evaluators
directly:

    # begin crush map
    tunable chooseleaf_stable 1
    device 0 osd.0
    device 1 osd.1 class hdd
    type 0 osd
    type 1 host
    host host0 {
        id -2
        alg straw2
        hash 0  # rjenkins1
        item osd.0 weight 1.00000
    }
    rule replicated_rule {
        id 0
        type replicated
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }
    choose_args 0 {
      {
        bucket_id -2
        weight_set [
          [ 1.00000 ]
        ]
        ids [ 100 ]
      }
    }
    # end crush map

Weights are decimal (16.16 fixed point / 0x10000) with 5 digits — one
digit finer than the fixed-point ULP, so text round-trips are exact.
Unknown `tunable` names parse and re-emit verbatim (real maps carry
straw_calc_version / allowed_bucket_algs, which don't affect straw2
placement).  Device classes on `device` lines feed CrushWrapper-style
shadow trees (builder.py -> populate_classes): a class-filtered
`step take <bucket> class <cls>` compiles to a take of the per-class
shadow clone, and decompiling hides the shadows again, emitting the
original `take ... class ...` form like crushtool does.

JSON interchange lives in compiler.py; the crushtool CLI auto-detects
the format.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .types import (
    BUCKET_ALG_IDS,
    BUCKET_ALG_NAMES,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    ChooseArg,
    CrushMap,
    Rule,
    Tunables,
)

# rule type names (rados.h: CEPH_PG_TYPE_REPLICATED / _ERASURE)
_RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}
_RULE_TYPE_IDS = {v: k for k, v in _RULE_TYPE_NAMES.items()}

_TUNABLE_FIELDS = (
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once", "chooseleaf_vary_r",
    "chooseleaf_stable",
)

# text "step <kind> <mode> N type T" <-> the CRUSH_RULE_* opcodes
_CHOOSE_OPS = {
    ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
    ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP,
}
_CHOOSE_TEXT = {v: k for k, v in _CHOOSE_OPS.items()}
_SET_OPS = {
    "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
_SET_TEXT = {v: k for k, v in _SET_OPS.items()}
_TAKE, _EMIT = CRUSH_RULE_TAKE, CRUSH_RULE_EMIT


def _fmt_weight(w: int) -> str:
    return f"{w / 0x10000:.5f}"


def _parse_weight(s: str) -> int:
    return int(round(float(s) * 0x10000))


def decompile_text(cmap: CrushMap) -> str:
    """CrushMap -> crushtool text form (CrushCompiler::decompile)."""
    out: List[str] = ["# begin crush map"]
    for f in _TUNABLE_FIELDS:
        out.append(f"tunable {f} {getattr(cmap.tunables, f)}")
    for name, val in cmap.extra_tunables.items():
        out.append(f"tunable {name} {val}")

    out.append("")
    out.append("# devices")
    # only devices that exist: named, classed, or referenced by a
    # bucket — real maps have id holes after OSD removal and crushtool
    # does not fabricate lines for them
    devices = sorted(
        {d for b in cmap.buckets.values() for d in b.items if d >= 0}
        | {d for d in cmap.item_names if d >= 0}
        | set(cmap.device_classes))
    for d in devices:
        line = f"device {d} {cmap.item_names.get(d, f'osd.{d}')}"
        if d in cmap.device_classes:
            line += f" class {cmap.device_classes[d]}"
        out.append(line)

    out.append("")
    out.append("# types")
    types = dict(cmap.type_names)
    types.setdefault(0, "osd")
    for tid in sorted(types):
        out.append(f"type {tid} {types[tid]}")

    out.append("")
    out.append("# buckets")
    # children before parents (crushtool emits leaves-first so every
    # item name is defined before use)
    emitted = set()
    shadow_ids = set(cmap.class_bucket.values())

    def emit_bucket(bid: int) -> None:
        if bid in emitted or bid in shadow_ids:
            return  # shadow clones are derived state; crushtool hides them
        b = cmap.buckets[bid]
        for it in b.items:
            if it < 0:
                emit_bucket(it)
        emitted.add(bid)
        tname = types.get(b.type, str(b.type))
        bname = cmap.item_names.get(bid, f"bucket{-bid}")
        out.append(f"{tname} {bname} {{")
        out.append(f"\tid {b.id}")
        for (orig, cls), sid in sorted(cmap.class_bucket.items(),
                                       key=lambda kv: -kv[1]):
            if orig == bid:
                out.append(f"\tid {sid} class {cls}")
        out.append(f"\t# weight {_fmt_weight(b.weight)}")
        out.append(f"\talg {BUCKET_ALG_NAMES[b.alg]}")
        out.append("\thash 0\t# rjenkins1")
        for it, w in zip(b.items, b.item_weights):
            iname = (cmap.item_names.get(it, f"osd.{it}") if it >= 0
                     else cmap.item_names.get(it, f"bucket{-it}"))
            out.append(f"\titem {iname} weight {_fmt_weight(w)}")
        out.append("}")

    for bid in sorted(cmap.buckets, reverse=True):
        emit_bucket(bid)

    out.append("")
    out.append("# rules")
    for r in sorted(cmap.rules.values(), key=lambda r: r.rule_id):
        rname = r.name or f"rule{r.rule_id}"
        out.append(f"rule {rname} {{")
        out.append(f"\tid {r.rule_id}")
        out.append(f"\ttype {_RULE_TYPE_NAMES.get(r.type, r.type)}")
        out.append(f"\tmin_size {r.min_size}")
        out.append(f"\tmax_size {r.max_size}")
        for op, a1, a2 in r.steps:
            if op == _TAKE:
                shadow = cmap.shadow_of(a1) if a1 < 0 else None
                if shadow is not None:
                    orig, cls = shadow
                    oname = cmap.item_names.get(orig, f"bucket{-orig}")
                    out.append(f"\tstep take {oname} class {cls}")
                    continue
                tname_ = cmap.item_names.get(a1, f"bucket{-a1}" if a1 < 0
                                             else f"osd.{a1}")
                out.append(f"\tstep take {tname_}")
            elif op == _EMIT:
                out.append("\tstep emit")
            elif op in _CHOOSE_TEXT:
                kind, mode = _CHOOSE_TEXT[op]
                tn = types.get(a2, str(a2))
                out.append(f"\tstep {kind} {mode} {a1} type {tn}")
            elif op in _SET_TEXT:
                out.append(f"\tstep {_SET_TEXT[op]} {a1}")
            else:
                raise ValueError(f"cannot decompile rule op {op}")
        out.append("}")

    if cmap.choose_args:
        out.append("")
        out.append("# choose_args")
        for name in sorted(cmap.choose_args):
            out.append(f"choose_args {name} {{")
            for bid in sorted(cmap.choose_args[name], reverse=True):
                ca = cmap.choose_args[name][bid]
                out.append("  {")
                out.append(f"    bucket_id {bid}")
                if ca.weight_set:
                    out.append("    weight_set [")
                    for ws in ca.weight_set:
                        row = " ".join(_fmt_weight(w) for w in ws)
                        out.append(f"      [ {row} ]")
                    out.append("    ]")
                if ca.ids:
                    out.append(f"    ids [ {' '.join(str(i) for i in ca.ids)} ]")
                out.append("  }")
            out.append("}")

    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


class _Tokens:
    def __init__(self, text: str) -> None:
        # strip comments, split braces/brackets into their own tokens
        body = re.sub(r"#[^\n]*", " ", text)
        body = re.sub(r"([{}\[\]])", r" \1 ", body)
        self.toks = body.split()
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of crushmap text")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise ValueError(f"expected {tok!r}, got {t!r} "
                             f"(token {self.i - 1})")


def compile_text(text: str) -> CrushMap:
    """crushtool text form -> CrushMap (CrushCompiler::compile)."""
    from .builder import CrushBuilder

    t = _Tokens(text)
    b = CrushBuilder()
    cmap = b.map
    name_to_id: Dict[str, int] = {}
    type_ids: Dict[str, int] = {}
    # buckets may reference names; builder needs items resolved

    def resolve(name: str) -> int:
        if name in name_to_id:
            return name_to_id[name]
        raise ValueError(f"crushmap references undefined item {name!r}")

    while t.peek() is not None:
        tok = t.next()
        if tok == "tunable":
            name, val = t.next(), int(t.next())
            if name in _TUNABLE_FIELDS:
                setattr(cmap.tunables, name, val)
            else:
                cmap.extra_tunables[name] = val
        elif tok == "device":
            dev = int(t.next())
            name = t.next()
            name_to_id[name] = dev
            cmap.item_names[dev] = name
            cmap.max_devices = max(cmap.max_devices, dev + 1)
            if t.peek() == "class":
                t.next()
                cmap.device_classes[dev] = t.next()
        elif tok == "type":
            tid = int(t.next())
            name = t.next()
            b.add_type(tid, name)
            type_ids[name] = tid
        elif tok == "rule":
            _parse_rule(t, b, name_to_id, type_ids)
        elif tok == "choose_args":
            _parse_choose_args(t, cmap)
        elif tok in type_ids:  # bucket block: "<typename> <name> {"
            _parse_bucket(t, b, tok, type_ids, name_to_id, cmap)
        else:
            raise ValueError(f"unexpected token {tok!r} at top level")
    return cmap


def _parse_bucket(t: _Tokens, b, type_name: str, type_ids, name_to_id,
                  cmap) -> None:
    bname = t.next()
    t.expect("{")
    bucket_id: Optional[int] = None
    alg = "straw2"
    items: List[int] = []
    weights: List[int] = []
    shadow_ids: List[Tuple[int, str]] = []
    while True:
        tok = t.next()
        if tok == "}":
            break
        if tok == "id":
            bid = int(t.next())
            if t.peek() == "class":  # pinned shadow id: "id -5 class hdd"
                t.next()
                shadow_ids.append((bid, t.next()))
                continue
            bucket_id = bid
        elif tok == "alg":
            alg = t.next()
        elif tok == "hash":
            if int(t.next()) != 0:
                raise ValueError("only hash 0 (rjenkins1) is supported")
        elif tok == "item":
            iname = t.next()
            item = name_to_id.get(iname)
            if item is None:
                raise ValueError(
                    f"bucket {bname!r} references undefined item "
                    f"{iname!r} (crushtool requires definition order)")
            w = None
            while t.peek() in ("weight", "pos"):
                key = t.next()
                if key == "weight":
                    w = _parse_weight(t.next())
                else:  # pos N — positional placement; order already given
                    t.next()
            if w is None:
                w = (b.map.buckets[item].weight if item < 0 else 0x10000)
            items.append(item)
            weights.append(w)
        else:
            raise ValueError(f"unexpected token {tok!r} in bucket "
                             f"{bname!r}")
    if bucket_id is None:
        raise ValueError(f"bucket {bname!r} has no id")
    if alg not in BUCKET_ALG_IDS:
        raise ValueError(f"bucket {bname!r}: unknown alg {alg!r}")
    b.add_bucket(alg, type_ids[type_name], items, weights,
                 bucket_id=bucket_id, name=bname)
    name_to_id[bname] = bucket_id
    for sid, cls in shadow_ids:
        # shadow buckets themselves are rebuilt by populate_classes;
        # the pinned ids make the rebuild placement-identical to the
        # cluster the map came from
        cmap.class_bucket[(bucket_id, cls)] = sid


def _parse_rule(t: _Tokens, b, name_to_id, type_ids) -> None:
    rname = t.next()
    t.expect("{")
    rule_id: Optional[int] = None
    rtype = 1
    min_size, max_size = 1, 10
    steps: List[Tuple[int, int, int]] = []
    while True:
        tok = t.next()
        if tok == "}":
            break
        if tok in ("id", "ruleset"):  # pre-nautilus maps say "ruleset"
            rule_id = int(t.next())
        elif tok == "type":
            v = t.next()
            rtype = _RULE_TYPE_IDS.get(v)
            if rtype is None:
                try:
                    rtype = int(v)
                except ValueError:
                    raise ValueError(
                        f"rule {rname!r}: unsupported rule type {v!r} "
                        "(only replicated/erasure/numeric; MSR rule "
                        "types are not supported)") from None
        elif tok == "min_size":
            min_size = int(t.next())
        elif tok == "max_size":
            max_size = int(t.next())
        elif tok == "step":
            op = t.next()
            if op == "take":
                item = name_to_id.get(t.next())
                if item is None:
                    raise ValueError(f"rule {rname!r}: take of undefined "
                                     "item")
                if t.peek() == "class":
                    t.next()
                    cls = t.next()
                    sid = b.map.class_bucket.get((item, cls))
                    if sid is None or sid not in b.map.buckets:
                        b.populate_classes()  # build (or honor pinned
                        #                       ids from the bucket
                        #                       blocks)
                    item = b.get_shadow(item, cls)
                steps.append((_TAKE, item, 0))
            elif op == "emit":
                steps.append((_EMIT, 0, 0))
            elif op in ("choose", "chooseleaf"):
                mode = t.next()
                opid = _CHOOSE_OPS.get((op, mode))
                if opid is None:
                    raise ValueError(f"unknown step {op} {mode}")
                n = int(t.next())
                t.expect("type")
                tname = t.next()
                if tname not in type_ids and tname != "osd":
                    raise ValueError(f"rule {rname!r}: unknown type "
                                     f"{tname!r}")
                steps.append((opid, n, type_ids.get(tname, 0)))
            elif op in _SET_OPS:
                steps.append((_SET_OPS[op], int(t.next()), 0))
            else:
                raise ValueError(f"unknown rule step {op!r}")
        else:
            raise ValueError(f"unexpected token {tok!r} in rule {rname!r}")
    if rule_id is None:
        raise ValueError(f"rule {rname!r} has no id")
    b.add_rule(rule_id, steps, name=rname, rule_type=rtype)
    b.map.rules[rule_id].min_size = min_size
    b.map.rules[rule_id].max_size = max_size


def _parse_choose_args(t: _Tokens, cmap: CrushMap) -> None:
    name = t.next()
    t.expect("{")
    args: Dict[int, ChooseArg] = {}
    while True:
        tok = t.next()
        if tok == "}":
            break
        if tok != "{":
            raise ValueError(f"expected '{{' in choose_args, got {tok!r}")
        bucket_id: Optional[int] = None
        weight_set: Optional[List[List[int]]] = None
        ids: Optional[List[int]] = None
        while True:
            k = t.next()
            if k == "}":
                break
            if k == "bucket_id":
                bucket_id = int(t.next())
            elif k == "weight_set":
                t.expect("[")
                weight_set = []
                while t.peek() != "]":
                    t.expect("[")
                    row: List[int] = []
                    while t.peek() != "]":
                        row.append(_parse_weight(t.next()))
                    t.expect("]")
                    weight_set.append(row)
                t.expect("]")
            elif k == "ids":
                t.expect("[")
                ids = []
                while t.peek() != "]":
                    ids.append(int(t.next()))
                t.expect("]")
            else:
                raise ValueError(f"unexpected token {k!r} in choose_args")
        if bucket_id is None:
            raise ValueError("choose_args entry without bucket_id")
        args[bucket_id] = ChooseArg(weight_set=weight_set, ids=ids)
    cmap.choose_args[name] = args
