"""Crush map text form — compile/decompile.

Role of src/crush/CrushCompiler.{h,cc} (text crushmap <-> binary): here
the interchange form is JSON (this framework's "text crushmap"), with
full round-trip of buckets, rules, tunables, names and choose_args.
`crushtool -d/-c` equivalents are `decompile`/`compile_map`.
"""

from __future__ import annotations

import json
from typing import Dict

from .types import (
    BUCKET_ALG_IDS,
    BUCKET_ALG_NAMES,
    Bucket,
    ChooseArg,
    CrushMap,
    Rule,
    Tunables,
)

_STEP_NAMES = {
    1: "take", 2: "choose_firstn", 3: "choose_indep", 4: "emit",
    6: "chooseleaf_firstn", 7: "chooseleaf_indep",
    8: "set_choose_tries", 9: "set_chooseleaf_tries",
    10: "set_choose_local_tries", 11: "set_choose_local_fallback_tries",
    12: "set_chooseleaf_vary_r", 13: "set_chooseleaf_stable",
}
_STEP_IDS = {v: k for k, v in _STEP_NAMES.items()}


def decompile(cmap: CrushMap) -> str:
    """CrushMap -> JSON text (CrushCompiler::decompile role)."""
    doc = {
        "tunables": vars(cmap.tunables).copy(),
        "types": {str(k): v for k, v in cmap.type_names.items()},
        "devices": cmap.max_devices,
        "buckets": [
            {
                "id": b.id,
                "name": cmap.item_names.get(b.id, ""),
                "type": b.type,
                "alg": BUCKET_ALG_NAMES[b.alg],
                "items": list(b.items),
                "weights": list(b.item_weights),
            }
            for b in sorted(cmap.buckets.values(), key=lambda b: -b.id)
        ],
        "rules": [
            {
                "id": r.rule_id,
                "name": r.name,
                "type": r.type,
                "min_size": r.min_size,
                "max_size": r.max_size,
                "steps": [[_STEP_NAMES[op], a1, a2]
                          for (op, a1, a2) in r.steps],
            }
            for r in sorted(cmap.rules.values(), key=lambda r: r.rule_id)
        ],
        "choose_args": {
            name: {
                str(bid): {"weight_set": ca.weight_set, "ids": ca.ids}
                for bid, ca in args.items()
            }
            for name, args in cmap.choose_args.items()
        },
        "device_names": {str(d): n for d, n in cmap.item_names.items()
                         if d >= 0},
        "device_classes": {str(d): c
                           for d, c in cmap.device_classes.items()},
        "extra_tunables": dict(cmap.extra_tunables),
    }
    return json.dumps(doc, indent=2)


def compile_map(text: str) -> CrushMap:
    """JSON text -> CrushMap (CrushCompiler::compile role); inverse of
    decompile, rebuilding derived bucket arrays via the builder."""
    from .builder import CrushBuilder

    doc = json.loads(text)
    tun = Tunables(**doc.get("tunables", {}))
    b = CrushBuilder(tunables=tun)
    for tid, name in doc.get("types", {}).items():
        b.add_type(int(tid), name)
    for spec in doc.get("buckets", []):
        b.add_bucket(spec["alg"], spec["type"], spec["items"],
                     spec.get("weights"), bucket_id=spec["id"],
                     name=spec.get("name") or None)
    for spec in doc.get("rules", []):
        steps = [(_STEP_IDS[s[0]], int(s[1]), int(s[2]))
                 for s in spec["steps"]]
        b.add_rule(spec["id"], steps, name=spec.get("name", ""),
                   rule_type=spec.get("type", 1))
        b.map.rules[spec["id"]].min_size = spec.get("min_size", 1)
        b.map.rules[spec["id"]].max_size = spec.get("max_size", 10)
    cmap = b.map
    cmap.max_devices = max(cmap.max_devices, int(doc.get("devices", 0)))
    for name, args in doc.get("choose_args", {}).items():
        cmap.choose_args[name] = {
            int(bid): ChooseArg(weight_set=ca.get("weight_set"),
                                ids=ca.get("ids"))
            for bid, ca in args.items()
        }
    for d, n in doc.get("device_names", {}).items():
        cmap.item_names[int(d)] = n
    cmap.device_classes = {int(d): c for d, c in
                           doc.get("device_classes", {}).items()}
    cmap.extra_tunables = dict(doc.get("extra_tunables", {}))
    return cmap
