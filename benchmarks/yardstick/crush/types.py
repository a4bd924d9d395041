"""Frozen copy of the project's ``ceph_tpu/crush/types.py``, the benchmark's
plain reference; it imports nothing but numpy and its siblings.

CRUSH map structures — src/crush/crush.h.

crush_map / crush_bucket{_uniform,_list,_tree,_straw,_straw2} /
crush_rule / tunables, as plain Python dataclasses.  Bucket ids are
negative (-1-index), devices are >= 0, weights are 16.16 fixed point
(crush.h -> struct crush_bucket: __u32 weight), exactly as upstream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# crush.h -> enum crush_opcodes
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

# crush.h -> bucket algorithms
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

BUCKET_ALG_NAMES = {
    CRUSH_BUCKET_UNIFORM: "uniform",
    CRUSH_BUCKET_LIST: "list",
    CRUSH_BUCKET_TREE: "tree",
    CRUSH_BUCKET_STRAW: "straw",
    CRUSH_BUCKET_STRAW2: "straw2",
}
BUCKET_ALG_IDS = {v: k for k, v in BUCKET_ALG_NAMES.items()}

CRUSH_ITEM_UNDEF = -0x7FFFFFFF  # crush.h (mapping undefined, indep interim)
CRUSH_ITEM_NONE = 0x7FFFFFFF    # crush.h (no mapping; "hole" in indep)

RULE_TYPE_REPLICATED = 1  # crush.h -> CRUSH_RULE_TYPE_REPLICATED
RULE_TYPE_ERASURE = 3     # osd_types: pg_pool_t TYPE_ERASURE rules


@dataclass
class Bucket:
    """crush.h -> struct crush_bucket (+ per-alg payloads)."""

    id: int                      # negative
    type: int                    # hierarchy level (host/rack/... id)
    alg: int                     # CRUSH_BUCKET_*
    hash: int = 0                # CRUSH_HASH_RJENKINS1
    weight: int = 0              # 16.16 total
    items: List[int] = field(default_factory=list)
    item_weights: List[int] = field(default_factory=list)  # 16.16
    # list: sum_weights[i] = sum(item_weights[:i+1]) (builder.c)
    sum_weights: List[int] = field(default_factory=list)
    # tree: node_weights over the implicit binary tree (builder.c)
    node_weights: List[int] = field(default_factory=list)
    num_nodes: int = 0
    # straw (legacy): per-item straw scaling factors, 16.16
    straws: List[int] = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class Rule:
    """crush.h -> struct crush_rule (+ crush_rule_mask)."""

    rule_id: int
    type: int = RULE_TYPE_REPLICATED
    min_size: int = 1
    max_size: int = 10
    steps: List[Tuple[int, int, int]] = field(default_factory=list)
    name: str = ""


def step_take(item: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_TAKE, item, 0)


def step_choose_firstn(n: int, type_: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_CHOOSE_FIRSTN, n, type_)


def step_choose_indep(n: int, type_: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_CHOOSE_INDEP, n, type_)


def step_chooseleaf_firstn(n: int, type_: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_CHOOSELEAF_FIRSTN, n, type_)


def step_chooseleaf_indep(n: int, type_: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_CHOOSELEAF_INDEP, n, type_)


def step_emit() -> Tuple[int, int, int]:
    return (CRUSH_RULE_EMIT, 0, 0)


def step_set_chooseleaf_tries(n: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_SET_CHOOSELEAF_TRIES, n, 0)


def step_set_choose_tries(n: int) -> Tuple[int, int, int]:
    return (CRUSH_RULE_SET_CHOOSE_TRIES, n, 0)


@dataclass
class Tunables:
    """crush.h tunable fields; defaults = upstream 'jewel' profile
    (CrushWrapper.h -> set_tunables_jewel)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    @classmethod
    def legacy(cls) -> "Tunables":
        """argonaut-era defaults (CrushWrapper.h -> set_tunables_legacy)."""
        return cls(choose_local_tries=2, choose_local_fallback_tries=5,
                   choose_total_tries=19, chooseleaf_descend_once=0,
                   chooseleaf_vary_r=0, chooseleaf_stable=0)


@dataclass
class ChooseArg:
    """crush.h -> struct crush_choose_arg: per-bucket weight_set (16.16
    weight vectors by result position) and/or ids override — the
    balancer's knob (CrushWrapper -> choose_args)."""

    weight_set: Optional[List[List[int]]] = None  # [position][item] 16.16
    ids: Optional[List[int]] = None


@dataclass
class CrushMap:
    """crush.h -> struct crush_map + CrushWrapper name/type maps."""

    buckets: Dict[int, Bucket] = field(default_factory=dict)  # id -> bucket
    rules: Dict[int, Rule] = field(default_factory=dict)
    max_devices: int = 0
    tunables: Tunables = field(default_factory=Tunables)
    # CrushWrapper name maps
    type_names: Dict[int, str] = field(default_factory=lambda: {0: "osd"})
    item_names: Dict[int, str] = field(default_factory=dict)
    # choose_args: name -> {bucket_id -> ChooseArg}
    choose_args: Dict[str, Dict[int, ChooseArg]] = field(default_factory=dict)
    # CrushWrapper class_map role: device id -> device class name
    # (recorded for interchange; shadow trees are not built yet)
    device_classes: Dict[int, str] = field(default_factory=dict)
    # tunables carried by real maps that don't affect placement here
    # (straw_calc_version, allowed_bucket_algs, ...) — preserved for
    # round-trips
    extra_tunables: Dict[str, int] = field(default_factory=dict)
    # CrushWrapper::class_bucket role: (original bucket id, class name)
    # -> shadow bucket id (built by CrushBuilder.populate_classes)
    class_bucket: Dict[Tuple[int, str], int] = field(default_factory=dict)

    def shadow_of(self, bid: int) -> Optional[Tuple[int, str]]:
        """(original id, class) when ``bid`` is a shadow bucket."""
        for (orig, cls), sid in self.class_bucket.items():
            if sid == bid:
                return orig, cls
        return None

    def bucket(self, item: int) -> Bucket:
        return self.buckets[item]

    def is_bucket(self, item: int) -> bool:
        return item < 0

    def item_type(self, item: int) -> int:
        return self.buckets[item].type if item < 0 else 0

    def device_weights(self, default: int = 0x10000) -> List[int]:
        """Flat 16.16 device reweight vector (OSDMap osd_weight analog)."""
        return [default] * self.max_devices
