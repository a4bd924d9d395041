"""CRUSH map construction — src/crush/builder.c + CrushWrapper.{h,cc}.

crush_make_*_bucket aux-array math (list sums, tree node weights, legacy
straw scaling) and a CrushWrapper-style convenience layer: named types,
insert_item, rule creation, and whole-tree builders for tests/benches.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .types import (
    BUCKET_ALG_IDS,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    Bucket,
    CrushMap,
    Rule,
    Tunables,
    step_chooseleaf_firstn,
    step_chooseleaf_indep,
    step_emit,
    step_take,
)


def _calc_tree_depth(size: int) -> int:
    """builder.c -> calc_depth: ceil(log2(size)) + 1."""
    if size <= 1:
        return 1
    return (size - 1).bit_length() + 1


def _tree_parent(node: int) -> int:
    """mapper.c tree geometry: parent of node (height = lowest set bit)."""
    h = (node & -node).bit_length() - 1
    if (node >> (h + 1)) & 1:
        return node - (1 << h)
    return node + (1 << h)


def make_tree_aux(weights: Sequence[int]) -> Tuple[List[int], int]:
    """builder.c -> crush_make_tree_bucket: node_weights + num_nodes.

    Item i sits at node 2i+1; interior nodes accumulate subtree weight.
    """
    size = len(weights)
    depth = _calc_tree_depth(size)
    num_nodes = 1 << depth
    node_weights = [0] * num_nodes
    for i, w in enumerate(weights):
        node = 2 * i + 1
        node_weights[node] = w
        for _ in range(1, depth):
            node = _tree_parent(node)
            if node >= num_nodes:
                break
            node_weights[node] += w
    return node_weights, num_nodes


def make_list_aux(weights: Sequence[int]) -> List[int]:
    """builder.c -> crush_make_list_bucket: prefix sums."""
    sums = []
    total = 0
    for w in weights:
        total += w
        sums.append(total)
    return sums


def make_straws(weights: Sequence[int]) -> List[int]:
    """builder.c -> crush_calc_straw (legacy straw scaling, v1).

    Reverse-sorts by weight and scales each straw so the probability of
    winning matches the weight ratios; items of equal weight share a
    straw length.  Kept for capability parity; straw2 obsoletes it.
    """
    size = len(weights)
    if size == 0:
        return []
    reverse = sorted(range(size), key=lambda i: (-weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        # zero-weight items get zero-length straws (never chosen)
        straws[reverse[i]] = (int(straw * 0x10000)
                              if weights[reverse[i]] else 0)
        i += 1
        if i == size:
            break
        if weights[reverse[i]] == weights[reverse[i - 1]]:
            continue
        wbelow += (weights[reverse[i - 1]] - lastw) * numleft
        for j in range(i, size):
            if weights[reverse[j]] == weights[reverse[i]]:
                numleft -= 1
            else:
                break
        wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = weights[reverse[i - 1]]
    return straws


class CrushBuilder:
    """CrushWrapper-style map construction."""

    def __init__(self, tunables: Optional[Tunables] = None) -> None:
        self.map = CrushMap()
        if tunables is not None:
            self.map.tunables = tunables
        self._next_bucket = -1
        self._type_ids: Dict[str, int] = {"osd": 0}

    @classmethod
    def from_map(cls, cmap: CrushMap) -> "CrushBuilder":
        """Wrap an EXISTING map for further edits (CrushWrapper is
        always an owner-wrapper; maps loaded from text/JSON/binary or
        carried by an OSDMap re-enter the edit API this way)."""
        b = cls.__new__(cls)
        b.map = cmap
        b._next_bucket = min(cmap.buckets, default=0) - 1
        b._type_ids = {"osd": 0}  # implicit device type, as in __init__
        b._type_ids.update(
            {name: tid for tid, name in cmap.type_names.items()})
        return b

    # -- types / names ------------------------------------------------------

    def add_type(self, type_id: int, name: str) -> None:
        self.map.type_names[type_id] = name
        self._type_ids[name] = type_id

    def type_id(self, name) -> int:
        if isinstance(name, int):
            return name
        return self._type_ids[name]

    # -- buckets ------------------------------------------------------------

    def add_bucket(self, alg, type_name, items: Sequence[int],
                   weights: Optional[Sequence[int]] = None,
                   bucket_id: Optional[int] = None,
                   name: Optional[str] = None) -> int:
        """Create a bucket; weights are 16.16 ints (device weight 1.0 =
        0x10000).  Items may be devices (>= 0) or other buckets (< 0);
        bucket items contribute their own total weight by default."""
        if isinstance(alg, str):
            alg = BUCKET_ALG_IDS[alg]
        if bucket_id is None:
            bucket_id = self._next_bucket
        self._next_bucket = min(self._next_bucket, bucket_id) - 1
        if weights is None:
            weights = [self.map.buckets[i].weight if i < 0 else 0x10000
                       for i in items]
        weights = [int(w) for w in weights]
        items = [int(i) for i in items]
        b = Bucket(id=bucket_id, type=self.type_id(type_name), alg=alg,
                   items=items, item_weights=weights, weight=sum(weights))
        if alg == CRUSH_BUCKET_UNIFORM:
            if weights and len(set(weights)) != 1:
                raise ValueError("uniform bucket requires equal weights")
        elif alg == CRUSH_BUCKET_LIST:
            b.sum_weights = make_list_aux(weights)
        elif alg == CRUSH_BUCKET_TREE:
            b.node_weights, b.num_nodes = make_tree_aux(weights)
        elif alg == CRUSH_BUCKET_STRAW:
            b.straws = make_straws(weights)
        elif alg != CRUSH_BUCKET_STRAW2:
            raise ValueError(f"unknown bucket alg {alg}")
        self.map.buckets[bucket_id] = b
        for it in items:
            if it >= 0:
                self.map.max_devices = max(self.map.max_devices, it + 1)
        if name:
            self.map.item_names[bucket_id] = name
        return bucket_id

    # -- rules --------------------------------------------------------------

    def add_rule(self, rule_id: int, steps, name: str = "",
                 rule_type: int = 1) -> int:
        self.map.rules[rule_id] = Rule(rule_id=rule_id, type=rule_type,
                                       steps=list(steps), name=name)
        return rule_id

    def resolve_bucket(self, name: str, device_class: str = "") -> int:
        """Bucket id by item name (CrushWrapper::get_item_id), optionally
        redirected to its device-class shadow."""
        by_name = {v: k for k, v in self.map.item_names.items()}
        if name not in by_name:
            raise ValueError(f"{name!r} is not a named bucket in this map")
        bid = by_name[name]
        if device_class:
            bid = self.get_shadow(bid, device_class)
        return bid

    def add_erasure_rule(self, root_name: str, choose_steps,
                         rule_id: Optional[int] = None, name: str = "",
                         device_class: str = "") -> int:
        """The canonical EC rule scaffold every plugin's create_rule
        (ErasureCodeInterface::create_ruleset analog) shares:
        set_chooseleaf_tries 5, set_choose_tries 100, take
        <root[~class]>, *choose_steps, emit — rule type erasure."""
        from .types import (
            RULE_TYPE_ERASURE,
            step_emit,
            step_set_choose_tries,
            step_set_chooseleaf_tries,
            step_take,
        )
        root = self.resolve_bucket(root_name, device_class)
        steps = [step_set_chooseleaf_tries(5),
                 step_set_choose_tries(100), step_take(root),
                 *choose_steps, step_emit()]
        if rule_id is None:
            rule_id = max(self.map.rules, default=-1) + 1
        return self.add_rule(rule_id, steps, name=name or "erasure",
                             rule_type=RULE_TYPE_ERASURE)

    def add_simple_rule(self, rule_id: int, root: int, failure_domain,
                        n: int = 0, firstn: bool = True,
                        name: str = "") -> int:
        """CrushWrapper::add_simple_rule: take root -> chooseleaf over the
        failure domain -> emit."""
        ft = self.type_id(failure_domain)
        choose = (step_chooseleaf_firstn(n, ft) if firstn
                  else step_chooseleaf_indep(n, ft))
        return self.add_rule(rule_id, [step_take(root), choose,
                                       step_emit()], name=name)

    # -- device classes / shadow trees (CrushWrapper::populate_classes) -----

    def set_item_class(self, device: int, class_name: str) -> None:
        """CrushWrapper::set_item_class (devices only here)."""
        if device < 0:
            raise ValueError("classes attach to devices, not buckets")
        self.map.device_classes[device] = class_name

    def populate_classes(self) -> None:
        """Build per-class shadow trees (CrushWrapper::populate_classes
        -> device_class_clone): for every class and every bucket whose
        subtree contains a device of that class, create a clone holding
        only that class's items, with recomputed weights and fresh
        negative ids.  `step take <bucket> class <c>` then resolves to
        the clone via map.class_bucket.  Idempotent: existing shadows
        are rebuilt in place (same ids) so weight edits propagate."""
        cmap = self.map
        # include classes that only exist as stale shadows (their last
        # device was removed/re-classed): clone() sweeps them away
        classes = sorted(set(cmap.device_classes.values())
                         | {cls for (_, cls) in cmap.class_bucket})
        shadow_ids = set(cmap.class_bucket.values())
        originals = [bid for bid in sorted(cmap.buckets, reverse=True)
                     if bid not in shadow_ids]
        # shadow ids are placement-relevant (choosing among buckets
        # hashes the item ids, which at interior levels ARE the shadow
        # ids) — honor ids pinned by a parsed map ("id -N class C"
        # lines) and allocate fresh ones below everything else
        floor = min([0] + list(cmap.buckets)
                    + list(cmap.class_bucket.values()))
        next_free = [floor - 1]

        def clone(bid: int, cls: str) -> Optional[int]:
            b = cmap.buckets[bid]
            items: List[int] = []
            weights: List[int] = []
            for it, w in zip(b.items, b.item_weights):
                if it >= 0:
                    if cmap.device_classes.get(it) == cls:
                        items.append(it)
                        weights.append(w)
                else:
                    sub = cmap.class_bucket.get((it, cls))
                    if sub is not None and sub in cmap.buckets:
                        items.append(sub)
                        weights.append(cmap.buckets[sub].weight)
            if not items:
                # class died out of this subtree: drop any stale shadow
                stale = cmap.class_bucket.pop((bid, cls), None)
                if stale is not None:
                    cmap.buckets.pop(stale, None)
                    cmap.item_names.pop(stale, None)
                return None
            sid = cmap.class_bucket.get((bid, cls))
            if sid is None:
                sid = next_free[0]
                next_free[0] -= 1
            else:
                cmap.buckets.pop(sid, None)  # rebuild in place, same id
            sid = self.add_bucket(b.alg, b.type, items, weights,
                                  bucket_id=sid)
            cmap.class_bucket[(bid, cls)] = sid
            name = cmap.item_names.get(bid)
            if name:
                cmap.item_names[sid] = f"{name}~{cls}"
            return sid

        # children before parents (originals sorted by id descending is
        # not a topological order in general; recurse instead)
        done = set()

        def build(bid: int, cls: str) -> None:
            if (bid, cls) in done:
                return
            done.add((bid, cls))
            for it in cmap.buckets[bid].items:
                if it < 0 and it not in shadow_ids:
                    build(it, cls)
            clone(bid, cls)

        for cls in classes:
            for bid in originals:
                build(bid, cls)

    def get_shadow(self, bucket_id: int, class_name: str) -> int:
        """Shadow bucket id for `take <bucket> class <class>`."""
        sid = self.map.class_bucket.get((bucket_id, class_name))
        if sid is None or sid not in self.map.buckets:
            raise ValueError(
                f"no class {class_name!r} shadow for bucket {bucket_id} "
                "(no such class, no class device under the bucket, or "
                "populate_classes() not run)")
        return sid

    # -- weight editing (CrushWrapper::adjust_item_weight & co.) ------------

    def _parents_of(self, item: int) -> List[int]:
        """Primary buckets containing ``item`` (shadow clones are
        derived state: the edit APIs touch originals and regenerate
        shadows via populate_classes)."""
        shadow_ids = set(self.map.class_bucket.values())
        return [bid for bid, b in self.map.buckets.items()
                if item in b.items and bid not in shadow_ids]

    def _rebuild_aux(self, bucket: Bucket) -> None:
        bucket.weight = sum(bucket.item_weights)
        if bucket.alg == CRUSH_BUCKET_LIST:
            bucket.sum_weights = make_list_aux(bucket.item_weights)
        elif bucket.alg == CRUSH_BUCKET_TREE:
            bucket.node_weights, bucket.num_nodes = make_tree_aux(
                bucket.item_weights)
        elif bucket.alg == CRUSH_BUCKET_STRAW:
            bucket.straws = make_straws(bucket.item_weights)

    def adjust_item_weight(self, item: int, weight: int) -> int:
        """CrushWrapper::adjust_item_weight: set ``item``'s weight in
        every bucket containing it and propagate the delta to all
        ancestors (aux arrays rebuilt).  Returns the number of buckets
        changed.  Rebuilds shadow trees when present."""
        changed = 0
        for bid in self._parents_of(item):
            b = self.map.buckets[bid]
            i = b.items.index(item)
            if b.alg == CRUSH_BUCKET_UNIFORM and len(set(
                    b.item_weights[:i] + [weight]
                    + b.item_weights[i + 1:])) > 1:
                raise ValueError("uniform bucket requires equal weights")
            b.item_weights[i] = int(weight)
            self._rebuild_aux(b)
            changed += 1
            self._propagate_weight(bid)
        if changed and self.map.class_bucket:
            self.populate_classes()
        return changed

    def _propagate_weight(self, bucket_id: int) -> None:
        for pid in self._parents_of(bucket_id):
            p = self.map.buckets[pid]
            i = p.items.index(bucket_id)
            p.item_weights[i] = self.map.buckets[bucket_id].weight
            self._rebuild_aux(p)
            self._propagate_weight(pid)

    def insert_item(self, device: int, weight: int, bucket_id: int,
                    name: Optional[str] = None,
                    class_name: Optional[str] = None) -> None:
        """CrushWrapper::insert_item (flat form: into one bucket)."""
        b = self.map.buckets[bucket_id]
        if device in b.items:
            raise ValueError(f"item {device} already in {bucket_id}")
        b.items.append(int(device))
        b.item_weights.append(int(weight))
        self._rebuild_aux(b)
        self._propagate_weight(bucket_id)
        if device >= 0:
            self.map.max_devices = max(self.map.max_devices, device + 1)
        if name:
            self.map.item_names[device] = name
        if class_name:
            self.map.device_classes[device] = class_name
        if self.map.class_bucket:
            self.populate_classes()

    def remove_item(self, item: int) -> int:
        """CrushWrapper::remove_item: drop from every containing
        bucket; returns the number of buckets changed.  Removing a
        non-empty bucket is refused (upstream returns -ENOTEMPTY);
        removing an empty bucket also deletes its node."""
        if item < 0 and self.map.buckets.get(item) is not None \
                and self.map.buckets[item].items:
            raise ValueError(
                f"bucket {item} is not empty (ENOTEMPTY); remove or "
                "move its items first")
        changed = 0
        for bid in self._parents_of(item):
            b = self.map.buckets[bid]
            i = b.items.index(item)
            del b.items[i]
            del b.item_weights[i]
            self._rebuild_aux(b)
            self._propagate_weight(bid)
            changed += 1
        if item < 0:
            self.map.buckets.pop(item, None)
        # CrushWrapper::remove_item erases the name map entry for
        # devices and buckets alike
        self.map.item_names.pop(item, None)
        self.map.device_classes.pop(item, None)
        if changed and self.map.class_bucket:
            self.populate_classes()
        return changed

    # -- convenience: whole trees -------------------------------------------

    def build_flat(self, n_devices: int, alg="straw2",
                   weights: Optional[Sequence[int]] = None,
                   name: str = "root") -> int:
        """One root bucket holding n devices."""
        self.add_type(1, "root") if 1 not in self.map.type_names else None
        return self.add_bucket(alg, 1, list(range(n_devices)), weights,
                               name=name)

    def build_two_level(self, n_hosts: int, devs_per_host: int,
                        alg="straw2") -> int:
        """root -> host -> osd tree (the standard test/bench shape)."""
        if 1 not in self.map.type_names:
            self.add_type(1, "host")
        if 2 not in self.map.type_names:
            self.add_type(2, "root")
        hosts = []
        for h in range(n_hosts):
            devs = list(range(h * devs_per_host, (h + 1) * devs_per_host))
            hosts.append(self.add_bucket(alg, "host", devs,
                                         name=f"host{h}"))
        return self.add_bucket(alg, "root", hosts, name="root")
