"""Frozen copy of the project's ``ceph_tpu/crush/mapper.py``, the benchmark's
plain reference; it imports nothing but numpy and its siblings.

crush_do_rule host reference — src/crush/mapper.c.

A faithful Python transcription of the C evaluator: bucket choose for
all five algorithms (uniform perm / list / tree / straw / straw2),
crush_choose_firstn with the full retry ladder (collide/reject, local
retries, local fallback to exhaustive perm search, descent retries,
tunables), crush_choose_indep with positional r' strides and NONE holes,
chooseleaf recursion (vary_r / stable), is_out weight rejection, and the
rule interpreter (TAKE / CHOOSE* / SET_* / EMIT).

The benchmark's copy takes each straw2 bucket's draws over numpy
arrays (``bucket_straw2_choose``); everything else is the scalar
transcription.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .hash import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import crush_ln
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_NOOP,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    Bucket,
    ChooseArg,
    CrushMap,
)

S64_MIN = -(1 << 63)


def _h2(a, b) -> int:
    return int(crush_hash32_2(a, b))

def _h3(a, b, c) -> int:
    return int(crush_hash32_3(a, b, c))

def _h4(a, b, c, d) -> int:
    return int(crush_hash32_4(a, b, c, d))


def _div_trunc(a: int, b: int) -> int:
    """div64_s64: C division truncates toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class _PermWork:
    """Per-bucket permutation state (crush.h -> crush_work_bucket)."""

    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int) -> None:
        self.perm_x = 0
        self.perm_n = 0
        self.perm = list(range(size))


class CrushWork:
    """mapper.c -> crush_init_workspace equivalent."""

    def __init__(self, cmap: CrushMap) -> None:
        self.work: Dict[int, _PermWork] = {
            bid: _PermWork(b.size) for bid, b in cmap.buckets.items()}


def bucket_perm_choose(bucket: Bucket, work: _PermWork, x: int,
                       r: int) -> int:
    """mapper.c -> bucket_perm_choose (uniform bucket)."""
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = _h3(x, bucket.id, 0) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: just the r=0 slot filled
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        # clean up after the r=0 shortcut
        for i in range(1, bucket.size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = _h3(x, bucket.id, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = (work.perm[p],
                                                  work.perm[p + i])
        work.perm_n = p + 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c -> bucket_list_choose."""
    for i in range(bucket.size - 1, -1, -1):
        w = _h4(x, bucket.items[i], r, bucket.id) & 0xFFFF
        w *= bucket.sum_weights[i]
        w >>= 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_height(n: int) -> int:
    return (n & -n).bit_length() - 1


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c -> bucket_tree_choose."""
    n = bucket.num_nodes >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (_h4(x, n, r, bucket.id) * w) >> 32
        h = _tree_height(n)
        left = n - (1 << (h - 1))
        if t < bucket.node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c -> bucket_straw_choose (legacy)."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = (_h3(x, bucket.items[i], r) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def bucket_straw2_choose(bucket: Bucket, x: int, r: int,
                         arg: Optional[ChooseArg] = None,
                         position: int = 0) -> int:
    """mapper.c -> bucket_straw2_choose: hash & 0xffff -> crush_ln ->
    draw = ln / weight -> argmax (first index wins ties).  The draws of
    all items are taken at once over numpy arrays; the arithmetic and
    the tie rule are the scalar loop's."""
    weights = bucket.item_weights
    ids = bucket.items
    if arg is not None:
        if arg.weight_set:
            ws = arg.weight_set
            weights = ws[min(position, len(ws) - 1)]
        if arg.ids:
            ids = arg.ids
    w = np.asarray(weights, dtype=np.int64)
    u = crush_hash32_3(
        np.uint32(x & 0xFFFFFFFF),
        (np.asarray(ids, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32),
        np.uint32(r & 0xFFFFFFFF)).astype(np.int64) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    # div64_s64 truncates toward zero; ln <= 0 and w > 0 where drawn
    draw = np.where(w > 0, -((-ln) // np.maximum(w, 1)), S64_MIN)
    return bucket.items[int(np.argmax(draw))]


def crush_bucket_choose(bucket: Bucket, work: _PermWork, x: int, r: int,
                        arg: Optional[ChooseArg],
                        position: int) -> int:
    """mapper.c -> crush_bucket_choose dispatch."""
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    raise ValueError(f"unknown bucket alg {bucket.alg}")


def is_out(cmap: CrushMap, weight: Sequence[int], item: int, x: int) -> int:
    """mapper.c -> is_out: probabilistic rejection by device reweight."""
    if item >= len(weight):
        return 1
    w = weight[item]
    if w >= 0x10000:
        return 0
    if w == 0:
        return 1
    if (_h2(x, item) & 0xFFFF) < w:
        return 0
    return 1


def crush_choose_firstn(cmap: CrushMap, work: CrushWork, bucket: Bucket,
                        weight: Sequence[int], x: int, numrep: int,
                        type_: int, out: List[int], outpos: int,
                        out_size: int, tries: int, recurse_tries: int,
                        local_retries: int, local_fallback_retries: int,
                        recurse_to_leaf: bool, vary_r: int, stable: int,
                        out2: Optional[List[int]], parent_r: int,
                        choose_args: Optional[Dict[int, ChooseArg]]) -> int:
    """mapper.c -> crush_choose_firstn."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        item = 0
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                    collide = False
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = bucket_perm_choose(
                            in_bucket, work.work[in_bucket.id], x, r)
                    else:
                        item = crush_bucket_choose(
                            in_bucket, work.work[in_bucket.id], x, r,
                            choose_args.get(in_bucket.id)
                            if choose_args else None, outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break
                    itemtype = cmap.item_type(item)
                    if itemtype != type_:
                        if item >= 0 or item not in cmap.buckets:
                            skip_rep = True
                            break
                        in_bucket = cmap.buckets[item]
                        retry_bucket = True
                        continue
                    collide = False
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = crush_choose_firstn(
                                cmap, work, cmap.buckets[item], weight, x,
                                1 if stable else outpos + 1, 0, out2,
                                outpos, count, recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r,
                                choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = bool(is_out(cmap, weight, item, x))
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size
                          + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                    if not retry_bucket:
                        break
            # end retry_bucket loop
        # end retry_descent loop
        if skip_rep:
            rep += 1
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
        rep += 1
    return outpos


def crush_choose_indep(cmap: CrushMap, work: CrushWork, bucket: Bucket,
                       weight: Sequence[int], x: int, left: int,
                       numrep: int, type_: int, out: List[int],
                       outpos: int, tries: int, recurse_tries: int,
                       recurse_to_leaf: bool, out2: Optional[List[int]],
                       parent_r: int,
                       choose_args: Optional[Dict[int, ChooseArg]]) -> None:
    """mapper.c -> crush_choose_indep."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (in_bucket.alg == CRUSH_BUCKET_UNIFORM
                        and in_bucket.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = crush_bucket_choose(
                    in_bucket, work.work[in_bucket.id], x, r,
                    choose_args.get(in_bucket.id) if choose_args else None,
                    outpos)
                if item >= cmap.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = cmap.item_type(item)
                if itemtype != type_:
                    if item >= 0 or item not in cmap.buckets:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = cmap.buckets[item]
                    continue
                # mapper.c scans out[outpos..endpos).  Note the chooseleaf
                # recursion (out = parent's out2, outpos = rep, left = 1)
                # therefore does NOT dedup leaves across positions —
                # unlike firstn, whose recursion scans out2[0..outpos).
                # Only dual-homed devices (one osd under two buckets of
                # one tree, which real maps never produce) can observe
                # the difference; pinned by the dual-homed test against
                # the bulk evaluator.
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap, work, cmap.buckets[item], weight, x, 1,
                            numrep, 0, out2, rep, recurse_tries, 0,
                            False, None, r, choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(cmap, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
                  weight: Optional[Sequence[int]] = None,
                  choose_args: Optional[Dict[int, ChooseArg]] = None,
                  work: Optional[CrushWork] = None) -> List[int]:
    """mapper.c -> crush_do_rule: evaluate rule ``ruleno`` for input x.

    weight: per-device 16.16 reweight vector (default: all in).
    Returns the result vector (devices, or CRUSH_ITEM_NONE holes for
    indep rules)."""
    rule = cmap.rules[ruleno]
    if weight is None:
        weight = cmap.device_weights()
    if work is None:
        work = CrushWork(cmap)
    t = cmap.tunables
    choose_tries = t.choose_total_tries + 1  # "tries", not "retries"
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: List[int] = []
    w: List[int] = []
    for op, arg1, arg2 in rule.steps:
        if op == CRUSH_RULE_TAKE:
            if (0 <= arg1 < cmap.max_devices) or arg1 in cmap.buckets:
                w = [arg1]
            continue
        if op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                choose_local_retries = arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                choose_local_fallback_retries = arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
            continue
        if op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
            continue
        if op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSE_FIRSTN,
                  CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_INDEP):
            if not w:
                continue
            firstn = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            CRUSH_RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                     CRUSH_RULE_CHOOSELEAF_INDEP)
            # mapper.c hands each input bucket a fresh output segment
            # (out = o+osize, outpos = j = 0, out_size = result_max-osize,
            # out2 = c+osize): r-values restart at rep=0 per bucket and
            # collision scans never cross segment boundaries.
            o: List[int] = []
            c: List[int] = []
            osize = 0
            for wi in w:
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in cmap.buckets:
                    continue  # probably CRUSH_ITEM_NONE
                bucket = cmap.buckets[wi]
                seg = result_max - osize
                o_seg: List[int] = [0] * (seg + 8)
                c_seg: List[int] = [0] * (seg + 8)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    got = crush_choose_firstn(
                        cmap, work, bucket, weight, x, numrep, arg2,
                        o_seg, 0, seg, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, c_seg, 0, choose_args)
                else:
                    got = min(numrep, seg)
                    crush_choose_indep(
                        cmap, work, bucket, weight, x, got, numrep,
                        arg2, o_seg, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c_seg, 0, choose_args)
                o.extend(o_seg[:got])
                c.extend(c_seg[:got])
                osize += got
            w = c[:osize] if recurse_to_leaf else o[:osize]
            continue
        if op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
            continue
        if op == CRUSH_RULE_NOOP:
            continue
        raise ValueError(f"unknown rule op {op}")
    return result
