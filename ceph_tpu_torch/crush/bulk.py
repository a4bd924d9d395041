"""Bulk CRUSH evaluator on torch — the port of ``ceph_tpu.crush.bulk``,
the replacement for the serial `crushtool --test` loop
(src/crush/CrushTester.cc -> CrushTester::test, src/crush/mapper.c ->
crush_do_rule).

Placement is embarrassingly parallel over the input x (the pg seed), so
the map becomes dense tables on the device and `crush_do_rule` becomes
one program over a leading lane dimension N, written in eager torch:

- buckets -> padded (B, S) item/weight tables; straw2 selection is a
  masked argmin of negln[u] // w over hash32_3 draws (negln is the
  64Ki-entry table 2^48 - crush_ln(u): u is 16-bit, so the whole 16.48
  fixed-point pipeline is one gather);
- hierarchy descent -> unrolled to the level distance of a regular
  hierarchy; each level reads only as many slots as that level's widest
  bucket holds (``level_width``);
- retry ladders -> attempt *batches*: firstn computes all T candidate
  descents per replica at once (r = rep+0..T-1 are independent) and
  picks the first acceptable; indep runs T rounds over the candidate
  grid.  Lanes that exhaust a rung's budget are flagged, re-run on a
  deeper rung, and the residue of the deepest rung is evaluated exactly
  on the host mapper, so results are ALWAYS identical to mapper.py / the
  C semantics, at any budget.

Every function carries the lane dimension explicitly (the reference
writes one lane and vmaps it): a tensor of the grid has N (or 1, when it
is the same for every lane) as its first dimension.  The reference's
``lax.scan`` over indep rounds is a Python loop over the static round
count; each ``lax.while_loop`` fixpoint is a Python loop with the same
exit condition, tested on the host, that re-runs only the lanes whose
condition still holds (a lane whose condition is false has a fixed
state, so this changes where lanes are computed, never the results).
Each host sync (a lane mask's indices, a readback, a blocking copy of
host data to the device, a 0-d index tensor read as an integer) runs
inside a ``crush.sync`` span (``telemetry/spans.py``) and is counted by
one function, ``_count_sync``, twice: in ``crush_bulk_host_syncs``
(``utils/perf.py``'s registry) and, while the span tracer is armed, as
``host_syncs`` of the open span.  A call's other
spans: ``crush.rung`` per rung of the ladder (attrs ``tries``,
``lanes``; its self time is the host's issue of the rung's kernels) and
``crush.host_residue`` over the host mapper's lanes (counts
``residue_lanes``).

torch has no uint32 arithmetic: the hash runs over int32 bits
(``hash.hash32_*_torch``), the tree bucket's (hash * w) >> 32 product is
split so int64 never overflows, and every gather index is clamped in
range (torch raises where XLA clamps).

Scope and gates as the reference: all five bucket algorithms
(alg-dispatched per bucket row; legacy tables exist only where those
algorithms do), jewel tunables, regular hierarchies, chained steps only
with n = 1.  Deliberate differences: no jit and no compile step, so
every rung of the ladder runs (the reference skips a rung it has not
compiled for a residue under 512 lanes); blocks are sized by the bytes
their widest grid holds (``block_lanes``), not by a lane budget; no mesh
or profiler seam.  The first rung's block dispatch is the supervised
seam ``crush.bulk_rule`` (ops/supervisor.py), its host twin the exact
host mapper (for a map on the CPU; on the card a persistent failure
raises ``DeviceDispatchError``).

On the card the first rung runs the CUDA rule kernel
(ops/crush_kernels.py, ``csrc/crush_rule.cu``: one warp a lane, mapper.c's
tries in order, the rule's own budgets) wherever the compiled map and
the rule are in its scope (``_rule_kernel``); it notes ``kernel_lanes``
and ``kernel_flagged`` under the first ``crush.rung``.  The eager program
below serves the deeper rungs, maps and rules outside that scope, and
the CPU.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import crush_kernels
from ..ops.fallback import resolve_device
from ..ops.supervisor import global_supervisor
from ..telemetry import spans
from ..utils.perf import global_perf
from .hash import as_hash_input, hash32_2_torch, hash32_3_torch, \
    hash32_4_torch
from .ln import crush_ln
from .mapper import crush_do_rule
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    ChooseArg,
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
    CrushMap,
)

S64_MAX = (1 << 63) - 1
NONE = CRUSH_ITEM_NONE
UNDEF = -0x7FFFFFFF

# attempts per replica/round on the device; failures beyond this go to
# a deeper rung and finally to the exact host mapper.  Wide rules
# auto-scale it (auto_tries).
DEFAULT_BULK_TRIES = 8

# device budget for the chooseleaf leaf-retry ladders; deeper
# SET_CHOOSELEAF_TRIES values model the first 8 attempts and flag the
# (vanishingly rare) lane whose accepted candidate exhausts them
LEAF_TRIES_CAP = 8

FIRST_PASS_TRIES = 2  # covers the no-collision common case

# block sizing: a block holds at most BLOCK_BYTES in its widest grid,
# at BYTES_PER_ELEMENT live bytes per grid element (the straw2 draw: the
# hash's int32 temporaries, the int64 numerator, quotient and weights),
# and at most MAX_BLOCK lanes
BLOCK_BYTES = 16 << 30
BYTES_PER_ELEMENT = 96
MAX_BLOCK = 1 << 20

# negln[u] = 2^48 - crush_ln(u): the straw2 numerator, one gather
_NEGLN = (1 << 48) - np.asarray(crush_ln(np.arange(0x10000)))


def _count_sync() -> None:
    """Count one host sync: ``crush_bulk_host_syncs``, and ``host_syncs``
    of the open armed span."""
    global_perf().inc("crush_bulk_host_syncs")
    spans.note("host_syncs")


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the true lanes of a (N,) mask (a host sync)."""
    with spans.child("crush.sync"):
        _count_sync()
        return mask.nonzero().flatten()


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Host data (a number, a sequence or a numpy array) as a tensor on
    ``device``: a blocking copy from pageable memory, a host sync on the
    card (counted on every device, as the other syncs are) unless there
    is nothing to copy."""
    if not np.size(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    with spans.child("crush.sync"):
        _count_sync()
        return torch.as_tensor(a, dtype=dtype, device=device)


def _at(table: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """``table[index]``.  torch reads a 0-d index tensor on the host, as
    an integer (a host sync each): the take bucket's row in a descent's
    first step is one."""
    key = index if len(index) > 1 else index[0]
    held = sum(i.dim() == 0 for i in index)
    if not held:
        return table[key]
    with spans.child("crush.sync"):
        for _ in range(held):
            _count_sync()
        return table[key]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values in host memory (a host sync unless it is
    empty: torch copies nothing then)."""
    if not t.numel():
        return t.cpu().numpy()
    with spans.child("crush.sync"):
        _count_sync()
        return t.cpu().numpy()


class CompiledCrushMap:
    """Dense-tensor form of a CrushMap for the bulk evaluator, on
    ``device`` (default: the card; ``"cpu"`` runs on the CPU).

    ``choose_args`` (crush.h -> crush_choose_arg; the balancer's knob)
    are baked into the tables: per-bucket hash-id overrides become an
    alternate id table, and per-position weight_set vectors become a
    (bucket, position, slot) weight tensor indexed by the result
    position (padded positions replicate each bucket's last vector,
    matching bucket_straw2_choose's min(position, size-1) clamp).
    Item and id tables hold int32 (a negative id's bits are its uint32
    hash input); everything used as an index or in 64-bit math is int64.
    """

    def __init__(self, cmap: CrushMap,
                 choose_args: Optional[Dict[int, "ChooseArg"]] = None,
                 device=None) -> None:
        for b in cmap.buckets.values():
            if b.alg not in (CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_STRAW,
                             CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
                             CRUSH_BUCKET_UNIFORM):
                raise ValueError(
                    f"bucket alg {b.alg} is not fused; use engine=host")
        self.device = resolve_device(device)
        self.cmap = cmap
        self.choose_args = choose_args
        ids = sorted(cmap.buckets)          # negative ids
        self.n_buckets = len(ids)
        self.row_of_id = {bid: i for i, bid in enumerate(ids)}
        S = max((cmap.buckets[b].size for b in ids), default=1)
        self.max_size = max(S, 1)
        S = self.max_size
        P = 1
        if choose_args:
            P = max([1] + [len(a.weight_set) for a in choose_args.values()
                           if a.weight_set])
        self.n_positions = P
        nb = max(self.n_buckets, 1)
        items = np.full((nb, S), NONE, np.int32)
        hash_ids = np.full((nb, S), NONE, np.int32)
        pos_weights = np.zeros((nb, P, S), np.int64)
        types = np.zeros(nb, np.int64)
        sizes = np.zeros(nb, np.int64)
        algs = np.zeros(nb, np.int64)
        bids = np.zeros(nb, np.int32)
        straws = np.zeros((nb, S), np.int64)
        sum_weights = np.zeros((nb, S), np.int64)
        raw_weights = np.zeros((nb, S), np.int64)
        NN = max((cmap.buckets[b].num_nodes for b in ids
                  if cmap.buckets[b].alg == CRUSH_BUCKET_TREE),
                 default=0)
        node_weights = np.zeros((nb, max(NN, 1)), np.int64)
        tree_roots = np.ones(nb, np.int64)
        tree_steps = 0
        for bid, row in self.row_of_id.items():
            b = cmap.buckets[bid]
            items[row, :b.size] = b.items
            hash_ids[row, :b.size] = b.items
            pos_weights[row, :, :b.size] = b.item_weights
            types[row] = b.type
            sizes[row] = b.size
            algs[row] = b.alg
            bids[row] = bid
            raw_weights[row, :b.size] = b.item_weights
            if b.alg == CRUSH_BUCKET_STRAW:
                straws[row, :b.size] = b.straws
            if b.alg == CRUSH_BUCKET_TREE:
                if max(b.node_weights, default=0) >= 1 << 32:
                    # crush.h node_weights are __u32; a wider weight is
                    # unrepresentable in the wire format and would wrap
                    # the (hash * w) >> 32 product
                    raise ValueError(
                        f"tree bucket {bid} node weight exceeds __u32; "
                        "not fused — use engine=host")
                node_weights[row, :b.num_nodes] = b.node_weights
                tree_roots[row] = b.num_nodes >> 1
                tree_steps = max(tree_steps,
                                 max(b.num_nodes.bit_length() - 2, 0))
            if b.alg == CRUSH_BUCKET_LIST:
                sum_weights[row, :b.size] = b.sum_weights
            arg = choose_args.get(bid) if choose_args else None
            if arg is not None:
                if arg.ids:
                    hash_ids[row, :b.size] = arg.ids[:b.size]
                if arg.weight_set:
                    ws = arg.weight_set
                    for p in range(P):
                        pos_weights[row, p, :b.size] = \
                            ws[min(p, len(ws) - 1)][:b.size]
        self.algs_present = sorted(set(int(cmap.buckets[b].alg)
                                       for b in ids))
        # uniform: the perm unroll length is the widest uniform bucket
        # (Fisher-Yates steps are recomputed per lane; see _uniform)
        self.max_uniform_size = max(
            (cmap.buckets[b].size for b in ids
             if cmap.buckets[b].alg == CRUSH_BUCKET_UNIFORM), default=0)
        max_neg = max((-bid for bid in ids), default=0)
        i2r = np.full(max_neg + 1, 0, np.int64)
        for bid, row in self.row_of_id.items():
            i2r[-1 - bid] = row
        self.max_neg = max_neg

        def put(a):
            return _to_device(a, self.device)

        self.items = put(items)
        self.hash_ids = put(hash_ids)
        self.pos_weights = put(pos_weights)
        self.types = put(types)
        self.sizes = put(sizes)
        self.algs = put(algs)
        self.slot = torch.arange(S, device=self.device)
        # legacy-alg tables upload only when those algorithms exist in
        # the map (pure-straw2 maps allocate none of them)
        has_straw = CRUSH_BUCKET_STRAW in self.algs_present
        has_list = CRUSH_BUCKET_LIST in self.algs_present
        has_tree = CRUSH_BUCKET_TREE in self.algs_present
        has_uniform = CRUSH_BUCKET_UNIFORM in self.algs_present
        self.straws = put(straws) if has_straw else None
        self.bucket_ids = put(bids) \
            if (has_list or has_tree or has_uniform) else None
        self.sum_weights = put(sum_weights) if has_list else None
        self.raw_weights = put(raw_weights) if has_list else None
        self.node_weights = put(node_weights) if has_tree else None
        self.tree_roots = put(tree_roots) if has_tree else None
        self.tree_steps = tree_steps
        self.id_to_row = put(i2r)
        self.negln = put(_NEGLN)
        self.max_depth = self._depth(cmap)
        self.type_level = self._type_levels(cmap)
        # widest bucket per hierarchy level (regular maps): a descent
        # step at that level reads only that many slots
        self.level_width: Dict[int, int] = {}
        if self.type_level is not None:
            for b in cmap.buckets.values():
                lv = self.type_level[b.type]
                self.level_width[lv] = max(self.level_width.get(lv, 1),
                                           b.size)
        self._fn_cache: Dict[tuple, object] = {}
        # lane indices the first rung flagged, and those of the host
        # residue, in the last bulk_do_rule call on this map (for checks)
        self.last_flagged = np.empty(0, np.int64)
        self.last_residue = np.empty(0, np.int64)

    @staticmethod
    def _type_levels(cmap: CrushMap) -> Optional[Dict[int, int]]:
        """If the hierarchy is regular (every bucket's items all sit at
        one level, consistent per bucket type), return type -> level
        (devices = 0); else None.  Regularity lets _descend unroll
        exactly level(start) - level(target) picks instead of the tree
        depth."""
        def bucket_level(bid: int) -> Optional[int]:
            if bid >= 0:
                return 0
            b = cmap.buckets[bid]
            kids = {bucket_level(i) for i in b.items}
            if len(kids) != 1 or None in kids:
                return None
            return 1 + kids.pop()

        levels: Dict[int, int] = {}
        for bid, b in cmap.buckets.items():
            lv = bucket_level(bid)
            if lv is None:
                return None
            if levels.setdefault(b.type, lv) != lv:
                return None
        levels[0] = 0
        return levels

    def descend_steps(self, start_type: Optional[int],
                      target_type: int) -> int:
        """Unroll count for a descent from start_type to target_type."""
        if (self.type_level is not None and start_type is not None
                and start_type in self.type_level
                and target_type in self.type_level):
            return max(self.type_level[start_type]
                       - self.type_level[target_type], 0)
        return self.max_depth + 1

    def level_of(self, type_: Optional[int]) -> Optional[int]:
        """Hierarchy level of a bucket type (None when unknown)."""
        if self.type_level is None or type_ is None:
            return None
        return self.type_level.get(type_)

    def width_at(self, level: Optional[int]) -> int:
        """Slots a descent step at ``level`` reads."""
        if level is None:
            return self.max_size
        return min(self.level_width.get(level, self.max_size),
                   self.max_size)

    @staticmethod
    def _depth(cmap: CrushMap) -> int:
        depth: Dict[int, int] = {}

        def d(bid: int) -> int:
            if bid >= 0:
                return 0
            if bid not in depth:
                b = cmap.buckets[bid]
                depth[bid] = 1 + max((d(i) for i in b.items), default=0)
            return depth[bid]

        return max((d(bid) for bid in cmap.buckets), default=1)

    def row(self, item: torch.Tensor) -> torch.Tensor:
        """Table row of bucket ids (int64; clamped for non-buckets)."""
        return _at(self.id_to_row,
                   (-1 - item.long()).clamp(0, self.max_neg))

    def kernel_tables(self) -> crush_kernels.KernelTables:
        """These tables as the CUDA rule kernel reads them
        (ops/crush_kernels.py): the padded rows flattened to their valid
        slots, on this map's device, built once (one host sync, the
        valid slots' indices)."""
        tabs = self.__dict__.get("_kernel_tables")
        if tabs is None:
            idx = _nonzero((self.slot < self.sizes[:, None]).flatten())
            P = self.n_positions
            weights = self.pos_weights.transpose(0, 1).reshape(P, -1)
            hdr = torch.stack([self.sizes.cumsum(0) - self.sizes,
                               self.sizes, self.types], 1)
            tab = torch.cat([hdr.flatten(), self.id_to_row,
                             self.items.flatten()[idx].long(),
                             self.hash_ids.flatten()[idx].long(),
                             weights[:, idx].flatten()])
            tabs = self._kernel_tables = crush_kernels.KernelTables(
                as_hash_input(tab).contiguous(), self.negln,
                rows=int(self.sizes.shape[0]), max_neg=self.max_neg,
                items=int(idx.numel()), positions=P, cmap=self.cmap,
                choose_args=self.choose_args)
        return tabs


class _Weights(NamedTuple):
    """The device reweight vector (at least one entry), its true
    length, and whether every entry is in (>= 0x10000): then is_out
    rejects only out-of-range items."""
    vec: torch.Tensor
    n: int
    all_in: bool

    @classmethod
    def of(cls, weight_vec: torch.Tensor, all_in: Optional[bool] = None):
        n = int(weight_vec.numel())
        if all_in is None:
            with spans.child("crush.sync"):
                _count_sync()
                all_in = bool((weight_vec >= 0x10000).all())
        if n == 0:
            weight_vec = torch.zeros(1, dtype=torch.long,
                                     device=weight_vec.device)
        return cls(weight_vec, n, all_in)


def _lanes(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) lane values shaped to broadcast against an ndim grid."""
    return x.view((x.shape[0],) + (1,) * (ndim - 1))


def _first_true(b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first true entry along ``dim`` (0 when none):
    torch's argmax refuses bool and returns the first maximal index."""
    return b.to(torch.uint8).argmax(dim)


def _take_last(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[..., idx] along the last axis; the leading dims broadcast."""
    lead = torch.broadcast_shapes(t.shape[:-1], idx.shape)
    t = t.expand(*lead, t.shape[-1])
    return torch.gather(t, -1, idx.expand(lead).unsqueeze(-1)).squeeze(-1)


def _take_along(t: torch.Tensor, idx: torch.Tensor, dim: int):
    """t indexed by ``idx`` along ``dim`` (idx has t's other dims)."""
    return _take_last(t.movedim(dim, -1), idx)


def _straw2(cm: CompiledCrushMap, row, x, r, pos, S: int):
    """bucket_straw2_choose over table rows; ``row``, ``r`` (int64) and
    ``pos`` broadcast over the grid, x is (N,) int32 bits.

    ``pos``: result position for the choose_args weight_set lookup
    (mapper.c passes outpos; tables replicate each bucket's last vector
    past its length, so one global clamp suffices).  Hashing uses the
    per-bucket id table (choose_args ids override).

    draw = trunc((crush_ln(u) - 2^48) / w) = -(negln[u] // w) (positive
    operands: floor is C's truncation), and the first maximal draw wins;
    that is the first minimal quotient, with S64_MAX where C draws
    S64_MIN (weight 0, or a padding slot)."""
    items = _at(cm.items[:, :S], row)                  # row.shape + (S,)
    hash_ids = _at(cm.hash_ids[:, :S], row)
    if cm.n_positions == 1:
        weights = _at(cm.pos_weights[:, 0, :S], row)
    else:
        if not isinstance(pos, torch.Tensor):
            pos = _to_device(pos, row.device)
        pos_c = pos.clamp(max=cm.n_positions - 1)
        weights = _at(cm.pos_weights[:, :, :S], row, pos_c)
    valid = cm.slot[:S] < _at(cm.sizes, row).unsqueeze(-1)
    u = hash32_3_torch(_lanes(x, r.dim() + 1), hash_ids,
                       r.to(torch.int32).unsqueeze(-1)) & 0xFFFF
    q = cm.negln[u.long()] // weights.clamp(min=1)
    q = torch.where(valid & (weights > 0), q, S64_MAX)
    return _take_last(items, q.argmin(-1))


def _straw_legacy(cm: CompiledCrushMap, row, x, r, S: int):
    """mapper.c -> bucket_straw_choose (legacy straw): draw =
    (hash32_3 & 0xffff) * straw, argmax first-wins.  choose_args do not
    apply to legacy straw (crush_bucket_choose passes them to straw2
    only)."""
    items = _at(cm.items[:, :S], row)
    valid = cm.slot[:S] < _at(cm.sizes, row).unsqueeze(-1)
    u = hash32_3_torch(_lanes(x, r.dim() + 1), items,
                       r.to(torch.int32).unsqueeze(-1)) & 0xFFFF
    draw = torch.where(valid, u.long() * _at(cm.straws[:, :S], row), -1)
    return _take_last(items, draw.argmax(-1))


def _list_choose(cm: CompiledCrushMap, row, x, r, S: int):
    """mapper.c -> bucket_list_choose: scan items from the tail; the
    first i with (hash32_4(x, item, r, bucket_id) & 0xffff) *
    sum_weights[i] >> 16 < item_weight[i] wins, else items[0]."""
    items = _at(cm.items[:, :S], row)
    valid = cm.slot[:S] < _at(cm.sizes, row).unsqueeze(-1)
    h = hash32_4_torch(_lanes(x, r.dim() + 1), items,
                       r.to(torch.int32).unsqueeze(-1),
                       _at(cm.bucket_ids, row).unsqueeze(-1)) & 0xFFFF
    t = (h.long() * _at(cm.sum_weights[:, :S], row)) >> 16
    cond = valid & (t < _at(cm.raw_weights[:, :S], row))
    # highest index with cond true (the C loop runs size-1 .. 0)
    rank = torch.where(cond, cm.slot[:S], -1)
    chosen = _take_last(items, rank.argmax(-1))
    return torch.where(cond.any(-1), chosen, items[..., 0])


def _mul_shr32(h, w):
    """(h * w) >> 32 for h, w < 2^32 without overflowing int64: with
    w = wh * 2^16 + wl it is (h * wh + ((h * wl) >> 16)) >> 16, every
    product below 2^48."""
    return (h * (w >> 16) + ((h * (w & 0xFFFF)) >> 16)) >> 16


def _tree_choose(cm: CompiledCrushMap, row, x, r, S: int):
    """mapper.c -> bucket_tree_choose: walk the implicit binary tree
    from the root node (num_nodes >> 1); at node n descend left when
    (hash32_4(x, n, r, bucket_id) * node_weight(n)) >> 32 falls under
    the left child's weight.  Unrolled to the deepest tree in the map;
    terminal (odd) nodes hold their value.  left/right = n -/+ half the
    lowbit (the height-derived stride)."""
    nw = _at(cm.node_weights, row)             # row.shape + (NN,)
    top = nw.shape[-1] - 1
    n = _at(cm.tree_roots, row)
    bid = _at(cm.bucket_ids, row)
    xl = _lanes(x, r.dim())
    r32 = r.to(torch.int32)
    for _ in range(cm.tree_steps):
        half = (n & -n) >> 1
        left = n - half
        w = _take_last(nw, n.clamp(0, top))
        h = hash32_4_torch(xl, n.to(torch.int32), r32, bid).long() \
            & 0xFFFFFFFF
        t = _mul_shr32(h, w)
        wl = _take_last(nw, left.clamp(0, top))
        nxt = torch.where(t < wl, left, n + half)
        n = torch.where((n & 1) == 1, n, nxt)
    return _take_last(_at(cm.items[:, :S], row), (n >> 1).clamp(0, S - 1))


def _uniform_choose(cm: CompiledCrushMap, row, x, r, S: int):
    """mapper.c -> bucket_perm_choose (uniform buckets), functional.

    The C keeps per-bucket permutation *state* (perm_x / perm_n / the
    r=0 magic slot), but the visible sequence is a pure function of
    (x, r, bucket): pr = r % size, then the Fisher-Yates prefix
    perm[0..pr] with swap offsets i_p = hash32_3(x, bucket_id, p) %
    (size - p).  (The r=0 shortcut stores hash%size at slot 0 and the
    cleanup swaps it with identity — exactly what step p=0 of the full
    walk produces, so statefulness never shows.)  Each lane recomputes
    the prefix; the unroll length is the widest uniform bucket in the
    map."""
    size = _at(cm.sizes, row)
    bid = _at(cm.bucket_ids, row)
    pr = r % size.clamp(min=1)                    # C: unsigned r
    SU = max(cm.max_uniform_size, 1)
    ar = torch.arange(SU, device=r.device)
    perm = ar.expand(pr.shape + (SU,)).clone()
    xl = _lanes(x, pr.dim())
    for p in range(SU - 1):
        # while perm_n <= pr: step at p runs when p <= pr (and the
        # final-entry swap is skipped at p == size-1)
        i = (hash32_3_torch(xl, bid, p).long() & 0xFFFFFFFF) \
            % (size - p).clamp(min=1)
        active = (p <= pr) & (p < size - 1)
        idx = (p + i).clamp(max=SU - 1)
        pv = perm[..., p].unsqueeze(-1)
        iv = _take_last(perm, idx).unsqueeze(-1)
        swapped = torch.where(ar == p, iv, perm)
        swapped = torch.where(ar == idx.unsqueeze(-1), pv, swapped)
        perm = torch.where(active.unsqueeze(-1), swapped, perm)
    s = _take_last(perm, pr.clamp(max=SU - 1))
    return _take_last(_at(cm.items[:, :S], row), s.clamp(max=S - 1))


def _bucket_choose(cm: CompiledCrushMap, row, x, r, pos, S: int):
    """mapper.c -> crush_bucket_choose over the fused algorithms; only
    the algorithms present in the map are computed."""
    res = None
    if CRUSH_BUCKET_STRAW2 in cm.algs_present:
        res = _straw2(cm, row, x, r, pos, S)
    for alg, fn in ((CRUSH_BUCKET_STRAW, _straw_legacy),
                    (CRUSH_BUCKET_LIST, _list_choose),
                    (CRUSH_BUCKET_TREE, _tree_choose),
                    (CRUSH_BUCKET_UNIFORM, _uniform_choose)):
        if alg in cm.algs_present:
            c = fn(cm, row, x, r, S)
            res = c if res is None else torch.where(
                _at(cm.algs, row) == alg, c, res)
    return res


def _descend(cm: CompiledCrushMap, start_item, x, r, target_type,
             steps: int, pos, level: Optional[int],
             indep_f=None, indep_numrep: Optional[int] = None,
             return_last_r: bool = False):
    """Walk from start_item down to an item of target_type (mapper.c
    itemtype != type descent), unrolled ``steps`` times (regular
    hierarchies: exactly the level distance; else tree depth).
    ``start_item`` / ``r`` / ``pos`` broadcast over the lane grid
    (``r`` has the grid's number of dims); ``level`` is the start's
    hierarchy level, which sets how many slots each step reads (lanes
    not at that level are masked by every caller).

    indep mode (``indep_f``/``indep_numrep`` set): crush_choose_indep
    recomputes r at EVERY descent level from the CURRENT bucket —
    r = base + (numrep+1)*ftotal when it is uniform with size % numrep
    == 0, else base + numrep*ftotal — so the stride is applied here
    per level, not baked into the r grid.  ``return_last_r`` also
    returns the r used for each lane's final pick (the parent_r the C
    passes to the chooseleaf recursion)."""
    item = start_item
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    last_r = r
    for step in range(steps):
        is_bucket = item < 0
        row = cm.row(item)
        itype = torch.where(is_bucket, _at(cm.types, row), 0)
        arrived = itype == target_type
        if indep_f is None:
            r_lvl = r
        elif CRUSH_BUCKET_UNIFORM in cm.algs_present:
            stride = torch.where(
                (_at(cm.algs, row) == CRUSH_BUCKET_UNIFORM)
                & (_at(cm.sizes, row) % indep_numrep == 0),
                indep_numrep + 1, indep_numrep)
            r_lvl = r + stride * indep_f
        else:
            r_lvl = r + indep_numrep * indep_f
        S = cm.width_at(None if level is None else level - step)
        picked = _bucket_choose(cm, row, x, r_lvl, pos, S)
        picking = ~(done | arrived | ~is_bucket)
        item = torch.where(picking, picked, item)
        last_r = torch.where(picking, r_lvl, last_r)
        done = done | arrived | ~is_bucket
    is_bucket = item < 0
    itype = torch.where(is_bucket, _at(cm.types, cm.row(item)), 0)
    if return_last_r:
        return item, itype == target_type, last_r
    return item, itype == target_type


def _is_out(wt: _Weights, item, x):
    """mapper.c -> is_out (device reweight rejection); vectorized."""
    in_range = (item >= 0) & (item < wt.n)
    if wt.all_in:
        return ~in_range
    w = wt.vec[item.long().clamp(0, wt.vec.shape[0] - 1)]
    h = hash32_2_torch(_lanes(x, item.dim()), item.to(torch.int32)) \
        & 0xFFFF
    keep = (w >= 0x10000) | ((w > 0) & (h < w))
    return ~(in_range & keep)


def _fixpoint(state: list, lanes_of, step, iters: int) -> None:
    """Run ``step`` on the lanes ``lanes_of(state)`` selects, up to
    ``iters`` times, writing the results back into ``state`` (a list of
    per-lane tensors).  A lane that is not selected keeps its state —
    the reference's vmapped while_loop freezes it too, and its fixed
    loops recompute it to the same values."""
    for _ in range(iters):
        idx = _nonzero(lanes_of(state))
        if idx.numel() == 0:
            return
        new = step(idx, [t[idx] for t in state])
        for t, v in zip(state, new):
            t[idx] = v


def _choose_firstn(cm, take, x, numrep, type_, recurse_to_leaf,
                   wt, T, take_type, leaf_tries=1,
                   leaf_cap=LEAF_TRIES_CAP, leaf_fix_iters=1,
                   exact_budget=False):
    """mapper.c -> crush_choose_firstn, attempt-batched and leaf-lazy.

    The (numrep, T) domain candidate grid is one batched descent (r =
    rep + ftotal depends only on indices); the sequential part is the
    collision / first-acceptable scan per rep — identical to the C
    retry ladder under jewel tunables (no local retries).  Leaf
    recursions run ONLY for each rep's accepted candidate: C's
    recursion is numrep=1/stable with r' = sub_r + ftotal' (sub_r = r,
    vary_r=1; no uniform stride in firstn), up to ``leaf_tries``
    attempts, each rejected when out-weighted OR colliding with an
    EARLIER position's leaf (the out2[0..outpos) scan — unlike indep,
    firstn dedups leaves across positions, so leaf resolution stays
    inside the sequential rep loop).  A candidate whose ladder is
    dead for prefix-INDEPENDENT reasons is marked bad at its
    (rep, try) position and the scan re-runs (see the soundness note
    below; collision-caused ladder failures depend on the provisional
    prefix and flag need_host instead of marking; marking also requires
    the modeled ladder to cover C's full leaf budget).  Returns
    (out (N, numrep), count (N,), need_host (N,)).

    ``exact_budget``: an unfilled rep at the rule's own budget is C's
    own short result (the packing matches: C skips the rep without
    advancing outpos) — valid ONLY with single-position choose_args,
    because C hashes later picks with outpos (= placed count), which
    diverges from the static rep-indexed position grid once a rep
    fails."""
    N, dev = x.shape[0], x.device
    R = numrep
    rs = (torch.arange(R, device=dev)[:, None]
          + torch.arange(T, device=dev)[None, :])[None]      # (1, R, T)
    # choose_args position = outpos at bucket-choose time; every lane
    # the device keeps has all reps placed (see exact_budget note), so
    # outpos == rep for both the domain pick and the leaf recursion
    pos = torch.arange(R, device=dev)[None, :, None]         # (1, R, 1)
    exact_budget = exact_budget and cm.n_positions == 1
    items, okd = _descend(cm, _to_device(take, dev), x, rs,
                          type_, cm.descend_steps(take_type, type_), pos,
                          cm.level_of(take_type))
    items = items.to(torch.int32).expand(N, R, T)
    okd = okd.expand(N, R, T)
    if not recurse_to_leaf and type_ == 0:
        okd = okd & ~_is_out(wt, items, x)
    slots = torch.arange(R, device=dev)[None, :]

    if not recurse_to_leaf:
        out = torch.full((N, R), NONE, dtype=torch.int32, device=dev)
        placed_n = torch.zeros(N, dtype=torch.long, device=dev)
        need_host = torch.zeros(N, dtype=torch.bool, device=dev)
        for rep in range(R):
            cand = items[:, rep]                             # (N, T)
            collide = (out[:, None, :] == cand[:, :, None]).any(-1)
            ok = okd[:, rep] & ~collide
            any_ok = ok.any(-1)
            sel = _take_last(cand, _first_true(ok))
            fill = (slots == placed_n[:, None]) & any_ok[:, None]
            out = torch.where(fill, sel[:, None], out)
            placed_n = placed_n + any_ok
            if not exact_budget:
                need_host = need_host | ~any_ok
        return out, placed_n, need_host

    L = max(1, min(leaf_tries, LEAF_TRIES_CAP, leaf_cap))
    sound = L == leaf_tries
    fix = max(1, leaf_fix_iters) if sound else 1
    ls = torch.arange(L, device=dev)[None, :]                # (1, L)
    leaf_steps = cm.descend_steps(type_, 0)
    leaf_level = cm.level_of(type_)

    def accept_pass(x, items, okd, bad):
        n = x.shape[0]
        out = torch.full((n, R), NONE, dtype=torch.int32, device=dev)
        out2 = out.clone()
        placed_n = torch.zeros(n, dtype=torch.long, device=dev)
        fail_pure = torch.zeros((n, R), dtype=torch.bool, device=dev)
        coll_fail = torch.zeros_like(fail_pure)
        unfilled = torch.zeros_like(fail_pure)
        firsts = torch.zeros((n, R), dtype=torch.long, device=dev)
        for rep in range(R):
            cand = items[:, rep]                             # (n, T)
            collide = (out[:, None, :] == cand[:, :, None]).any(-1)
            ok = okd[:, rep] & ~collide & ~bad[:, rep]
            first = _first_true(ok)
            any_ok = ok.any(-1)
            sel_item = _take_last(cand, first)
            sub_r = rep + first                              # vary_r=1
            start = torch.where(any_ok, sel_item, -1)
            leaves, lok = _descend(cm, start[:, None], x,
                                   sub_r[:, None] + ls, 0, leaf_steps,
                                   rep, leaf_level)
            leaves = leaves.to(torch.int32).expand(n, L)
            # leaf_ok_pure is a pure function of (rep, try) — the
            # ONLY basis for fixpoint marks (see below); lcollide
            # depends on earlier positions' provisional leaves and
            # may only influence this pass's pick, never a mark
            leaf_ok_pure = lok & ~_is_out(wt, leaves, x)
            lcollide = (out2[:, None, :] == leaves[:, :, None]).any(-1)
            leaf_ok = leaf_ok_pure & ~lcollide
            lany = leaf_ok.any(-1)
            lany_pure = leaf_ok_pure.any(-1)
            placed = any_ok & lany
            fill = (slots == placed_n[:, None]) & placed[:, None]
            out = torch.where(fill, sel_item[:, None], out)
            out2 = torch.where(
                fill, _take_last(leaves, _first_true(leaf_ok))[:, None],
                out2)
            placed_n = placed_n + placed
            fail_pure[:, rep] = any_ok & ~lany_pure
            coll_fail[:, rep] = any_ok & lany_pure & ~lany
            firsts[:, rep] = first
            unfilled[:, rep] = ~any_ok
        return [out2, placed_n, fail_pure, coll_fail, firsts, unfilled]

    # Fixpoint soundness for firstn: a candidate may fail its ladder
    # for two reasons — every attempt dead (out-weighted / no leaf),
    # which is prefix-INDEPENDENT and safe to mark bad (C rejects it
    # against any prefix), or attempts alive but colliding with
    # EARLIER positions' leaves, which depends on the pass's
    # provisional prefix and must NOT be marked (C might accept it
    # against the final prefix).  Marks therefore come only from
    # fail_pure; a collision-caused failure surviving to the final pass
    # flags need_host (requires a dual-homed device — two domain
    # buckets sharing an osd — which real maps don't produce).  On
    # convergence the returned pass's prefix IS final, so its lcollide
    # masks are exact.
    bad = torch.zeros((N, R, T), dtype=torch.bool, device=dev)
    cols = torch.arange(T, device=dev)[None, None, :]
    state = accept_pass(x, items, okd, bad) + [bad]

    def step(idx, st):
        fail_pure, firsts, bad_i = st[2], st[4], st[6]
        bad_i = bad_i | ((cols == firsts[:, :, None])
                         & fail_pure[:, :, None])
        return accept_pass(x[idx], items[idx], okd[idx], bad_i) + [bad_i]

    _fixpoint(state, lambda st: st[2].any(-1), step,
              numrep * T + 1 if fix > 8 else fix - 1)
    out2, placed_n, fail_pure, coll_fail, _, unfilled, _ = state
    need_host = fail_pure.any(-1) | coll_fail.any(-1)
    if not exact_budget:
        need_host = need_host | unfilled.any(-1)
    return out2, placed_n, need_host


def _choose_indep(cm, take, x, numrep, type_, recurse_to_leaf,
                  wt, T, take_type, leaf_tries=1,
                  exact_budget=False, slots=None,
                  leaf_cap=LEAF_TRIES_CAP, leaf_fix_iters=1):
    """mapper.c -> crush_choose_indep, leaf-lazy and round-vectorized.

    Phase 1 — domain candidate grid (T, numrep), one batched descent
    (r = rep + stride*ftotal applied per level inside _descend).
    Phase 2 — PROVISIONAL accept: the C round loop, one vectorized step
    per round.  Within a round, reps are processed in order and a later
    rep collides against items accepted by earlier reps of the same
    round; because collision is same-item-only, "rep accepts" reduces
    to "rep is the EARLIEST candidate-ok rep proposing its item" — an
    (R, R) masked comparison, no inner rep loop.
    Phase 3 — leaf descents ONLY for the numrep accepted candidates
    (not the whole grid): the recursion is crush_choose_indep(left=1,
    outpos=rep, tries=recurse_tries, parent_r=r) — up to ``leaf_tries``
    attempts at r2 = rep + parent_r + stride*l, first in-weight osd
    wins, no cross-position leaf dedup (mapper.py indep note).

    The provisional accept assumes every examined leaf succeeds; that
    matches C exactly unless an ACCEPTED candidate's leaf ladder
    fails entirely within min(leaf_tries, cap) attempts — C would then
    reject the domain candidate and reshuffle the slot — so exactly
    those lanes flag need_host, unless the mark-bad fixpoint below
    resolves them.

    ``exact_budget``: T equals C's own try budget, so a slot left
    UNDEF after T rounds is C's own NONE hole, not a device-budget
    artifact — no host flag for it.

    ``slots``: output positions to fill (C's ``left``); defaults to
    numrep.  They differ when the rule's numrep exceeds result_max:
    mapper.c still STRIDES r by the uncapped numrep while filling only
    ``left`` slots, so the stride base must not be capped with it.

    ``leaf_cap``: rung-level bound on modeled leaf attempts.  The
    first ladder rung models try 0 only (on an un-reweighted map the
    first leaf try always lands); a lane whose accepted candidate fails
    every MODELED try is flagged either way — a deeper rung (full L) or
    ultimately the host resolves whether C salvages it."""
    N, dev = x.shape[0], x.device
    R = numrep if slots is None else slots
    base = torch.arange(R, device=dev)[None, None, :]       # r = rep
    fs = torch.arange(T, device=dev)[None, :, None]
    # choose_args position: crush_choose_indep passes its own outpos
    # (= 0 here, one choose per take) to the domain pick, and rep to
    # the leaf recursion's bucket choose.
    items, okd0, parent_r = _descend(
        cm, _to_device(take, dev), x, base, type_,
        cm.descend_steps(take_type, type_), 0, cm.level_of(take_type),
        indep_f=fs, indep_numrep=numrep, return_last_r=True)
    items = items.to(torch.int32).expand(N, T, R)
    okd0 = okd0.expand(N, T, R)
    parent_r = parent_r.expand(N, T, R)
    if not recurse_to_leaf and type_ == 0:
        okd0 = okd0 & ~_is_out(wt, items, x)
    ar = torch.arange(R, device=dev)
    earlier = (ar[:, None] > ar[None, :])[None]  # [rep, rep']: rep' first

    def accept_scan(items, ok_grid):
        n = items.shape[0]
        out = torch.full((n, R), UNDEF, dtype=torch.int32, device=dev)
        sel_f = torch.zeros((n, R), dtype=torch.long, device=dev)
        placed = torch.zeros((n, R), dtype=torch.bool, device=dev)
        for f in range(T):
            p = items[:, f]                                   # (n, R)
            collide = (out[:, None, :] == p[:, :, None]).any(-1)
            okb = ok_grid[:, f] & ~placed & ~collide
            blocked = ((p[:, :, None] == p[:, None, :]) & earlier
                       & okb[:, None, :]).any(-1)
            acc = okb & ~blocked
            out = torch.where(acc, p, out)
            sel_f = torch.where(acc, f, sel_f)
            placed = placed | acc
        return [out, sel_f, placed]

    if not recurse_to_leaf:
        out, _, placed = accept_scan(items, okd0)
        need_host = torch.zeros(N, dtype=torch.bool, device=dev) \
            if exact_budget else (~placed).any(-1)
        return torch.where(placed, out, NONE), need_host

    L = max(1, min(leaf_tries, LEAF_TRIES_CAP, leaf_cap))
    ls = torch.arange(L, device=dev)[None, :, None]          # (1, L, 1)
    leaf_steps = cm.descend_steps(type_, 0)
    leaf_level = cm.level_of(type_)
    take_t = _to_device(take, dev, torch.int32)

    def leaf_eval(x, parent_r, out, sel_f, placed):
        # accepted candidates' parent_r; unplaced slots descend from
        # the take bucket (well-defined rows), masked out by ``placed``
        pr = _take_along(parent_r, sel_f, 1)                  # (n, R)
        start = torch.where(placed, out, take_t)
        leaves, lok = _descend(cm, start[:, None, :], x,
                               (pr + ar)[:, None, :], 0, leaf_steps,
                               ar[None, None, :], leaf_level,
                               indep_f=ls, indep_numrep=numrep)
        n = x.shape[0]
        leaves = leaves.to(torch.int32).expand(n, L, R)
        leaf_ok = lok & ~_is_out(wt, leaves, x)               # (n, L, R)
        leaf_sel = _take_along(leaves, _first_true(leaf_ok, 1), 1)
        return [leaf_sel, leaf_ok.any(1)]

    # Leaf-aware fixpoint: a leaf-failed candidate behaves in C
    # exactly like a domain-rejected one at that grid position (the
    # slot stays UNDEF and retries; nothing is placed), and the leaf
    # outcome is a pure function of (f, rep) — so marking the failed
    # position bad and re-running the accept scan reproduces C's
    # reshuffling layer by layer.  Marking is sound ONLY when the
    # modeled ladder covers C's full leaf budget (L == leaf_tries):
    # with a truncated ladder C might salvage the candidate at an
    # unmodeled try, so those programs never mark — they flag on the
    # first failure instead.  Run to convergence (fix > 8), every
    # iteration with a failing lane marks >= 1 new bad position, so
    # <= T*R iterations suffice and the converged state is exact.
    sound = L == leaf_tries
    fix = max(1, leaf_fix_iters) if sound else 1
    rows = torch.arange(T, device=dev)[None, :, None]
    scan = accept_scan(items, okd0)
    state = scan + leaf_eval(x, parent_r, *scan) + [
        torch.zeros((N, T, R), dtype=torch.bool, device=dev)]

    def step(idx, st):
        out, sel_f, placed, _, lany, bad = st
        fail = placed & ~lany
        bad = bad | ((rows == sel_f[:, None, :]) & fail[:, None, :])
        scan = accept_scan(items[idx], okd0[idx] & ~bad)
        return scan + leaf_eval(x[idx], parent_r[idx], *scan) + [bad]

    _fixpoint(state, lambda st: (st[2] & ~st[4]).any(-1), step,
              T * R + 1 if fix > 8 else fix - 1)
    out, _, placed, leaf_sel, lany, _ = state
    fail = placed & ~lany
    need_host = fail.any(-1)
    if not exact_budget:
        need_host = need_host | (~placed).any(-1)
    return torch.where(placed & lany, leaf_sel, NONE), need_host


def _chained_single(cm, takes, count, x, type_, recurse_to_leaf,
                    wt, T, firstn, from_type,
                    leaf_tries=1, leaf_cap=LEAF_TRIES_CAP,
                    leaf_fix_iters=1, exact_budget=False):
    """A SECOND choose step over the previous step's output (N, R)
    (mapper.c: per input bucket a fresh segment, outpos=0), numrep=1
    per segment — the common chained EC shape (choose N type rack ->
    chooseleaf 1 type host).

    Domain candidates for every (try, segment) pair come from one
    batched descent (segments are independent: r restarts per segment,
    numrep=1 segments cannot self-collide, and C's chained recursion
    collision scans are empty at outpos=0); per segment the first
    acceptable try wins, with leaf recursions modeled lazily for the
    accepted candidate only — the same leaf-ladder + mark-bad fixpoint
    as _choose_indep, simplified by segment independence.  firstn
    semantics: a segment that places nothing (or an invalid take
    inside the segment range) shifts downstream packing in mapper.c,
    so those lanes re-run on the host; an indep hole at the rule's own
    full budget (``exact_budget``) is C's NONE and stays on device."""
    N, dev = x.shape[0], x.device
    R = takes.shape[1]
    # firstn at numrep=1: r = rep+parent_r+ftotal = ftotal.  indep at
    # numrep=1: r = rep + stride*ftotal with the per-level uniform
    # stride (size % 1 == 0 always, so uniform levels stride by 2) —
    # applied inside _descend.
    fs = torch.arange(T, device=dev)[None, :, None]          # (1, T, 1)
    steps = cm.descend_steps(from_type, type_)
    level = cm.level_of(from_type)
    if firstn:
        items, ok, parent_r = _descend(cm, takes[:, None, :], x, fs,
                                       type_, steps, 0, level,
                                       return_last_r=True)
    else:
        items, ok, parent_r = _descend(
            cm, takes[:, None, :], x, torch.zeros_like(fs), type_,
            steps, 0, level, indep_f=fs, indep_numrep=1,
            return_last_r=True)
    items = items.to(torch.int32).expand(N, T, R)
    ok = ok.expand(N, T, R)
    parent_r = parent_r.expand(N, T, R)
    in_seg = torch.arange(R, device=dev)[None, :] < count[:, None]
    valid_take = takes < 0
    live = in_seg & valid_take
    # an invalid take inside the segment range is skipped entirely by
    # mapper.c (osize does not advance) — positions shift: host lane
    need_host = (in_seg & ~valid_take).any(-1)
    if not recurse_to_leaf:
        if type_ == 0:
            ok = ok & ~_is_out(wt, items, x)
        ok = ok & live[:, None, :]
        any_ok = ok.any(1)
        sel = _take_along(items, _first_true(ok, 1), 1)
        out = torch.where(any_ok, sel, NONE)
        # an unfilled segment may still place within C's own budget —
        # host decides — unless T already IS that budget, where a
        # firstn miss still shifts packing (host) but an indep hole
        # is C's own NONE
        if firstn or not exact_budget:
            need_host = need_host | (live & ~any_ok).any(-1)
        return out, need_host

    # chooseleaf: leaf ladders ONLY for each segment's accepted
    # candidate, modeling C's recursion exactly — firstn: numrep=1
    # stable recursion, r' = sub_r + l with sub_r = r (vary_r=1), no
    # uniform stride; indep: r' = parent_r + stride*l via the
    # per-level indep stride at numrep=1.  Same provisional-accept +
    # mark-bad fixpoint as _choose_indep, per segment.
    ok_dom = ok & live[:, None, :]
    L = max(1, min(leaf_tries, LEAF_TRIES_CAP, leaf_cap))
    sound = L == leaf_tries
    fix = max(1, leaf_fix_iters) if sound else 1
    ls = torch.arange(L, device=dev)[None, :, None]          # (1, L, 1)
    leaf_steps = cm.descend_steps(type_, 0)
    leaf_level = cm.level_of(type_)
    rows = torch.arange(T, device=dev)[None, :, None]

    def accept_leaf(x, items, parent_r, okb):
        first = _first_true(okb, 1)
        any_ok = okb.any(1)
        sel_item = _take_along(items, first, 1)
        sel_r = _take_along(parent_r, first, 1)
        start = torch.where(any_ok, sel_item, -1)[:, None, :]
        if firstn:
            leaves, lok = _descend(cm, start, x, sel_r[:, None, :] + ls,
                                   0, leaf_steps, 0, leaf_level)
        else:
            leaves, lok = _descend(cm, start, x, sel_r[:, None, :], 0,
                                   leaf_steps, 0, leaf_level, indep_f=ls,
                                   indep_numrep=1)
        n = x.shape[0]
        leaves = leaves.to(torch.int32).expand(n, L, R)
        leaf_ok = lok & ~_is_out(wt, leaves, x)               # (n, L, R)
        leaf_sel = _take_along(leaves, _first_true(leaf_ok, 1), 1)
        return [first, any_ok, leaf_sel, leaf_ok.any(1)]

    bad = torch.zeros((N, T, R), dtype=torch.bool, device=dev)
    state = accept_leaf(x, items, parent_r, ok_dom) + [bad]

    def step(idx, st):
        first, any_ok, _, lany, bad = st
        fail = any_ok & ~lany
        bad = bad | ((rows == first[:, None, :]) & fail[:, None, :])
        return accept_leaf(x[idx], items[idx], parent_r[idx],
                           ok_dom[idx] & ~bad) + [bad]

    _fixpoint(state, lambda st: (st[1] & ~st[3]).any(-1), step,
              T + 1 if fix > 8 else fix - 1)
    _, any_ok, leaf_sel, lany, _ = state
    out = torch.where(any_ok & lany, leaf_sel, NONE)
    need_host = need_host | (any_ok & ~lany).any(-1)
    if firstn or not exact_budget:
        need_host = need_host | (live & ~any_ok).any(-1)
    return out, need_host


def compile_rule(cm: CompiledCrushMap, ruleno: int, result_max: int,
                 bulk_tries: int = DEFAULT_BULK_TRIES,
                 leaf_cap: int = LEAF_TRIES_CAP,
                 leaf_fix_iters: int = 1):
    """Build fn(xs (N,) int64, weight_vec (D,) int64) -> (results
    (N, result_max) int32, count (N,), need_host (N,)), checking the rule
    against the evaluator's gates first.  Both inputs are tensors on the
    map's device; ``all_in=`` (whether every reweight is >= 0x10000)
    spares fn a host sync to find out."""
    rule = cm.cmap.rules[ruleno]
    tunables = cm.cmap.tunables
    if (tunables.choose_local_tries or tunables.choose_local_fallback_tries
            or tunables.chooseleaf_vary_r != 1
            or tunables.chooseleaf_stable != 1
            or not tunables.chooseleaf_descend_once):
        # the bulk program hardcodes jewel chooseleaf semantics
        # (sub_r = r, recursion rep 0, one leaf try); older profiles run
        # on the host mapper.  The vary_r/stable checks are EXACT-value,
        # not truthiness: vary_r >= 2 is a legal upstream transitional
        # value whose host semantics are sub_r = r >> (vary_r - 1) —
        # a map carrying it would pass a falsy-only guard and silently
        # diverge from the host mapper with no need_host flag; the same
        # reasoning gates chooseleaf_stable > 1.
        raise ValueError("bulk evaluator requires jewel tunables "
                         "(choose_local_* == 0, chooseleaf_vary_r/"
                         "stable/descend_once == 1); use engine=host")
    if cm.type_level is None:
        # an irregular hierarchy can land a descent on a wrong-type item,
        # which mapper.c treats as terminal for the replica — semantics
        # the retryable candidate grid does not reproduce
        raise ValueError("bulk evaluator requires a regular hierarchy "
                         "(uniform level per bucket type, no empty "
                         "buckets); use engine=host")
    # clamp against the rule's own maximum budget (SET_CHOOSE_TRIES
    # raises it above the tunables default — the canonical EC rule
    # carries 100), so a deep rung CAN reach exact_budget there
    T = min(bulk_tries, _rule_tries_cap(cm.cmap, ruleno))
    # the gates raise here, before any lane runs, as the reference's
    # trace does
    plan = _plan(cm, list(rule.steps), result_max, T, leaf_cap,
                 leaf_fix_iters)

    def fn(xs, weight_vec, all_in: Optional[bool] = None):
        wt = _Weights.of(weight_vec, all_in)
        x = as_hash_input(xs)
        N, dev = x.shape[0], x.device
        results = []
        need_host = torch.zeros(N, dtype=torch.bool, device=dev)
        current = None
        for kind, kw in plan:
            if kind == "emit":
                if current is not None:
                    results.append(current)
                    current = None
            elif kind == "take":
                current = None
            elif kind == "chained":
                vals, nh = _chained_single(cm, current[0], current[1], x,
                                           wt=wt, **kw)
                need_host = need_host | nh
                current = (vals, current[1])
            elif kind == "firstn":
                vals, count, nh = _choose_firstn(cm, x=x, wt=wt, **kw)
                need_host = need_host | nh
                current = (vals, count)
            else:
                vals, nh = _choose_indep(cm, x=x, wt=wt, **kw)
                need_host = need_host | nh
                current = (vals, torch.full((N,), vals.shape[1],
                                            dtype=torch.long, device=dev))
        out = torch.full((N, result_max), NONE, dtype=torch.int32,
                         device=dev)
        pos = torch.zeros(N, dtype=torch.long, device=dev)
        idx = torch.arange(result_max, device=dev)[None, :]
        for vals, count in results:
            n = vals.shape[1]
            m = min(n, result_max)
            src = torch.full((N, result_max), NONE, dtype=torch.int32,
                             device=dev)
            src[:, :m] = vals[:, :m]
            shifted = torch.gather(
                src, 1, (idx - pos[:, None]).clamp(0, result_max - 1))
            write = (idx >= pos[:, None]) & \
                (idx < (pos + count.clamp(max=n))[:, None])
            out = torch.where(write, shifted, out)
            pos = (pos + count).clamp(max=result_max)
        return out, pos, need_host

    return fn


def _plan(cm, steps, result_max: int, T: int, leaf_cap: int,
          leaf_fix_iters: int):
    """The rule's steps as (kind, keyword arguments) of the choose
    functions, raising the evaluator's gates.  SET_* rule overrides (the
    canonical EC rule carries set_chooseleaf_tries 5 + set_choose_tries
    100) are folded in: choose_tries caps the per-step device budget (a
    SET below T must not let the device succeed where C's budget ran
    out); choose_leaf_tries feeds the per-candidate leaf-retry ladders
    (capped at the rung's leaf_cap; a candidate exhausting the modeled
    ladder is marked bad / flagged per the fixpoint soundness rule)."""
    plan = []
    take = None
    chained_from = None   # bucket type the last choose produced
    choose_tries_run = cm.cmap.tunables.choose_total_tries + 1
    leaf_tries_run = 0    # 0 = descend_once default (one try)
    for op, arg1, arg2 in steps:
        T_step = max(1, min(T, choose_tries_run))
        leaf = dict(leaf_tries=leaf_tries_run if leaf_tries_run else 1,
                    leaf_cap=leaf_cap, leaf_fix_iters=leaf_fix_iters,
                    exact_budget=T_step >= choose_tries_run)
        if op == CRUSH_RULE_TAKE:
            take = arg1
            chained_from = None
            plan.append(("take", None))
        elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries_run = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                leaf_tries_run = arg1
        elif op in (CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
            if arg1 > 0:
                raise ValueError(
                    "bulk evaluator does not fuse local-retry "
                    "ladders (set_choose_local_* > 0); use "
                    "engine=host")
        elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0 and arg1 != 1:
                raise ValueError(
                    "bulk evaluator hardcodes chooseleaf_vary_r=1; "
                    "use engine=host")
        elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0 and arg1 != 1:
                raise ValueError(
                    "bulk evaluator hardcodes chooseleaf_stable=1; "
                    "use engine=host")
        elif op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP):
            firstn = op in (CRUSH_RULE_CHOOSE_FIRSTN,
                            CRUSH_RULE_CHOOSELEAF_FIRSTN)
            recurse = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                             CRUSH_RULE_CHOOSELEAF_INDEP)
            if chained_from is not None:
                if arg1 != 1:
                    raise ValueError(
                        "bulk evaluator supports chained choose "
                        "steps only with n=1 (the chooseleaf-per-"
                        "domain EC shape); use engine=host")
                plan.append(("chained", dict(
                    type_=arg2, recurse_to_leaf=recurse, T=T_step,
                    firstn=firstn, from_type=chained_from, **leaf)))
                chained_from = arg2
                continue
            numrep = arg1 if arg1 > 0 else arg1 + result_max
            take_type = (cm.cmap.buckets[take].type
                         if take in cm.cmap.buckets else None)
            kw = dict(take=take, type_=arg2, recurse_to_leaf=recurse,
                      T=T_step, take_type=take_type, **leaf)
            if firstn:
                # C: count = out_size cap
                plan.append(("firstn", dict(
                    numrep=min(numrep, result_max), **kw)))
            else:
                # C: got = min(numrep, seg)
                plan.append(("indep", dict(
                    numrep=numrep, slots=min(numrep, result_max), **kw)))
            chained_from = arg2
        elif op == CRUSH_RULE_EMIT:
            plan.append(("emit", None))
            chained_from = None
        else:
            raise ValueError(
                f"bulk evaluator does not support rule op {op}")
    return plan


def _get_fn(cm: CompiledCrushMap, ruleno: int, result_max: int,
            bulk_tries: int, leaf_cap: int = LEAF_TRIES_CAP,
            leaf_fix_iters: int = 1):
    key = (ruleno, result_max, bulk_tries, leaf_cap, leaf_fix_iters)
    fn = cm._fn_cache.get(key)
    if fn is None:
        fn = cm._fn_cache[key] = compile_rule(
            cm, ruleno, result_max, bulk_tries, leaf_cap, leaf_fix_iters)
    return fn


def _rule_tries_cap(cmap, ruleno: int) -> int:
    """The largest try budget the rule can ever use in C — device
    rungs above it are pure waste (compile_rule clamps T to it)."""
    cap = cmap.tunables.choose_total_tries + 1
    for op, arg1, _ in cmap.rules[ruleno].steps:
        if op == CRUSH_RULE_SET_CHOOSE_TRIES and arg1 > 0:
            cap = max(cap, arg1)
    return cap


def auto_ladder(cmap, ruleno: int, result_max: int,
                bulk_tries: int) -> List[Tuple[int, int, int]]:
    """Device (try-budget, leaf-try-cap, leaf-fix-iters) rungs.

    Narrow rules keep the classic cheap first rung (2 tries covers the
    no-collision common case).  Wide-indep rules (the canonical EC
    shape) have collision-heavy retries as the COMMON case — a 2-try
    rung redoes ~70% of lanes, pure waste — so their first rung starts
    at width+2.  The first rung also models only leaf try 0 (leaf_cap
    1): on an un-reweighted map the first leaf attempt always lands,
    so the deeper attempts are computed only for the lanes that
    actually flagged.  A final 2x rung re-dispatches the measured
    residue before any lane reaches the serial host path.  Every rung
    is clamped to the rule's own C budget (results are identical at
    any budget; rungs only move where lanes are computed)."""
    width = rule_width(cmap, ruleno, result_max)
    cap = _rule_tries_cap(cmap, ruleno)
    first = FIRST_PASS_TRIES if width <= 4 else width + 2
    # (leaf_cap, fix_iters) shape the leaf-lazy chooseleaf programs —
    # firstn, indep, and both chained forms; for rules with NO
    # chooseleaf step they are normalized to (CAP, 1), and rungs
    # differing only in them are dropped below
    leaf_lazy = any(op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                           CRUSH_RULE_CHOOSELEAF_INDEP)
                    for op, _, _ in cmap.rules[ruleno].steps)
    if leaf_lazy:
        cands = ((first, 1, 1),
                 (first, LEAF_TRIES_CAP, 2),
                 (bulk_tries, LEAF_TRIES_CAP, 4),
                 (2 * bulk_tries, LEAF_TRIES_CAP, 8),
                 # the final rung runs at the rule's FULL C budget
                 # (clamped to 128 scan rounds) with the CONVERGENT
                 # fixpoint (fix>8), so a slot still unfilled there is
                 # C's own NONE hole (exact_budget) and leaf reshuffling
                 # resolves on device; only a truncated leaf ladder
                 # (leaf_tries > LEAF_TRIES_CAP rules) still falls back
                 (min(cap, 128), LEAF_TRIES_CAP, 16))
    else:
        cands = ((first, LEAF_TRIES_CAP, 1),
                 (bulk_tries, LEAF_TRIES_CAP, 1),
                 (2 * bulk_tries, LEAF_TRIES_CAP, 1),
                 (min(cap, 128), LEAF_TRIES_CAP, 1))
    rungs: List[Tuple[int, int, int]] = []
    for t, lcap, fix in cands:
        t = max(1, min(t, cap))
        if rungs:
            # budgets must be non-decreasing (an explicit small
            # bulk_tries must not demote a later rung below its
            # predecessor — it would re-flag the same lanes)
            t = max(t, rungs[-1][0])
        if not rungs or t > rungs[-1][0] or lcap > rungs[-1][1] \
                or fix > rungs[-1][2]:
            rungs.append((t, lcap, fix))
    return rungs


def rule_width(cmap, ruleno: int, result_max: int) -> int:
    """Widest resolved numrep among the rule's choose steps."""
    width = 1
    for op, arg1, _ in cmap.rules[ruleno].steps:
        if op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                  CRUSH_RULE_CHOOSELEAF_FIRSTN,
                  CRUSH_RULE_CHOOSELEAF_INDEP):
            n = arg1 if arg1 > 0 else arg1 + result_max
            width = max(width, min(n, result_max))
    return width


def auto_tries(cmap, ruleno: int, result_max: int) -> int:
    """Default device try budget scaled to the rule's widest choose:
    a wide indep step (the 6-wide canonical EC rule) needs more
    collision-retry rounds than the 3-replica default — at 8 tries a
    6-of-8-host sweep left 4.6% of lanes to the (serial) host
    fallback; 2n+4 tries cut it to ~0.1%.  Results are identical at any
    budget (the ladder invariant); only where lanes are computed
    changes."""
    tries = DEFAULT_BULK_TRIES
    n = rule_width(cmap, ruleno, result_max)
    if n > 4:
        tries = max(tries, 2 * n + 4)
    return tries


def block_lanes(cm: CompiledCrushMap, ruleno: int, result_max: int,
                tries: int) -> int:
    """Lanes per block: as many as keep the widest grid — tries x the
    rule's width x the widest bucket, a straw2 draw for every slot of
    every candidate — under ``BLOCK_BYTES`` at ``BYTES_PER_ELEMENT``
    live bytes an element, between 1024 and ``MAX_BLOCK``.  Block size
    moves only where lanes are computed, never the results."""
    T = min(tries, _rule_tries_cap(cm.cmap, ruleno))
    per_lane = max(1, T * rule_width(cm.cmap, ruleno, result_max)
                   * cm.max_size) * BYTES_PER_ELEMENT
    return max(1 << 10, min(MAX_BLOCK, BLOCK_BYTES // per_lane))


def _member_map(cm: "CompiledCrushMap", device: torch.device
                ) -> "CompiledCrushMap":
    """The compiled map with its tables on ``device``: ``cm`` itself on
    its own device, else a copy built once per device and kept on
    ``cm``."""
    if device == cm.device:
        return cm
    copies = cm.__dict__.setdefault("_member_maps", {})
    if device not in copies:
        copies[device] = CompiledCrushMap(cm.cmap, cm.choose_args,
                                          device=device)
    return copies[device]


def first_rung_cost(cm: "CompiledCrushMap", ruleno: int, result_max: int,
                    tries: int, lanes: int) -> Dict[str, float]:
    """The analytic cost of ``lanes`` x through the first rung
    (telemetry/profiler.py::analytic_crush_cost): on the eager tier
    ``tries`` x ``result_max`` straw2 draws a lane over the take bucket
    level's width; on the rule kernel one try a replica, a draw for
    every slot of each level it descends (the draws these inputs need
    when nothing collides)."""
    from ..telemetry.profiler import analytic_crush_cost
    take = next(a1 for op, a1, _ in cm.cmap.rules[ruleno].steps
                if op == CRUSH_RULE_TAKE)
    top = cm.level_of(cm.cmap.buckets[take].type)
    kernel = _rule_kernel(cm, ruleno, result_max)
    if kernel is None:
        return analytic_crush_cost(lanes, tries, result_max,
                                   cm.width_at(top), result_max)
    bottom = 0 if kernel.recurse else cm.level_of(kernel.type)
    width = (cm.max_size * cm.max_depth if top is None or bottom is None
             else sum(cm.width_at(lv) for lv in range(bottom + 1, top + 1)))
    return analytic_crush_cost(lanes, 1, kernel.slots, width, result_max)


def _rule_kernel(cm: CompiledCrushMap, ruleno: int, result_max: int
                 ) -> Optional[crush_kernels.KernelRule]:
    """The CUDA rule kernel's form of the rule for the first rung: a
    map on the card whose map and rule are in the kernel's scope
    (ops/crush_kernels.py::kernel_rule), else None (the eager tier)."""
    if cm.device.type != "cuda":
        return None
    return crush_kernels.kernel_rule(cm, ruleno, result_max)


def bulk_do_rule(cmap, ruleno: int, xs, result_max: int,
                 weight: Optional[Sequence[int]] = None,
                 bulk_tries: Optional[int] = None,
                 return_stats: bool = False,
                 choose_args: Optional[Dict[int, "ChooseArg"]] = None,
                 device=None, mesh=None):
    """Evaluate a rule for many inputs at once on the device; identical
    to the host mapper.

    ``cmap``: a CrushMap, or a CompiledCrushMap (then its device; a
    ``device`` that differs raises).  ``device``: the card by default,
    ``"cpu"`` on the CPU; without a card the default raises
    NoDeviceError.

    Adaptive ladder (``auto_ladder``): a cheap first rung handles the
    lanes that place without retries; lanes that exhausted it re-run on
    deeper rungs; the residue re-runs on the exact host reference.  A
    lane that completes within a budget is identical at any larger
    budget, so the ladder never changes results — only where they are
    computed.

    ``mesh``: shard the x axis over a data plane's members — a
    DataPlane or Mesh, or None to follow the active data plane
    (parallel/plane.py; single-device when none is active, or when its
    members are not of the map's device kind).  Blocks round up to the
    member count and a short batch pads by repetition (lane results are
    x-pure, so pad lanes are dropped); each member evaluates its shard
    with the map's tables on its own device.  Same rung ladder, same
    host residue, identical results: the mesh only moves where lanes
    are computed.

    Returns (results (N, result_max) int32 numpy with CRUSH_ITEM_NONE
    holes, counts (N,)); with return_stats also the host-fallback lane
    count."""
    if isinstance(cmap, CompiledCrushMap):
        cm = cmap
        if choose_args is not None and cm.choose_args is not choose_args:
            raise ValueError(
                "choose_args differ from the ones this CompiledCrushMap "
                "was built with; rebuild CompiledCrushMap(cmap, "
                "choose_args)")
        if device is not None and resolve_device(device) != cm.device:
            raise ValueError(
                f"device {device} differs from the CompiledCrushMap's "
                f"{cm.device}")
        choose_args = cm.choose_args
    else:
        cm = CompiledCrushMap(cmap, choose_args, device=device)
    dev = cm.device
    if weight is None:
        weight = cm.cmap.device_weights()
    w_np = np.asarray(weight, dtype=np.int64).reshape(-1)
    wv = _to_device(w_np, dev)
    all_in = bool((w_np >= 0x10000).all())
    xs = np.asarray(xs, dtype=np.int64).reshape(-1)
    if bulk_tries is None:
        bulk_tries = auto_tries(cm.cmap, ruleno, result_max)

    rungs = auto_ladder(cm.cmap, ruleno, result_max, bulk_tries)
    perf = global_perf()
    n = len(xs)
    xs_d = _to_device(xs, dev)
    out = torch.full((n, result_max), NONE, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n, dtype=torch.long, device=dev)
    need = torch.zeros(n, dtype=torch.bool, device=dev)
    block = block_lanes(cm, ruleno, result_max, rungs[0][0])
    from ..parallel.plane import plane_for
    plane = plane_for(mesh, dev)
    nd = plane.n_devices if plane is not None else 1
    if nd > 1:
        block = -(-block // nd) * nd        # member-divisible blocks
        from ..telemetry import metrics as tel
        tel.counter("engine_mesh_dispatches", tier="crush-bulk",
                    devices=str(nd))
    member_wv = {dev: wv}
    # the CUDA rule kernel takes the first rung where the map and the
    # rule are in its scope (ops/crush_kernels.py), at the rule's own
    # budgets; the eager tier keeps the deeper rungs and the CPU
    kernel = _rule_kernel(cm, ruleno, result_max)

    def rung(tries, lcap, fix, first=False):
        """The rung's evaluator over x lanes on the map's device: the
        rule kernel (the first rung, in its scope) or the compiled rule,
        sharded over the plane's members when one is active (each
        member's tables and weights on its own device)."""
        def local(xb: torch.Tensor):
            cm_d = _member_map(cm, xb.device)
            if xb.device not in member_wv:
                member_wv[xb.device] = wv.to(xb.device)
            if first and kernel is not None:
                return crush_kernels.crush_rule_cuda(
                    cm_d.kernel_tables(), kernel, xb, member_wv[xb.device])
            return _get_fn(cm_d, ruleno, result_max, tries, lcap, fix)(
                xb, member_wv[xb.device], all_in)
        if plane is None:
            return local

        def sharded(xb: torch.Tensor):
            from ..utils.shard import shard_batch
            m = xb.shape[0]
            pad = (-m) % nd
            if pad:
                xb = torch.cat([xb, xb[:1].repeat(pad)])
            o, c, nh = shard_batch(local, plane, (xb,), n_out=3)
            return o[:m], c[:m], nh[:m]
        return sharded

    fn = rung(*rungs[0], first=True)
    kernel_lanes = [0]

    # the supervised dispatch seam (ops/supervisor.py): the first rung's
    # block dispatch classifies transient / out-of-memory / backend-loss
    # failures; the host twin is the exact host mapper the residue
    # ladder already falls back to, so a demoted completion is
    # bit-identical by the same invariant (its lanes answer
    # need_host=False, so they never re-enter the device rungs)
    def dev_block(xb: torch.Tensor):
        res = fn(xb)
        if kernel is not None:
            kernel_lanes[0] += xb.shape[0]
        return res

    def host_block(xb: torch.Tensor):
        xs_h = _to_host(xb)
        o_h = np.empty((len(xs_h), result_max), np.int32)
        c_h = np.empty(len(xs_h), np.int64)
        for j, x in enumerate(xs_h):
            r = crush_do_rule(cm.cmap, ruleno, int(x), result_max,
                              weight=list(weight), choose_args=choose_args)
            o_h[j] = r + [NONE] * (result_max - len(r))
            c_h[j] = len(r)
        return (_to_device(o_h, dev), _to_device(c_h, dev),
                torch.zeros(len(xs_h), dtype=torch.bool, device=dev))

    sup = global_supervisor()
    # the program profiler (telemetry/profiler.py): the first rung's
    # block is one program, keyed like the reference's plus the map
    # size, captured at its first block with the straw2 draw model and
    # every block timed into its histogram (CUDA events on the card)
    from ..telemetry import metrics as tel
    profiled = tel.enabled()
    if profiled:
        from ..telemetry.profiler import global_profiler
        prof = global_profiler()
        prof_key = ("crush.bulk_rule", ruleno, result_max, rungs[0],
                    block, nd, len(w_np))
        prof.capture(prof_key, name="crush.bulk_rule", platform=dev.type,
                     cost=first_rung_cost(cm, ruleno, result_max,
                                          rungs[0][0], block),
                     arg_bytes=block * 8, plugin="crush",
                     kind="bulk-rule", batch=block,
                     pattern=f"rule{ruleno}x{result_max}",
                     engine="mesh" if nd > 1 else "device", devices=nd)
    with spans.child("crush.rung", tries=rungs[0][0], lanes=n):
        for s in range(0, n, block):
            e = min(s + block, n)
            # verifiable=False: the device block legitimately differs
            # from the host twin (need-host flags feed the residue
            # ladder)
            if not profiled:
                out[s:e], cnt[s:e], need[s:e] = sup.dispatch(
                    "crush.bulk_rule", dev_block, (xs_d[s:e],),
                    host_fn=host_block, verifiable=False)
            else:
                with prof.timed(prof_key, device=dev):
                    out[s:e], cnt[s:e], need[s:e] = sup.dispatch(
                        "crush.bulk_rule", dev_block, (xs_d[s:e],),
                        host_fn=host_block, verifiable=False)
            perf.inc("crush_bulk_blocks")
        redo = flagged = _nonzero(need)
        if kernel_lanes[0]:
            # the lanes the rule kernel placed, and those it flagged
            spans.note("kernel_lanes", kernel_lanes[0] - flagged.numel())
            spans.note("kernel_flagged", flagged.numel())

    # residue-adaptive rungs: each deeper budget re-runs ONLY the lanes
    # the previous rung flagged, so serial host work is bounded by the
    # residue of the deepest rung
    for tries, lcap, fix in rungs[1:]:
        if not redo.numel():
            break
        with spans.child("crush.rung", tries=tries, lanes=redo.numel()):
            fn2 = rung(tries, lcap, fix)
            rblock = block_lanes(cm, ruleno, result_max, tries)
            host_lanes = []
            for s in range(0, redo.numel(), rblock):
                idx = redo[s:s + rblock]
                out[idx], cnt[idx], nh = fn2(xs_d[idx])
                host_lanes.append(idx[_nonzero(nh)])
                perf.inc("crush_bulk_blocks")
            redo = torch.cat(host_lanes)

    out_np = _to_host(out)
    cnt_np = _to_host(cnt.to(torch.int32))
    redo_np = _to_host(redo)
    n_fallback = int(redo_np.size)
    # for checks: the lanes the first rung flagged, and the host residue
    cm.last_flagged = _to_host(flagged)
    cm.last_residue = redo_np
    perf.inc("crush_bulk_host_lanes", n_fallback)
    with spans.child("crush.host_residue"):
        spans.note("residue_lanes", n_fallback)
        for i in redo_np:
            r = crush_do_rule(cm.cmap, ruleno, int(xs[i]), result_max,
                              weight=list(weight), choose_args=choose_args)
            out_np[i] = r + [NONE] * (result_max - len(r))
            cnt_np[i] = len(r)
    from ..utils.debug import DeviceVerificationError, verification_enabled
    if verification_enabled():
        # sanitizer mode: every lane re-evaluated on the host oracle
        for i in range(len(xs)):
            r = crush_do_rule(cm.cmap, ruleno, int(xs[i]), result_max,
                              weight=list(weight),
                              choose_args=choose_args)
            r = r + [NONE] * (result_max - len(r))
            if list(out_np[i]) != r:
                raise DeviceVerificationError(
                    f"bulk evaluator diverged from host mapper at "
                    f"x={int(xs[i])}: {list(out_np[i])} != {r}")
    if return_stats:
        return out_np, cnt_np, n_fallback
    return out_np, cnt_np
