"""CRUSH placement on the card: the rule kernel's scope, its wrapper and
its plain version.

The CUDA source is ``csrc/crush_rule.cu``: ``crush_do_rule`` for one
take, one choose step (``choose_indep`` / ``chooseleaf_indep`` /
``choose_firstn`` / ``chooseleaf_firstn``) and an emit, one warp per
input x, in mapper.c's order of tries (its note says how).  It serves the
first rung of the bulk evaluator (``crush/bulk.py::bulk_do_rule``) on a
CUDA map whose rule is in scope:

- :func:`kernel_rule` — the scope, decided from the compiled map and the
  rule before any dispatch: every bucket below the take straw2, of a type
  above 0, under 2^15 slots, its weights (and choose_args weight sets) in
  [0, 2^32), every bucket id an item names a bucket, at most
  ``MAX_DEPTH`` levels; one take of a bucket, one choose step, an emit;
  jewel tunables (and no rule step that changes them); ``result_max`` at
  most 32.  It returns the :class:`KernelRule` (the rule's own try
  budgets) or None; None keeps the eager tier.
- :func:`crush_rule_cuda` — the wrapper: ``(out (N, result_max) int32,
  count (N,) int64, need_host (N,) bool)`` in the form of the eager
  tier's rule function, over :class:`KernelTables` (the map's tables,
  flattened once by ``CompiledCrushMap.kernel_tables``).  ``need_host``
  marks a lane whose descent passed ``MAX_DEPTH`` picks, which the scope
  leaves to a map with a cycle.  On a CUDA tensor it launches the kernel
  or raises; on a CPU tensor it answers with the host mapper, a lane at
  a time (``bulk_do_rule`` on the CPU runs the eager tier, so only the
  tests take that branch; the kernel's equality to the mapper is held on
  the card).

The wrapper counts its launches in ``.launches``, read with every other
kernel wrapper's through ``ops/launches.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from ._build import load
from .launches import device_and_stream, register
from ..crush.mapper import crush_do_rule
from ..crush.types import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
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
    ChooseArg,
    CrushMap,
)
from ..utils.errors import KernelLaunchError

# the kernel's caps (csrc/crush_rule.cu, checked when the library loads)
MAX_RESULT = 32       # result_max: one slot of out / out2 a thread
MAX_DEPTH = 16        # bucket picks in one descent
MAX_SLOTS = 1 << 15   # bucket size: the slot index in a straw2 key

_CHOOSE = (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
           CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)
_NONE = CRUSH_ITEM_NONE


class KernelRule(NamedTuple):
    """One rule as the kernel runs it (csrc/crush_rule.cu's Rule), and
    its id in the map."""
    ruleno: int
    take_row: int
    numrep: int       # the step's numrep (result_max added when <= 0)
    slots: int        # indep: min(numrep, result_max); firstn: result_max
    type: int
    recurse: bool     # chooseleaf
    firstn: bool
    tries: int        # choose_total_tries + 1, or set_choose_tries
    leaf_tries: int   # set_chooseleaf_tries, or 1
    max_devices: int
    result_max: int


class KernelTables(NamedTuple):
    """A map's tables as the kernel reads them: ``tab`` one int32 tensor
    of, in order, ``rows`` x (first slot, size, type), ``max_neg + 1``
    rows of bucket ids (id ``-1 - i`` at ``i``), ``items`` item ids,
    ``items`` hash ids and ``positions`` x ``items`` weights (uint32
    bits); ``negln`` the map's 2^48 - crush_ln(u) table (65536 int64);
    ``cmap`` and ``choose_args`` the host map they were flattened from
    (the CPU branch's mapper reads them)."""
    tab: torch.Tensor
    negln: torch.Tensor
    rows: int
    max_neg: int
    items: int
    positions: int
    cmap: CrushMap
    choose_args: Optional[Dict[int, ChooseArg]]

    def sections(self) -> Dict[str, torch.Tensor]:
        """The sections of ``tab`` as views: ``hdr`` (rows, 3),
        ``id_row``, ``items``, ``ids`` and ``weights`` (positions,
        items, int32 bits)."""
        t, r, f = self.tab, self.rows, self.items
        a = 3 * r
        b = a + self.max_neg + 1
        return {"hdr": t[:a].view(r, 3), "id_row": t[a:b],
                "items": t[b:b + f], "ids": t[b + f:b + 2 * f],
                "weights": t[b + 2 * f:].view(self.positions, f)}


def _tree_ok(cmap, take: int, choose_args) -> bool:
    """Whether every bucket below ``take`` is one the kernel reads:
    straw2, of a type above 0, under MAX_SLOTS slots, its weights and
    weight sets in [0, 2^32), every negative item a bucket, at most
    MAX_DEPTH levels (a cycle fails the depth)."""
    depth: Dict[int, int] = {}

    def ok(w) -> bool:
        return all(0 <= int(v) < 1 << 32 for v in w)

    def level(bid: int, seen: int) -> int:
        if bid not in cmap.buckets or seen > MAX_DEPTH:
            return MAX_DEPTH + 1
        if bid in depth:
            return depth[bid]
        b = cmap.buckets[bid]
        arg = choose_args.get(bid) if choose_args else None
        if (b.alg != CRUSH_BUCKET_STRAW2 or b.type <= 0
                or b.size >= MAX_SLOTS or not ok(b.item_weights)
                or (arg is not None and not all(
                    ok(ws) for ws in (arg.weight_set or ())))):
            return MAX_DEPTH + 1
        d = 1 + max([level(i, seen + 1) for i in b.items if i < 0] + [0])
        depth[bid] = d
        return d

    return level(take, 1) <= MAX_DEPTH


def kernel_rule(cm, ruleno: int, result_max: int) -> Optional[KernelRule]:
    """The rule ``ruleno`` at ``result_max`` as the kernel runs it on the
    compiled map ``cm`` (a ``CompiledCrushMap``), or None where the map
    or the rule is outside the kernel's scope (the module docstring).
    Read from the map and the rule alone, once per (rule, result_max)."""
    key = ("kernel", ruleno, result_max)
    if key not in cm._fn_cache:
        cm._fn_cache[key] = _kernel_rule(cm, ruleno, result_max)
    return cm._fn_cache[key]


def _kernel_rule(cm, ruleno: int, result_max: int) -> Optional[KernelRule]:
    cmap = cm.cmap
    t = cmap.tunables
    rule = cmap.rules.get(ruleno)
    if (rule is None or not 1 <= result_max <= MAX_RESULT
            or t.choose_local_tries or t.choose_local_fallback_tries
            or t.chooseleaf_vary_r != 1 or t.chooseleaf_stable != 1
            or not t.chooseleaf_descend_once):
        return None
    tries = t.choose_total_tries + 1
    leaf_tries = 0
    take = choose = None
    emitted = False
    for op, arg1, arg2 in rule.steps:
        if op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0 and choose is None:
                tries = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0 and choose is None:
                leaf_tries = arg1
        elif op in (CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
            if arg1 > 0:
                return None
        elif op in (CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                    CRUSH_RULE_SET_CHOOSELEAF_STABLE):
            if arg1 >= 0 and arg1 != 1:
                return None
        elif op == CRUSH_RULE_NOOP:
            continue
        elif op == CRUSH_RULE_TAKE and take is None:
            take = arg1
        elif op in _CHOOSE and take is not None and choose is None:
            choose = (op, arg1, arg2)
        elif op == CRUSH_RULE_EMIT and choose is not None and not emitted:
            emitted = True
        else:
            return None
    if not emitted or take not in cmap.buckets \
            or not _tree_ok(cmap, take, cm.choose_args):
        return None
    op, arg1, type_ = choose
    numrep = arg1 if arg1 > 0 else arg1 + result_max
    if numrep <= 0 or tries < 1:
        return None
    firstn = op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
    return KernelRule(
        ruleno=ruleno, take_row=cm.row_of_id[take], numrep=numrep,
        slots=result_max if firstn else min(numrep, result_max),
        type=type_,
        recurse=op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                       CRUSH_RULE_CHOOSELEAF_INDEP),
        firstn=firstn, tries=tries, leaf_tries=leaf_tries or 1,
        max_devices=cmap.max_devices, result_max=result_max)


_lib_state = None


def _lib():
    global _lib_state
    if _lib_state is None:
        lib = load("crush_rule")
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.crush_rule_launch.argtypes = [vp, i, i, i, i, vp, vp, vp, ll,
                                          vp, i, vp, vp, vp, i, vp]
        lib.crush_rule_launch.restype = i
        lib.crush_rule_error_string.argtypes = [i]
        lib.crush_rule_error_string.restype = ctypes.c_char_p
        caps = (lib.crush_rule_max_result(), lib.crush_rule_max_depth())
        if caps != (MAX_RESULT, MAX_DEPTH):
            raise KernelLaunchError(
                f"the CRUSH rule kernel's caps (result_max, depth) are "
                f"{caps}; the wrapper plans for {(MAX_RESULT, MAX_DEPTH)}")
        _lib_state = lib
    return _lib_state


def _rule_args(rule: KernelRule) -> list:
    return [rule.take_row, rule.numrep, rule.slots, rule.type,
            int(rule.recurse), int(rule.firstn), rule.tries,
            rule.leaf_tries, rule.max_devices, rule.result_max]


def _check(tables: KernelTables, rule: KernelRule, xs: torch.Tensor,
           weight: torch.Tensor) -> None:
    if xs.dim() != 1 or xs.dtype != torch.int64 \
            or weight.dim() != 1 or weight.dtype != torch.int64:
        raise ValueError(f"need (N,) int64 x and (D,) int64 weights, got "
                         f"{tuple(xs.shape)} {xs.dtype} and "
                         f"{tuple(weight.shape)} {weight.dtype}")
    if not 1 <= rule.slots <= rule.result_max <= MAX_RESULT:
        raise ValueError(f"rule outside the kernel's scope: {rule}")
    for t in (tables.tab, tables.negln, weight):
        if t.device != xs.device:
            raise ValueError(f"tables, weights and x on one device, got "
                             f"{t.device} and {xs.device}")


def crush_rule_cuda(tables: KernelTables, rule: KernelRule,
                    xs: torch.Tensor, weight: torch.Tensor):
    """Place the (N,) int64 inputs ``xs`` by ``rule`` over ``tables``
    with the (D,) int64 reweight vector ``weight``: (out (N, result_max)
    int32 with CRUSH_ITEM_NONE holes, count (N,) int64, need_host (N,)
    bool).  On the card one launch; on the CPU the host mapper."""
    _check(tables, rule, xs, weight)
    if xs.device.type == "cpu":
        return _host_rows(tables, rule, xs, weight)
    if xs.device.type != "cuda":
        raise ValueError(f"the CRUSH rule kernel takes CUDA tensors, got "
                         f"{xs.device}")
    xs = xs.contiguous()
    weight = weight.contiguous()
    n = xs.shape[0]
    out = torch.empty((n, rule.result_max), dtype=torch.int32,
                      device=xs.device)
    count = torch.empty(n, dtype=torch.int64, device=xs.device)
    need = torch.empty(n, dtype=torch.bool, device=xs.device)
    if n == 0:
        return out, count, need
    lib = _lib()
    args = (ctypes.c_int * 10)(*_rule_args(rule))
    err = lib.crush_rule_launch(
        tables.tab.data_ptr(), tables.rows, tables.max_neg, tables.items,
        tables.positions, tables.negln.data_ptr(),
        ctypes.cast(args, ctypes.c_void_p), xs.data_ptr(), n,
        weight.data_ptr(), weight.shape[0], out.data_ptr(),
        count.data_ptr(), need.data_ptr(), *device_and_stream(xs))
    if err:
        raise KernelLaunchError(
            f"crush_rule_cuda failed: CUDA error {err} "
            f"({lib.crush_rule_error_string(err).decode()})", code=err)
    crush_rule_cuda.launches += 1
    return out, count, need


def _host_rows(tables: KernelTables, rule: KernelRule, xs: torch.Tensor,
               weight: torch.Tensor):
    """The host mapper's answers in the wrapper's form (a lane's row
    padded with NONE, its count the mapper's length, nothing flagged)."""
    w = weight.tolist()
    out = torch.full((xs.shape[0], rule.result_max), _NONE,
                     dtype=torch.int32)
    count = torch.empty(xs.shape[0], dtype=torch.int64)
    for j, x in enumerate(xs.tolist()):
        r = crush_do_rule(tables.cmap, rule.ruleno, x, rule.result_max,
                          weight=w, choose_args=tables.choose_args)
        out[j, :len(r)] = torch.tensor(r, dtype=torch.int32)
        count[j] = len(r)
    return out, count, torch.zeros(xs.shape[0], dtype=torch.bool)


WRAPPERS = register(crush_rule_cuda)

__all__ = ["KernelRule", "KernelTables", "MAX_DEPTH", "MAX_RESULT",
           "MAX_SLOTS", "WRAPPERS", "crush_rule_cuda", "kernel_rule"]
