"""ceph_tpu_torch.crush — CRUSH placement, the port of ``ceph_tpu.crush``.

Mirrors src/crush/ (hash.{h,c}, crush_ln_table.h, crush.h, builder.c,
mapper.c, CrushWrapper.{h,cc}, CrushTester.{h,cc}).  The host modules
are copies of the reference's, their imports pointing at the port:

- ``hash``    — crush_hash32_* (rjenkins1) over numpy uint32, plus torch
  twins over int32 bits for the bulk evaluator.
- ``ln``      — crush_ln 16.48 fixed-point log2 + its lookup tables.
- ``types``   — crush_map / crush_bucket / crush_rule / tunables structs.
- ``builder`` — bucket construction (uniform/list/tree/straw/straw2),
  map building and editing (CrushWrapper role).
- ``mapper``  — host reference crush_do_rule (choose_firstn/indep,
  chooseleaf, retries, is_out) — the oracle the bulk path is pinned to.
- ``compiler`` / ``text_compiler`` / ``binary`` — JSON, crushtool
  text grammar, and binary (CrushWrapper::encode/decode wire form).
- ``osdmap``  — the pg → OSD pipeline above CRUSH, scalar + whole-pool
  bulk paths; ``poolops`` (EC pool creation) and ``balancer``
  (OSDMap::calc_pg_upmaps).
- ``tester``  — CrushTester-style mapping sweeps + statistics.

New in the port: ``bulk`` — the bulk evaluator as a lane-batched eager
torch program on the card (the reference's is a vmapped XLA program),
its first rung a CUDA kernel (``ops/crush_kernels.py``) where the map
and rule are in the kernel's scope.
It is imported lazily (nothing here pulls in torch).

- ``incremental`` — OSDMap::Incremental / apply_incremental: the mon's
  epoch-ordered map-mutation model; resume = epoch catch-up.
- ``inc_binary`` — the incremental's wire form, byte-identical to the
  reference's.
"""

from .types import (  # noqa: F401
    CRUSH_ITEM_NONE,
    Bucket,
    CrushMap,
    Rule,
    Tunables,
    step_take,
    step_choose_firstn,
    step_choose_indep,
    step_chooseleaf_firstn,
    step_chooseleaf_indep,
    step_emit,
)
from .builder import CrushBuilder  # noqa: F401
from .mapper import crush_do_rule  # noqa: F401
from .compiler import compile_map, decompile  # noqa: F401
from .text_compiler import compile_text, decompile_text  # noqa: F401
from .binary import decode_map, encode_map  # noqa: F401
