"""The cross-call pattern cache and the serving dispatch seams.

Counterpart of ``ceph_tpu/codes/engine.py``.  Every plugin's decode is,
for a fixed (profile, erasure pattern), one GF(2^w)-linear map; the
matrices behind it, and the callables that run it on the card, are
built once per pattern and process:

- ``PatternCache`` — a process-wide LRU keyed on (plugin class,
  profile, kind, available, erased) + extras, with the reference's
  recompile-count guard: ``builds`` against ``recompile_budget`` turns
  unbounded pattern churn into an observable counter and, when a budget
  is armed, a loud RuntimeError.
- ``fused_repair_call`` — one callable per (plugin, pattern) that
  decodes the erased shards and re-encodes the full parity set from
  the survivors: (B, n_avail, C) -> (rec (B, n_erased, C), parity (B,
  m, C)).
- ``serve_dispatch_call`` / ``serve_dispatch_ragged`` — the continuous
  batcher's device seams (serve/batcher.py), dense shape buckets and
  paged pools.

Where the reference caches a jitted program, the port caches a Python
callable over tensors on the code's device; it closes over the
pattern's matrix, and the kernel data that matrix needs is cached per
(matrix, device) in ``ops/gf_kernels.py``, so a warm stream builds no
entry and uploads nothing but its inputs (the kernel-setup count of
``telemetry.metrics`` stays flat).  The device is part of every
callable's key: a CPU instance and a card instance of one profile get
their own.  The host twin is the numpy batch surfaces, which the
batcher's ``executor="host"`` runs itself.

Every call of the cached callables routes through the supervised
dispatch plane (ops/supervisor.py) under the seams
``engine.fused_repair``, ``engine.serve-{op}`` and
``engine.serve-{op}-ragged``: transient errors retry, an out-of-memory
error splits the batch rung, and persistent backend loss on a CPU code
demotes the tier live (torch -> numpy; each callable's ``rebuild``
re-derives it after the pattern cache is cleared, and at the floor its
numpy host twin completes the dispatch byte-identically).  On the card
a persistent failure raises ``DeviceDispatchError``: the card's work
never moves to the plain ops or the host.  While a seam's callable
runs, the matrix applies inside it go straight to their tier (the
reference traces them into one program), so one call is one supervised
dispatch.

With a data plane active (parallel/plane.py; the ``mesh`` argument
overrides it: a DataPlane, or falsy for the single-device callable) of
two or more members of the code's device kind, each callable is its
mesh variant: the stripe batch (the page axis of a ragged pool, its
mask alongside) cut into equal member shards, each shard through the
single-device body, the outputs gathered on the code's device
(``utils/shard.py``) — still one supervised dispatch per call, byte for
byte the single-device result, cached under a ``("mesh", n)``-suffixed
key in the same keyspace, and counted in ``engine_mesh_dispatches``.
A plane reshrink (the supervisor's quarantine) clears the cache, and
the rebuild lands on the narrowed plane.

Each callable is a program of the program profiler
(telemetry/profiler.py) under the reference's names and labels
(``engine.fused_repair``, ``engine.serve_dispatch``,
``engine.serve_dispatch_ragged``; the labels carry the config regime,
``active_source()``'s first half): at a batch rung's first call it is
captured with its analytic cost — the matrix model of its decode and
encode, summed for the fused repair; a capture computes a dict and
uploads nothing — and every call is timed into its histogram (CUDA
events on the card).  With telemetry disabled a call pays one
module-global check and goes straight to the supervised dispatch.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.supervisor import global_supervisor
from ..ops.torch_ops import mask_pages
from ..parallel.plane import plane_for
from ..telemetry import metrics as tel
from ..telemetry import tracing as trc
from ..telemetry.profiler import (analytic_fused_repair_cost,
                                  analytic_matrix_cost, global_profiler)
from ..tune.table import active_source
from ..utils.log import dout
from ..utils.locks import make_lock
from ..utils.shard import shard_batch
from .stripe import _chunk_mapping

DEFAULT_MAX_PATTERNS = 512


class PatternCache:
    """Cross-call LRU of per-(plugin, profile, erasure-pattern) decode
    artifacts, with a recompile-count guard.

    Values are opaque to the cache (matrix/static tuples, callables);
    the contract is only that a given key always maps to the same
    value, so eviction + rebuild is correct at any size."""

    def __init__(self, max_patterns: int = DEFAULT_MAX_PATTERNS,
                 recompile_budget: Optional[int] = None) -> None:
        self.max_patterns = max_patterns
        # builds above this raise (tests arm it to pin "no new entry on
        # a warm stream"); None = log-once observability only
        self.recompile_budget = recompile_budget
        self._lock = make_lock("codes.engine.PatternCache._lock")
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.builds = 0
        self.evictions = 0
        self._warned = False

    def get_or_build(self, key: tuple, build: Callable[[], object]):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                tel.counter("pattern_cache_hits")
                return hit
        # build outside the lock: a probe can take seconds and must not
        # serialize unrelated patterns
        with tel.record_dispatch("pattern_cache_build"):
            value = build()
        with self._lock:
            race = self._entries.get(key)
            if race is not None:
                self.hits += 1
                tel.counter("pattern_cache_hits")
                return race
            self.builds += 1
            tel.counter("pattern_cache_builds")
            if (self.recompile_budget is not None
                    and self.builds > self.recompile_budget):
                tel.counter("pattern_cache_budget_exceeded")
                tel.event("pattern_cache_budget_exceeded",
                          builds=self.builds,
                          budget=self.recompile_budget)
                # an armed budget tripping IS a production incident
                # (pattern churn = a rebuild storm): freeze the
                # flight-recorder post-mortem before raising
                from ..telemetry import recorder
                recorder.trip(
                    "recompile_budget",
                    f"{self.builds} builds > budget "
                    f"{self.recompile_budget}",
                    builds=self.builds, budget=self.recompile_budget,
                    key=str(key))
                raise RuntimeError(
                    f"pattern-cache recompile budget exceeded: "
                    f"{self.builds} builds > {self.recompile_budget} "
                    f"(unbounded erasure-pattern churn would rebuild per "
                    f"call)")
            self._entries[key] = value
            while len(self._entries) > self.max_patterns:
                self._entries.popitem(last=False)
                self.evictions += 1
                tel.counter("pattern_cache_evictions")
                if not self._warned:
                    self._warned = True
                    dout("ec", 1,
                         f"pattern cache exceeded {self.max_patterns} "
                         f"patterns; evicting LRU (repeat plans will "
                         f"rebuild)")
            return value

    def stats(self) -> dict:
        with self._lock:
            return {"patterns": len(self._entries), "hits": self.hits,
                    "builds": self.builds, "evictions": self.evictions}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.builds = 0
            self.evictions = 0
            self._warned = False


_global: Optional[PatternCache] = None
_global_lock = make_lock("codes.engine._global_lock")


def global_pattern_cache() -> PatternCache:
    global _global
    with _global_lock:
        if _global is None:
            _global = PatternCache()
        return _global


def set_global_pattern_cache(cache: Optional[PatternCache]
                             ) -> Optional[PatternCache]:
    """Swap the process cache (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = cache
        return prev


def pattern_key(ec, kind: str, available: tuple, erased: tuple,
                extra: tuple = ()) -> tuple:
    """Cache key for one plugin instance's (pattern, artifact kind).

    Profile-derived, not instance-derived: two factory() calls with
    the same profile share every composite matrix."""
    return (type(ec).__name__,
            tuple(sorted((str(k), str(v))
                         for k, v in ec.get_profile().items())),
            kind, tuple(available), tuple(erased)) + tuple(extra)


def _callable_key(ec, kind: str, available: tuple, erased: tuple,
                  extra: tuple = (), plane=None) -> tuple:
    """pattern_key of a cached callable: the code's device joins the
    extras, since the callable runs on it, and a mesh variant's key
    ends in ``("mesh", n)``."""
    mesh = ("mesh", plane.n_devices) if plane is not None else ()
    return pattern_key(ec, kind, available, erased,
                       tuple(extra) + ("device", str(ec.device)) + mesh)


def _sharded(raw, plane, n_out: int):
    """``raw`` over the plane's members (utils/shard.py::shard_batch),
    with ``raw``'s signature: the mesh variant's callable."""
    return lambda *args: shard_batch(raw, plane, args, n_out=n_out)


def _repair_sources(ec, available: tuple, erased: tuple) -> list:
    """For each data chunk, where the re-encode takes it from: ("avail",
    survivor column) or ("rec", decoded column).  Raises IOError when a
    data shard is neither."""
    mapping = _chunk_mapping(ec)
    aidx = {s: t for t, s in enumerate(available)}
    eidx = {s: t for t, s in enumerate(erased)}
    src = []
    for c in range(ec.get_data_chunk_count()):
        shard = mapping[c]
        if shard in aidx:
            src.append(("avail", aidx[shard]))
        elif shard in eidx:
            src.append(("rec", eidx[shard]))
        else:
            raise IOError(
                f"data shard {shard} neither available nor erased in "
                f"pattern (avail={available}, erased={erased})")
    return src


def _labels(ec, kind: str, erased: tuple, plane=None) -> dict:
    """The program series a dispatch rides: the profiler's labels and
    the causal-trace link.  ``config`` is the config regime the callable
    was built under (installing a table clears the cache, so it never
    goes stale)."""
    return dict(
        plugin=type(ec).__name__, kind=kind,
        profile=",".join(f"{pk}={pv}" for pk, pv in
                         sorted(ec.get_profile().items())),
        pattern="e" + "_".join(map(str, erased)),
        engine="mesh" if plane is not None else "device",
        devices=plane.n_devices if plane is not None else 1,
        config=active_source()[0])


def decode_matrix_static(ec, available, erased):
    """The static composite/plan decode matrix an (available, erased)
    pattern actually runs, across the plugin families: clay/lrc probed
    composites, shec's minimum-read plan matrix, the mixin decode
    matrix.  None when the plugin has no matrix surface (bitmatrix
    techniques)."""
    available, erased = tuple(available), tuple(erased)
    comp = getattr(ec, "_decode_composite", None)
    if comp is not None:
        try:
            return comp(available, erased)[1]
        except Exception:  # noqa: BLE001 - advisory probe only
            return None
    tcache = getattr(ec, "tcache", None)
    if tcache is not None and hasattr(ec, "_plan_static"):  # shec
        try:
            plan = tcache.get_plan(ec.matrix, ec.k, ec.w,
                                   frozenset(available), frozenset(erased))
            return ec._plan_static(plan)[1]
        except Exception:  # noqa: BLE001 - advisory probe only
            return None
    dm = getattr(ec, "_decode_matrix", None)
    if dm is not None:
        try:
            return dm(available, erased)[1]
        except Exception:  # noqa: BLE001 - advisory probe only
            return None
    return None


def _survivors_read(ec, available: tuple, erased: tuple) -> float:
    """Survivor chunks a decode of the pattern reads: its decode
    matrix's nonzero columns (sub-chunk columns for clay, so a repair's
    partial reads count as the fraction they are), else the k survivors
    a bitmatrix decode reads."""
    ms = decode_matrix_static(ec, available, erased)
    if ms is None:
        return float(min(ec.get_data_chunk_count(), len(available)))  # tpu-lint: disable=gf-float -- a cost-model chunk count, not GF math
    cols = int(np.count_nonzero(np.asarray(ms).any(axis=0)))
    return cols / getattr(ec, "sub_chunk_no", 1)  # tpu-lint: disable=gf-float -- a cost-model fraction of chunks read, not GF math


def _matrix_costs(ec, available: tuple, erased: tuple):
    """(decode cost, encode cost) of one pattern as functions of (batch,
    chunk bytes): the profiler's analytic matrix model over the
    survivors the decode reads -> the erased chunks, and the k -> m
    encode.  The decode's reads are worked out at its first call."""
    k, m = ec.get_data_chunk_count(), ec.get_coding_chunk_count()
    n_erased = len(erased)
    reads = []

    def dec(b, c):
        if not reads:
            reads.append(_survivors_read(ec, available, erased))
        return analytic_matrix_cost(b, n_erased, reads[0], c)

    def enc(b, c):
        return analytic_matrix_cost(b, m, k, c)
    return dec, enc


def _profiled(name: str, key: tuple, labels: dict, cost, args: tuple,
              run):
    """``run()`` as one call of the profiler's program ``key`` + (batch
    rung,): captured with ``cost(batch, chunk bytes)`` at the rung's
    first call, timed into its histogram (CUDA events for a card
    tensor)."""
    x = args[0]
    batch = int(x.shape[0])
    prof = global_profiler()
    pk = key + (batch,)
    if not prof.has(pk):
        prof.capture(pk, args, name=name, platform=x.device.type,
                     cost=cost(batch, int(x.shape[-1])), batch=batch,
                     **labels)
    with prof.timed(pk, device=x.device):
        return run()


def _host_array(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _on_device(out, device: torch.device):
    """A host twin's numpy output (an array or a tuple of them) as
    tensors on the dispatch's device."""
    if isinstance(out, tuple):
        return tuple(_on_device(o, device) for o in out)
    return torch.from_numpy(np.ascontiguousarray(out)).to(device)


# -- fused decode -> re-encode --------------------------------------------

def fused_repair_call(ec, available: Tuple[int, ...],
                      erased: Tuple[int, ...], mesh=None):
    """One cached callable: survivors (B, n_avail, C) uint8 on the code's
    device -> (rec (B, n_erased, C), parity (B, m, C)) — the decode of
    every erased shard plus the full parity re-encode.

    Shard space follows the plugin's decode surface (identity chunk
    ids, or lrc's global positions via get_chunk_mapping); the data
    chunks for the re-encode are assembled from survivor and decoded
    columns by index, as the reference does.  With a data plane (or a
    ``mesh``), the mesh variant (module docstring)."""
    available = tuple(available)
    erased = tuple(erased)
    plane = plane_for(mesh, ec.device)
    key = _callable_key(ec, "fused-repair", available, erased, (), plane)

    def build():
        src = _repair_sources(ec, available, erased)
        labels = _labels(ec, "fused-repair", erased, plane)
        dec_cost, enc_cost = _matrix_costs(ec, available, erased)

        def cost(b, c):
            return analytic_fused_repair_cost(dec_cost(b, c),
                                              enc_cost(b, c))

        def body(stack: torch.Tensor):
            rec = ec.decode_chunks_torch(stack, available, erased)
            data = torch.stack(
                [stack[:, t] if where == "avail" else rec[:, t]
                 for where, t in src], dim=1)
            return rec, ec.encode_chunks_torch(data)

        raw = body if plane is None else _sharded(body, plane, 2)

        # the supervised-dispatch couplings (ops/supervisor.py): the
        # numpy ground-truth twin (serve/batcher.py::_host_repair mirrors
        # this column assembly) and the rebuild that re-derives the
        # callable after a live demotion cleared the pattern cache
        def host_twin(stack: torch.Tensor):
            from ..serve.batcher import _host_repair
            return _on_device(_host_repair(ec, _host_array(stack),
                                           available, erased),
                              stack.device)

        def rebuild():
            return fused_repair_call(ec, available, erased, mesh=mesh)._raw

        def dispatch(stack: torch.Tensor):
            return global_supervisor().dispatch(
                "engine.fused_repair", raw, (stack,),
                host_fn=host_twin, rebuild=rebuild)

        def call(stack: torch.Tensor):
            if plane is not None:
                tel.counter("engine_mesh_dispatches", tier="fused-repair",
                            devices=str(plane.n_devices))
            if trc.enabled():
                trc.note_program("engine.fused_repair",
                                 dict(labels, batch=int(stack.shape[0])))
            if not tel.enabled():
                return dispatch(stack)
            with tel.record_dispatch("engine_fused_repair_dispatch",
                                     plugin=type(ec).__name__):
                return _profiled("engine.fused_repair", ("prof",) + key,
                                 labels, cost, (stack,),
                                 lambda: dispatch(stack))

        call._raw = raw
        return call

    return global_pattern_cache().get_or_build(key, build)


# -- serving dispatch seams (serve/batcher.py's device calls) -------------

def serve_dispatch_call(ec, op: str, available: Tuple[int, ...] = (),
                        erased: Tuple[int, ...] = (), mesh=None):
    """One cached callable per (plugin, profile, op, erasure pattern,
    device): the seam the continuous batcher fires its shape buckets
    through.

    - ``encode``: stack ``(B, k, C)`` uint8 -> parity ``(B, m, C)``
    - ``decode``: stack ``(B, n_avail, C)`` survivors -> ``(B, n_erased,
      C)`` reconstructed chunks
    - ``repair``: delegates to :func:`fused_repair_call`.

    The cache key is :func:`pattern_key` with ``kind=f"serve-{op}"``,
    the keying the decode matrices use, so a warm bucket builds nothing
    (an armed recompile budget turns a violation into a RuntimeError).
    With a data plane (or a ``mesh``), the mesh variant (module
    docstring)."""
    if op == "repair":
        return fused_repair_call(ec, available, erased, mesh=mesh)
    if op not in ("encode", "decode"):
        raise ValueError(f"serve op {op!r} must be encode|decode|repair")
    available = tuple(available)
    erased = tuple(erased)
    plane = plane_for(mesh, ec.device)
    key = _callable_key(ec, f"serve-{op}", available, erased, (), plane)

    def build():
        labels = _labels(ec, f"serve-{op}", erased, plane)
        dec_cost, enc_cost = _matrix_costs(ec, available, erased)
        cost = enc_cost if op == "encode" else dec_cost

        def body(stack: torch.Tensor):
            if op == "encode":
                return ec.encode_chunks_torch(stack)
            return ec.decode_chunks_torch(stack, available, erased)

        raw = body if plane is None else _sharded(body, plane, 1)

        # supervised-dispatch couplings: the numpy batch surfaces are the
        # ground-truth twin (the batcher's host executor runs them);
        # rebuild re-derives the callable after a live demotion
        def host_twin(stack: torch.Tensor):
            s_np = _host_array(stack)
            if op == "encode":
                out = ec.encode_chunks_batch(s_np)
            else:
                out = ec.decode_chunks_batch(s_np, available, erased)
            return _on_device(out, stack.device)

        def rebuild():
            return serve_dispatch_call(ec, op, available, erased,
                                       mesh=mesh)._raw

        def dispatch(stack: torch.Tensor):
            return global_supervisor().dispatch(
                f"engine.serve-{op}", raw, (stack,),
                host_fn=host_twin, rebuild=rebuild)

        def call(stack: torch.Tensor):
            if plane is not None:
                tel.counter("engine_mesh_dispatches", tier=f"serve-{op}",
                            devices=str(plane.n_devices))
            if trc.enabled():
                trc.note_program("engine.serve_dispatch",
                                 dict(labels, batch=int(stack.shape[0])))
            if not tel.enabled():
                return dispatch(stack)
            with tel.record_dispatch("serve_dispatch", op=op,
                                     plugin=type(ec).__name__):
                return _profiled("engine.serve_dispatch", ("prof",) + key,
                                 labels, cost, (stack,),
                                 lambda: dispatch(stack))

        call._raw = raw
        return call

    return global_pattern_cache().get_or_build(key, build)


def _ragged_surface(ec, op: str):
    """The plugin's true ragged surface when it has one (the matrix and
    bitmatrix families, shec), else None — the generic mask-gate body
    runs instead, byte-identically."""
    return getattr(type(ec), f"{op}_chunks_ragged_torch", None)


def serve_dispatch_ragged(ec, op: str, available: Tuple[int, ...] = (),
                          erased: Tuple[int, ...] = (), *,
                          pages: int, page_size: int, mesh=None):
    """One cached callable per (plugin, profile, op, erasure pattern,
    pool geometry, device): the paged batcher's device seam.

    Its signature is ``(pool, mask)`` — pool ``(pages, rows,
    page_size)`` uint8 and mask ``(pages,)`` {0,1}, both on the code's
    device — and the mask is data, so every occupancy of the pool runs
    the same callable and the same kernel build.  Dead pages compute
    zeros in every tier (GF linearity), so demux never reads them.

    - ``encode``: pool pages are (k, page_size) mini-chunks -> parity
      pages (pages, m, page_size)
    - ``decode``: survivor pages -> (pages, n_erased, page_size)
    - ``repair``: the fused decode -> column assembly -> re-encode of
      fused_repair_call on the masked page batch -> (rec, parity)

    With a data plane (or a ``mesh``) the mesh variant shards the PAGE
    axis (pages are independent mini-chunks) with the mask alongside; a
    pool that does not divide pads with zero-mask pages, dead by
    construction."""
    if op not in ("encode", "decode", "repair"):
        raise ValueError(f"serve op {op!r} must be encode|decode|repair")
    available = tuple(available)
    erased = tuple(erased)
    plane = plane_for(mesh, ec.device)
    key = _callable_key(ec, f"serve-{op}-ragged", available, erased,
                        ("paged", int(pages), int(page_size)), plane)

    def build():
        src = (_repair_sources(ec, available, erased) if op == "repair"
               else None)
        dec = _ragged_surface(ec, "decode")
        enc = _ragged_surface(ec, "encode")
        labels = _labels(ec, f"serve-{op}-ragged", erased, plane)
        dec_cost, enc_cost = _matrix_costs(ec, available, erased)
        if op == "repair":
            def cost(b, c):
                return analytic_fused_repair_cost(dec_cost(b, c),
                                                  enc_cost(b, c))
        else:
            cost = enc_cost if op == "encode" else dec_cost

        def body(pool: torch.Tensor, mask: torch.Tensor):
            if op == "encode":
                if enc is not None:
                    return enc(ec, pool, mask)
                return ec.encode_chunks_torch(mask_pages(pool, mask))
            if op == "decode":
                if dec is not None:
                    return dec(ec, pool, mask, available, erased)
                return ec.decode_chunks_torch(mask_pages(pool, mask),
                                              available, erased)
            # repair: survivors mask-gated once, so the column assembly
            # and the re-encode see zeros on dead pages
            x = mask_pages(pool, mask)
            if dec is not None:
                rec = dec(ec, pool, mask, available, erased)
            else:
                rec = ec.decode_chunks_torch(x, available, erased)
            data = torch.stack(
                [x[:, t] if where == "avail" else rec[:, t]
                 for where, t in src], dim=1)
            return rec, ec.encode_chunks_torch(data)

        raw = body if plane is None else _sharded(
            body, plane, 2 if op == "repair" else 1)

        # supervised-dispatch couplings (ops/supervisor.py): numpy
        # ground truth = zero the dead pages, then the same batch
        # surfaces the dense host twin runs; rebuild re-derives the
        # callable after a live demotion
        def host_twin(pool: torch.Tensor, mask: torch.Tensor):
            x = _host_array(pool) * (_host_array(mask) != 0).astype(
                np.uint8)[:, None, None]
            if op == "encode":
                out = ec.encode_chunks_batch(x)
            elif op == "decode":
                out = ec.decode_chunks_batch(x, available, erased)
            else:
                from ..serve.batcher import _host_repair
                out = _host_repair(ec, x, available, erased)
            return _on_device(out, pool.device)

        def rebuild():
            return serve_dispatch_ragged(
                ec, op, available, erased, pages=pages,
                page_size=page_size, mesh=mesh)._raw

        def dispatch(pool: torch.Tensor, mask: torch.Tensor):
            return global_supervisor().dispatch(
                f"engine.serve-{op}-ragged", raw, (pool, mask),
                host_fn=host_twin, rebuild=rebuild)

        def call(pool: torch.Tensor, mask: torch.Tensor):
            if plane is not None:
                tel.counter("engine_mesh_dispatches",
                            tier=f"serve-{op}-ragged",
                            devices=str(plane.n_devices))
            if trc.enabled():
                trc.note_program("engine.serve_dispatch_ragged",
                                 dict(labels, batch=int(pool.shape[0])))
            if not tel.enabled():
                return dispatch(pool, mask)
            # one program per pattern: the key carries the (static) pool
            # page count, not a rung
            with tel.record_dispatch("serve_dispatch_ragged", op=op,
                                     plugin=type(ec).__name__):
                return _profiled("engine.serve_dispatch_ragged",
                                 ("prof",) + key, labels, cost,
                                 (pool, mask), lambda: dispatch(pool, mask))

        call._raw = raw
        return call

    return global_pattern_cache().get_or_build(key, build)


__all__ = ["DEFAULT_MAX_PATTERNS", "PatternCache", "decode_matrix_static",
           "fused_repair_call", "global_pattern_cache", "pattern_key",
           "serve_dispatch_call", "serve_dispatch_ragged",
           "set_global_pattern_cache"]
