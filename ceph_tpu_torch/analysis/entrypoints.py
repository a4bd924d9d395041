"""The entry-point registry — what the port's audit certifies; a port
of ``ceph_tpu/analysis/entrypoints.py``.

Every public surface that hands work to the device is declared here
with a representative workload: the plugin families' encode/decode
(byte and packed layouts), the engine dispatchers, the hand-written
kernels' wrappers, the fused decode -> re-encode repair, the serving
seams, CRUSH's bulk evaluator, their sharded variants over the data
plane's members, the cluster plane's rules over a production-shape map
and its rateless dispatch, and the host-tier entries (scrub's batched
CRC, the telemetry selftests, the serving pool and batcher, the
scenario runner, the QoS arbiter and the tenant week, the supervisor,
the host fault-domain arc, the analytic sweep), whose contract is that
they touch no device.  Names, families and representative profiles are the
reference's; an entry of a kernel keeps the reference's name
(``ops.apply_matrix_pallas`` ...) and anchors on the port's wrapper.

Each :class:`EntryPoint` declares:

- ``kind`` — ``"device"`` (runs on the device its build function is given:
  the card unless the caller passes a CPU device) or ``"host"``;
- ``build(device)`` → a :class:`Built`: the callable, concrete args
  (small shapes, seeded random bytes), the anchor function, and, where
  the callable is a kernel's wrapper (which runs its plain torch version
  on a CPU tensor, not the numpy tier), ``twin``, its numpy ground truth
  over host copies of the args;
- ``setup_budget`` — the most kernel setups one cold run may count
  (``telemetry.metrics.note_kernel_setup``: libraries loaded, kernel
  data uploaded), the counterpart of the reference's ``trace_budget``;
  a warm repeat must count none;
- ``sync_ok`` — why a warm repeat may synchronize with the host, or ""
  when it must not (the counterpart of the reference's primitive allow
  sets: a sync the audit finds is removed or declared here; a declared
  sync that no longer happens is drift, and fails too).

analysis/audit.py runs the checks.  Importing this module imports no
plugin: the build functions do, lazily.  :func:`registry_names` equals
the reference's, in its order.

``registry_gaps()`` is the completeness gate: every public
``*_chunks*_torch`` surface of each family's representative instance
must be registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

# the reference's families
FAMILIES = ("jerasure", "isa", "shec", "lrc", "clay",
            "engine", "ops", "crush", "scrub", "telemetry", "serve",
            "cluster", "scenario", "tune", "chaos")

# public device surfaces a plugin family can expose (the reference's
# ``*_chunks*_jax``); the completeness check requires every one present
# on a family's representative instance to be registered
PLUGIN_SURFACES = ("encode_chunks_torch", "decode_chunks_torch",
                   "encode_chunks_packed_torch",
                   "decode_chunks_packed_torch")
# the registry's entry name of each surface: the reference's
SURFACE_NAMES = dict(zip(PLUGIN_SURFACES, (
    "encode_chunks_jax", "decode_chunks_jax", "encode_chunks_packed_jax",
    "decode_chunks_packed_jax")))

B = 2          # representative batch
C = 4096       # representative chunk bytes (packed R = C/512 = 8 rows)
R = C // 512

REPRESENTATIVE_PROFILES: Dict[str, Tuple[str, Dict[str, str]]] = {
    # family -> (plugin name, profile) — mirrors the tier-1 test
    # matrices; small geometries, every code path identical to prod
    "jerasure": ("jerasure", {"technique": "reed_sol_van",
                              "k": "4", "m": "2"}),
    "jerasure_cauchy": ("jerasure", {"technique": "cauchy_good",
                                     "k": "4", "m": "2",
                                     "packetsize": "512"}),
    "isa": ("isa", {"k": "4", "m": "2"}),
    "shec": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "lrc": ("lrc", {"k": "4", "m": "2", "l": "3"}),
    "clay": ("clay", {"k": "4", "m": "2", "d": "5"}),
}


@dataclasses.dataclass
class Built:
    """One buildable workload: the callable, its concrete args, the
    source anchor, and (kernel wrappers) the numpy ground truth over
    host copies of the args."""
    fn: Callable
    args: tuple
    anchor: Callable
    twin: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str                       # "clay.decode_chunks_jax"
    family: str                     # one of FAMILIES
    kind: str                       # "device" | "host"
    build: Callable[..., Built]     # build(device) -> Built
    # kernel-setup ceiling for one cold run; a warm repeat counts none
    setup_budget: int = 8
    # why a warm repeat may synchronize with the host ("" = it must not)
    sync_ok: str = ""


# ----------------------------------------------------------------------
# shared instance cache (the build functions run repeatedly)

_EC_CACHE: Dict[tuple, object] = {}


def _device(device):
    from ..ops.fallback import resolve_device
    return resolve_device(device)


def representative_instance(family: str, device="cpu"):
    """The family's representative plugin instance on ``device``
    (cached)."""
    dev = _device(device)
    ec = _EC_CACHE.get((family, str(dev)))
    if ec is None:
        from ..codes.registry import ErasureCodePluginRegistry
        plugin, profile = REPRESENTATIVE_PROFILES[family]
        ec = ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile), device=dev)
        _EC_CACHE[(family, str(dev))] = ec
    return ec


def _erasure_pattern(ec):
    """Erase shard 1 — every family can repair one loss."""
    n = ec.get_chunk_count()
    erased = (1,)
    available = tuple(i for i in range(n) if i != 1)
    return available, erased


def seeded(shape, dtype, seed: int = 0):
    """Seeded random data of ``shape`` (numpy): the args every device
    entry is built on, so two builds (and the reference's entry) see
    the same bytes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    return rng.integers(0, int(info.max) + 1, size=shape, dtype=dtype)


def _tensor(arr, dev):
    import torch
    return torch.from_numpy(arr).to(dev)


# ----------------------------------------------------------------------
# the build functions

def _plugin_surface_builder(family: str, surface: str) -> Callable:
    def build(device=None) -> Built:
        import numpy as np

        dev = _device(device)
        ec = representative_instance(family, dev)
        k = ec.get_data_chunk_count()
        available, erased = _erasure_pattern(ec)
        anchor = getattr(type(ec), surface)
        if surface == "encode_chunks_torch":
            args = (_tensor(seeded((B, k, C), np.uint8), dev),)
            fn = ec.encode_chunks_torch
        elif surface == "decode_chunks_torch":
            args = (_tensor(seeded((B, len(available), C), np.uint8),
                            dev),)
            fn = (lambda chunks, _ec=ec, _a=available, _e=erased:
                  _ec.decode_chunks_torch(chunks, _a, _e))
        elif surface == "encode_chunks_packed_torch":
            args = (_tensor(seeded((B, k, R, 128), np.uint32), dev),)
            fn = ec.encode_chunks_packed_torch
        else:  # decode_chunks_packed_torch
            args = (_tensor(seeded((B, len(available), R, 128),
                                   np.uint32), dev),)
            fn = (lambda words, _ec=ec, _a=available, _e=erased:
                  _ec.decode_chunks_packed_torch(words, _a, _e))
        return Built(fn, args, anchor)

    return build


def _rs_static():
    """The jerasure RS (m, k) coding matrix as the hashable static
    tuple — the representative small matrix for the ops entries."""
    from ..ops.torch_ops import matrix_to_static

    return matrix_to_static(representative_instance("jerasure").matrix)


def _matrix_twin(ms, packed: bool = False):
    """The numpy ground truth of a GF(2^8) matrix apply (regionops), on
    bytes or on the packed word layout."""
    def twin(x):
        import numpy as np

        from ..ops import regionops
        mat = np.asarray(ms, dtype=np.int64)
        if not packed:
            return regionops.matrix_encode(x, mat, 8)
        b = np.ascontiguousarray(x).view(np.uint8).reshape(
            x.shape[:-2] + (-1,))
        out = regionops.matrix_encode(b, mat, 8)
        return np.ascontiguousarray(out).view(np.uint32).reshape(
            out.shape[:-1] + (-1, 128))
    return twin


def _ops_builder(wrapper: str, packed: bool = False, s: int = 4,
                 matrix=None, schedule=None):
    """An ops entry on a seeded (B, s, C) stack (packed: (B, s, R,
    128)): ``wrapper`` of gf_kernels (or torch_ops) applied to the RS
    matrix, or to ``schedule()``'s static tuple when given (the matrix
    it schedules is ``matrix()``); numpy twin the matrix apply."""
    def build(device=None) -> Built:
        import numpy as np

        from ..ops import gf_kernels, torch_ops
        dev = _device(device)
        fn_w = getattr(gf_kernels, wrapper, None) or \
            getattr(torch_ops, wrapper)
        ms = matrix() if matrix is not None else _rs_static()
        coef = schedule() if schedule is not None else ms
        shape = (B, s, R, 128) if packed else (B, s, C)
        x = _tensor(seeded(shape, np.uint32 if packed else np.uint8), dev)
        return Built(lambda v: fn_w(v, coef), (x,), fn_w,
                     twin=_matrix_twin(ms, packed))
    return build


def _build_apply_matrix_best(device=None) -> Built:
    import numpy as np

    from ..ops.gf_kernels import apply_matrix_best

    dev = _device(device)
    ms = _rs_static()
    return Built(lambda x: apply_matrix_best(x, ms, 8),
                 (_tensor(seeded((B, 4, C), np.uint8), dev),),
                 apply_matrix_best)


def _build_apply_matrix_packed_best(device=None) -> Built:
    import numpy as np

    from ..ops.gf_kernels import apply_matrix_packed_best

    dev = _device(device)
    ms = _rs_static()
    return Built(lambda x: apply_matrix_packed_best(x, ms),
                 (_tensor(seeded((B, 4, R, 128), np.uint32), dev),),
                 apply_matrix_packed_best)


def _bitmatrix_builder(technique: str, scheduled: bool):
    """A packet-layout kernel entry: jerasure ``technique`` k=4 m=2 at
    packetsize 512, plain (cauchy_good) or CSE-scheduled (cauchy_orig,
    whose greedy sharing pays: the probe must schedule it, else the
    entry would run the wrong kernel)."""
    def build(device=None) -> Built:
        import numpy as np

        from ..codes.registry import ErasureCodePluginRegistry
        from ..ops import regionops
        from ..ops.gf_kernels import (apply_bitmatrix_cuda,
                                      apply_bitmatrix_xor_cuda)
        from ..ops.torch_ops import bitmatrix_to_static
        from ..ops.xor_schedule import probe_bitmatrix_schedule

        dev = _device(device)
        ec = ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"technique": technique, "k": "4", "m": "2",
                         "packetsize": "512"}, device="cpu")
        rows = bitmatrix_to_static(ec.bitmatrix)
        w, packetsize = ec.w, 512
        bm = np.asarray(ec.bitmatrix)
        x = _tensor(seeded((B, 4, w * packetsize), np.uint8), dev)

        def twin(v):
            return regionops.bitmatrix_encode(v, bm, w, packetsize)
        if not scheduled:
            return Built(lambda v: apply_bitmatrix_cuda(v, rows, w,
                                                        packetsize),
                         (x,), apply_bitmatrix_cuda, twin=twin)
        sched = probe_bitmatrix_schedule(rows, w)
        assert sched is not None, f"{technique} bitmatrix must schedule"
        return Built(lambda v: apply_bitmatrix_xor_cuda(v, sched.static, w,
                                                        packetsize),
                     (x,), apply_bitmatrix_xor_cuda, twin=twin)
    return build


# representative XOR schedules (ops/xor_schedule.py): one CSE schedule
# that exercises the xtime plane chain (an entry of 2 forces one
# doubling), one ring-transform schedule (monomial matrix) — both the
# reference's pinned matrices

_XOR_CSE = ((1, 1, 1, 1, 0, 0, 0), (0, 0, 1, 1, 1, 1, 0),
            (2, 0, 0, 0, 1, 1, 1))
_XOR_RING = ((1, 1, 1, 1, 1, 1, 1), (1, 2, 4, 8, 16, 32, 64))


def _xor_cse_static():
    from ..ops.xor_schedule import build_schedule

    return build_schedule(_XOR_CSE).static


def _xor_ring_static():
    from ..ops.xor_schedule import build_schedule

    sched = build_schedule(_XOR_RING)
    assert sched.transform == "ring", sched.transform
    return sched.static


def _build_fused_repair(device=None) -> Built:
    import numpy as np

    from ..codes.engine import fused_repair_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    available, erased = _erasure_pattern(ec)
    fn = fused_repair_call(ec, available, erased)
    return Built(fn, (_tensor(seeded((B, len(available), C), np.uint8),
                              dev),), fused_repair_call)


# ----------------------------------------------------------------------
# mesh-sharded variants: the same callables with the stripe batch
# sharded over a plane spanning every visible member of the device's
# kind (CEPH_TPU_TORCH_VIRTUAL_DEVICES=N gives N members of one device).
# With one member the plane degrades to the single-device callable, as
# the reference's does on one device.

_SHARD_B = 8  # divides every power-of-two member count (1/2/4/8)


def _mesh_plane_all(dev, hosts: int = 1):
    """An explicit DataPlane over every visible member of ``dev``'s
    kind (tp=1), split into ``hosts`` fault domains when the member
    count allows."""
    from ..parallel.mesh import make_mesh, visible_devices
    from ..parallel.plane import DataPlane

    members = visible_devices(dev.type)
    n = len(members)
    h = hosts if n >= hosts and n % hosts == 0 else 1
    return DataPlane(make_mesh(n, tp=1, devices=members), hosts=h)


def _build_fused_repair_sharded(device=None) -> Built:
    import numpy as np

    from ..codes.engine import fused_repair_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    available, erased = _erasure_pattern(ec)
    fn = fused_repair_call(ec, available, erased,
                           mesh=_mesh_plane_all(dev))
    return Built(fn, (_tensor(seeded((_SHARD_B, len(available), C),
                                     np.uint8), dev),),
                 fused_repair_call)


def _build_serve_dispatch_sharded(device=None) -> Built:
    import numpy as np

    from ..codes.engine import serve_dispatch_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    k = ec.get_data_chunk_count()
    fn = serve_dispatch_call(ec, "encode", mesh=_mesh_plane_all(dev))
    return Built(fn, (_tensor(seeded((_SHARD_B, k, C), np.uint8), dev),),
                 serve_dispatch_call)


def _build_fused_repair_host_sharded(device=None) -> Built:
    """The fused repair sharded over a HOST-PARTITIONED plane, on its
    own erasure pattern so it audits its own cached callable: the host
    split is dispatch-plane bookkeeping, so a warm repeat sets up
    nothing."""
    import numpy as np

    from ..codes.engine import fused_repair_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    n = ec.get_chunk_count()
    erased = (2,)
    available = tuple(i for i in range(n) if i != 2)
    fn = fused_repair_call(ec, available, erased,
                           mesh=_mesh_plane_all(dev, hosts=2))
    return Built(fn, (_tensor(seeded((_SHARD_B, len(available), C),
                                     np.uint8), dev),),
                 fused_repair_call)


def _build_apply_matrix_best_sharded(device=None) -> Built:
    import numpy as np

    from ..ops.gf_kernels import apply_matrix_best

    dev = _device(device)
    ms = _rs_static()
    plane = _mesh_plane_all(dev)
    return Built(lambda x: apply_matrix_best(x, ms, 8, mesh=plane),
                 (_tensor(seeded((_SHARD_B, 4, C), np.uint8), dev),),
                 apply_matrix_best)


def _crush_map():
    """The reference's representative map: two levels of 4 hosts x 2
    OSDs, rule 0 = take root, chooseleaf indep 0 host, emit."""
    from ..crush import (CrushBuilder, step_chooseleaf_indep, step_emit,
                         step_take)

    b = CrushBuilder()
    root = b.build_two_level(4, 2)
    b.add_rule(0, [step_take(root), step_chooseleaf_indep(0, 1),
                   step_emit()])
    return b.map


def _crush_builder(sharded: bool):
    def build(device=None) -> Built:
        import numpy as np

        from ..crush.bulk import CompiledCrushMap, bulk_do_rule
        from ..crush.mapper import crush_do_rule
        from ..crush.types import CRUSH_ITEM_NONE

        dev = _device(device)
        cmap = _crush_map()
        cm = CompiledCrushMap(cmap, device=dev)
        mesh = _mesh_plane_all(dev) if sharded else 0
        xs = np.arange(_SHARD_B if sharded else 8, dtype=np.int64)

        def twin(v):
            out = np.full((len(v), 3), CRUSH_ITEM_NONE, np.int32)
            cnt = np.zeros(len(v), np.int32)
            for j, x in enumerate(v):
                r = crush_do_rule(cmap, 0, int(x), 3)
                out[j, :len(r)] = r
                cnt[j] = len(r)
            return out, cnt
        return Built(lambda v: bulk_do_rule(cm, 0, v, 3, mesh=mesh),
                     (xs,), bulk_do_rule, twin=twin)
    return build


# cluster plane: the balancer round and the storm re-eval are both the
# bulk evaluator's rule program, over a topology-generated
# production-shape map (root -> rack -> host -> osd): the replicated
# chooseleaf-firstn rule is the balancer loop's per-round evaluation,
# the canonical EC chooseleaf-indep rule (SET steps) is what every storm
# epoch re-evaluates.  A small spec: the audit is about the program, not
# throughput.

_CLUSTER_CACHE: Dict[str, object] = {}


def _cluster_map(device="cpu"):
    """The reference's audit cluster, built on ``device`` (cached)."""
    dev = _device(device)
    hit = _CLUSTER_CACHE.get(str(dev))
    if hit is None:
        from ..cluster.topology import ClusterSpec, build_cluster
        spec = ClusterSpec(seed=5, racks=3, hosts_per_rack=2,
                           osds_per_host=2, replicated_pg_num=16,
                           ec_pg_num=8, ec_k=2, ec_m=1)
        hit = build_cluster(spec, device=dev)
        _CLUSTER_CACHE[str(dev)] = hit
    return hit


def _cluster_rule_builder(pool_name: str):
    """The bulk rule of the audit cluster's pool ``pool_name``
    (``cluster.topology``'s ``REPLICATED_POOL`` or ``EC_POOL``)."""
    def build(device=None) -> Built:
        import numpy as np

        from ..cluster import topology
        from ..crush.bulk import bulk_do_rule
        from ..crush.mapper import crush_do_rule
        from ..crush.types import CRUSH_ITEM_NONE

        m = _cluster_map(device)
        pool = m.pools[getattr(topology, pool_name)]
        cm = m._compiled_map()
        weight = list(m.osd_weight)
        xs = np.asarray(pool.pps_all()[:8], dtype=np.int64)

        def twin(v):
            out = np.full((len(v), pool.size), CRUSH_ITEM_NONE, np.int32)
            cnt = np.zeros(len(v), np.int32)
            for j, x in enumerate(v):
                r = crush_do_rule(m.crush, pool.crush_rule, int(x),
                                  pool.size, weight=weight)
                out[j, :len(r)] = r
                cnt[j] = len(r)
            return out, cnt
        return Built(lambda v: bulk_do_rule(cm, pool.crush_rule, v,
                                            pool.size, weight=weight,
                                            mesh=0),
                     (xs,), bulk_do_rule, twin=twin)
    return build


def _build_cluster_rateless_dispatch(device=None) -> Built:
    """The program one over-planned rateless copy dispatches
    (cluster/rateless.py::rateless_dispatch_call = the engine's fused
    decode -> re-encode repair).  Its own erasure pattern, so this
    audits its own cached callable."""
    import numpy as np

    from ..cluster.rateless import rateless_dispatch_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    n = ec.get_chunk_count()
    erased = (2,)
    available = tuple(i for i in range(n) if i != 2)
    fn = rateless_dispatch_call(ec, available, erased)
    return Built(fn, (_tensor(seeded((B, len(available), C), np.uint8),
                              dev),), rateless_dispatch_call)


def _build_crc_batch(device=None) -> Built:
    import numpy as np

    from ..codes.stripe import ceph_crc32c_batch

    crcs = np.full(B, 0xFFFFFFFF, np.uint32)
    bufs = seeded((B, 2 * C), np.uint8)
    return Built(ceph_crc32c_batch, (crcs, bufs), ceph_crc32c_batch)


def _build_serve_dispatch(device=None) -> Built:
    """The serving batcher's bucketed device dispatch
    (engine.serve_dispatch_call) on the representative RS encode bucket
    at a mid-ladder rung."""
    import numpy as np

    from ..codes.engine import serve_dispatch_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    k = ec.get_data_chunk_count()
    fn = serve_dispatch_call(ec, "encode")
    return Built(fn, (_tensor(seeded((4, k, C), np.uint8), dev),),
                 serve_dispatch_call)


def _ragged_builder(sharded: bool):
    """The paged serving path's ragged callable
    (engine.serve_dispatch_ragged): the whole page pool plus the
    activity mask, a scattered 3-live-page mask (the first 3 pages
    sharded along the page axis)."""
    def build(device=None) -> Built:
        import numpy as np

        from ..codes.engine import serve_dispatch_ragged

        dev = _device(device)
        ec = representative_instance("jerasure", dev)
        k = ec.get_data_chunk_count()
        pages, page_size = (_SHARD_B if sharded else 8), 512
        fn = serve_dispatch_ragged(
            ec, "encode", pages=pages, page_size=page_size,
            mesh=_mesh_plane_all(dev) if sharded else None)
        mask = np.zeros(pages, np.uint8)
        mask[[0, 1, 2] if sharded else [0, 3, 5]] = 1
        return Built(fn, (_tensor(seeded((pages, k, page_size), np.uint8),
                                  dev), _tensor(mask, dev)),
                     serve_dispatch_ragged)
    return build


def _host_builder(module: str, attr: str) -> Callable:
    """A host-tier entry: the named selftest, called with no args."""
    def build(device=None) -> Built:
        import importlib
        fn = getattr(importlib.import_module(module, __package__), attr)
        return Built(fn, (), fn)
    return build


def _build_serve_batcher(device=None) -> Built:
    """Queue/batcher/SLO bookkeeping as a host-tier entry: a seeded
    closed-loop mini-scenario on a FakeClock with the host executor."""
    from ..serve.batcher import ContinuousBatcher
    from ..serve.loadgen import (CodecSpec, TrafficSpec,
                                 run_serving_scenario,
                                 throughput_service_model)
    from ..utils.retry import FakeClock

    spec = TrafficSpec(
        seed=11, n_requests=12,
        codecs=[CodecSpec("rs_k2_m1", "jerasure",
                          {"technique": "reed_sol_van",
                           "k": "2", "m": "1"}, 512)],
        ladder=(1, 2, 4), concurrency=6)

    def workload():
        run = run_serving_scenario(
            spec, clock=FakeClock(), executor="host",
            service_model=throughput_service_model())
        return run.report

    return Built(workload, (), ContinuousBatcher.poll)


def _build_fused_repair_supervised(device=None) -> Built:
    """The supervised fused-repair seam on its own erasure pattern, so
    it audits its own cached callable: supervision adds no setup on a
    warm repeat."""
    import numpy as np

    from ..codes.engine import fused_repair_call

    dev = _device(device)
    ec = representative_instance("jerasure", dev)
    n = ec.get_chunk_count()
    erased = (3,)
    available = tuple(i for i in range(n) if i != 3)
    fn = fused_repair_call(ec, available, erased)
    return Built(fn, (_tensor(seeded((B, len(available), C), np.uint8),
                              dev),), fused_repair_call)


# ----------------------------------------------------------------------
# THE registry

# why CRUSH's bulk evaluator synchronizes: the residue ladder reads the
# first rung's need-host flags (and the results) back to the host
_CRUSH_SYNC = ("the rung ladder reads the first rung's need-host flags "
               "on the host to pick the lanes of the next rung, and "
               "returns numpy results")


def _plugin_entries() -> List[EntryPoint]:
    entries: List[EntryPoint] = []
    surfaces = {
        "jerasure": PLUGIN_SURFACES,
        "jerasure_cauchy": ("encode_chunks_torch", "decode_chunks_torch"),
        "isa": PLUGIN_SURFACES,
        "shec": PLUGIN_SURFACES,
        "lrc": PLUGIN_SURFACES,
        "clay": PLUGIN_SURFACES,
    }
    for family, surfs in surfaces.items():
        base = "jerasure" if family == "jerasure_cauchy" else family
        for surface in surfs:
            entries.append(EntryPoint(
                name=f"{family}.{SURFACE_NAMES[surface]}",
                family=base, kind="device",
                build=_plugin_surface_builder(family, surface),
                setup_budget=12))
    return entries


def registry() -> Tuple[EntryPoint, ...]:
    """Every audited entry point, in deterministic audit order (the
    reference's)."""
    dev = "device"
    entries = _plugin_entries()
    entries += [
        EntryPoint("ops.apply_matrix_best", "ops", dev,
                   _build_apply_matrix_best, setup_budget=4),
        EntryPoint("ops.apply_matrix_packed_best", "ops", dev,
                   _build_apply_matrix_packed_best, setup_budget=4),
        EntryPoint("ops.apply_matrix_pallas", "ops", dev,
                   _ops_builder("apply_matrix_cuda"), setup_budget=4),
        EntryPoint("ops.apply_matrix_pallas_packed", "ops", dev,
                   _ops_builder("apply_matrix_cuda_packed", packed=True),
                   setup_budget=4),
        EntryPoint("ops.apply_bitmatrix_pallas", "ops", dev,
                   _bitmatrix_builder("cauchy_good", False),
                   setup_budget=4),
        EntryPoint("ops.apply_matrix_mxu", "ops", dev,
                   _ops_builder("apply_matrix_mxu_cuda"), setup_budget=4),
        EntryPoint("ops.apply_matrix_xor_pallas", "ops", dev,
                   _ops_builder("apply_matrix_xor_cuda", s=7,
                                matrix=lambda: _XOR_CSE,
                                schedule=_xor_cse_static),
                   setup_budget=4),
        EntryPoint("ops.apply_matrix_xor_packed", "ops", dev,
                   _ops_builder("apply_matrix_xor_cuda_packed",
                                packed=True, s=7,
                                matrix=lambda: _XOR_RING,
                                schedule=_xor_ring_static),
                   setup_budget=4),
        # the reference's XLA build of the schedule: the port's plain
        # torch version of it
        EntryPoint("ops.apply_matrix_xor_xla", "ops", dev,
                   _ops_builder("apply_matrix_xor_torch", s=7,
                                matrix=lambda: _XOR_CSE,
                                schedule=_xor_cse_static),
                   setup_budget=0),
        EntryPoint("ops.apply_bitmatrix_xor", "ops", dev,
                   _bitmatrix_builder("cauchy_orig", True),
                   setup_budget=4),
        EntryPoint("engine.fused_repair_call", "engine", dev,
                   _build_fused_repair),
        EntryPoint("engine.fused_repair_sharded", "engine", dev,
                   _build_fused_repair_sharded),
        EntryPoint("serve.dispatch_sharded", "serve", dev,
                   _build_serve_dispatch_sharded),
        EntryPoint("engine.fused_repair_host_sharded", "engine", dev,
                   _build_fused_repair_host_sharded),
        EntryPoint("ops.apply_matrix_best_sharded", "ops", dev,
                   _build_apply_matrix_best_sharded, setup_budget=4),
        EntryPoint("crush.bulk_rule_sharded", "crush", dev,
                   _crush_builder(True), setup_budget=1,
                   sync_ok=_CRUSH_SYNC),
        EntryPoint("crush.bulk_rule", "crush", dev,
                   _crush_builder(False), setup_budget=1,
                   sync_ok=_CRUSH_SYNC),
        EntryPoint("scrub.ceph_crc32c_batch", "scrub", "host",
                   _build_crc_batch, setup_budget=0),
        EntryPoint("telemetry.selftest", "telemetry", "host",
                   _host_builder("..telemetry", "telemetry_selftest"),
                   setup_budget=0),
        EntryPoint("telemetry.profiler_selftest", "telemetry", "host",
                   _host_builder("..telemetry.profiler",
                                 "profiler_selftest"), setup_budget=0),
        EntryPoint("telemetry.flight_recorder", "telemetry", "host",
                   _host_builder("..telemetry.recorder",
                                 "flight_recorder_selftest"),
                   setup_budget=0),
        EntryPoint("telemetry.tracing", "telemetry", "host",
                   _host_builder("..telemetry.tracing",
                                 "tracing_selftest"), setup_budget=0),
        EntryPoint("serve.dispatch", "serve", dev,
                   _build_serve_dispatch),
        EntryPoint("serve.dispatch_ragged", "serve", dev,
                   _ragged_builder(False)),
        EntryPoint("serve.dispatch_ragged_sharded", "serve", dev,
                   _ragged_builder(True)),
        EntryPoint("serve.pool", "serve", "host",
                   _host_builder("..serve.pool", "pool_selftest"),
                   setup_budget=0),
        EntryPoint("serve.batcher", "serve", "host",
                   _build_serve_batcher, setup_budget=0),
        EntryPoint("cluster.balancer_round", "cluster", dev,
                   _cluster_rule_builder("REPLICATED_POOL"),
                   setup_budget=1, sync_ok=_CRUSH_SYNC),
        EntryPoint("cluster.storm_reeval", "cluster", dev,
                   _cluster_rule_builder("EC_POOL"), setup_budget=1,
                   sync_ok=_CRUSH_SYNC),
        EntryPoint("cluster.rateless_dispatch", "cluster", dev,
                   _build_cluster_rateless_dispatch),
        EntryPoint("scenario.runner", "scenario", "host",
                   _host_builder("..scenario.runner",
                                 "scenario_selftest"), setup_budget=0),
        EntryPoint("scenario.qos", "scenario", "host",
                   _host_builder("..scenario.qos", "qos_selftest"),
                   setup_budget=0),
        EntryPoint("scenario.week", "scenario", "host",
                   _host_builder("..scenario.week", "week_selftest"),
                   setup_budget=0),
        EntryPoint("ops.supervisor", "ops", "host",
                   _host_builder("..ops.supervisor",
                                 "supervisor_selftest"), setup_budget=0),
        EntryPoint("chaos.host_plane", "chaos", "host",
                   _host_builder("..chaos.hosts", "host_chaos_selftest"),
                   setup_budget=0),
        EntryPoint("engine.fused_repair_supervised", "engine", dev,
                   _build_fused_repair_supervised),
        EntryPoint("tune.sweep", "tune", "host",
                   _host_builder("..tune.sweep", "tune_sweep_selftest"),
                   setup_budget=0),
    ]
    return tuple(entries)


def registry_names() -> List[str]:
    return [e.name for e in registry()]


def registry_gaps() -> List[str]:
    """Public plugin device surfaces missing from the registry — the
    completeness gate (a new ``*_chunks*_torch`` surface on any
    family's representative class must be declared here to ship)."""
    registered = {e.name for e in registry()}
    gaps: List[str] = []
    for family in REPRESENTATIVE_PROFILES:
        ec = representative_instance(family)
        for surface in PLUGIN_SURFACES:
            if callable(getattr(type(ec), surface, None)) \
                    and f"{family}.{SURFACE_NAMES[surface]}" \
                    not in registered:
                gaps.append(f"{family}.{surface}")
    return gaps


__all__ = ["B", "Built", "C", "EntryPoint", "FAMILIES",
           "PLUGIN_SURFACES", "R", "REPRESENTATIVE_PROFILES",
           "SURFACE_NAMES", "registry", "registry_gaps",
           "registry_names", "representative_instance", "seeded"]
