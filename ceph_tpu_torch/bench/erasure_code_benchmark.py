"""ErasureCodeBench — the metric source, CLI-compatible with the reference.

A port of ``ceph_tpu/bench/erasure_code_benchmark.py``, which mirrors
src/test/erasure-code/ceph_erasure_code_benchmark.{h,cc} -> class
ErasureCodeBench:

- setup(): the flags --plugin/-p, --workload/-w, --iterations/-i,
  --size/-s, --parameter/-P (repeated k=v into the ErasureCodeProfile),
  --erasures/-e, --erasures-generation/-E random|exhaustive, --erased
  (repeated chunk ids), --verbose/-v, with the reference's defaults.
- run() -> encode() | decode() | degraded() | repair_batched() |
  recovery_churn() | device_chaos() | serving(); prints
  "<elapsed seconds>\\t<total KiB processed>" as the reference does (or
  the row, with --json).

Batching extensions, as in the reference:

- --batch B        B stripes of --size bytes per call.
- --device host|cuda|cpu
                   host = the numpy region ops, pinned
                   (``min_xla_bytes = inf``; the CPU baseline);
                   cuda = the codes' ``*_torch`` paths on the card, the
                   hand-written kernels (default; ``NoDeviceError``
                   without a card); cpu = the same paths on CPU tensors,
                   the plain torch tier, which the caller asks for (the
                   counterpart of the reference's ``jax`` on a CPU
                   backend).
- --resident       keep the data on the device across iterations: the
                   samples time enqueue, one barrier at the end.  Without
                   it every iteration copies the batch in and the parity
                   out, so the number includes the host link.
- --loop N         N chained steps over S distinct slabs made before the
                   clock starts (``build_chain``), one warm run first,
                   ``torch.cuda.synchronize()`` as the completion barrier.
                   The chain is eager Python: nothing eliminates a step,
                   so ``--chain slice`` runs the full op on every step for
                   every code (the reference refuses slice where XLA
                   could narrow the op; here there is nothing to refuse).

The recovery path, as in the reference: ``degraded`` (per-object
scrub → repair through the stripe layer), ``repair-batched`` (one
fused decode → re-encode call per erasure pattern on the run's device;
``--device host`` pins the grouped host path) and ``recovery-churn``
(the epoch-fenced orchestrator under a seeded MapChurn).

``device-chaos`` (the supervised dispatch plane, ``ops/supervisor.py``)
runs the batched recovery while a seeded fault script fires at the
fused-repair seam: a transient error, an out-of-memory error, then a
lost backend for two calls; ``--device host`` supervises the grouped
host repair at a bench seam instead.

``multichip`` (the data plane, ``parallel/``) times the serving encode
seam's mesh variant over every visible member against the
single-device call it must equal; ``host-chaos`` runs the batched
recovery on a plane of ``--hosts`` fault domains while a seeded
HostLoss takes the last one out, and the supervisor halves the hosts,
reclaims the in-flight work and re-promotes.  ``--device host`` runs
both at width 1 (no plane: the host region ops, and a loss that demotes
to the numpy twin).

``profile`` (the program profiler, ``telemetry/profiler.py``) drives
the engine's serve encode, serve decode and fused repair on the run's
device and reports the profiler's attribution rows (analytic cost,
CUDA-event times on the card); ``--device host`` runs the numpy batch
surfaces with the analytic cost.  ``autotune`` (``tune/``) runs the
timed sweep on the run's device, or the analytic sweep with ``--device
host``.  ``--tune-table FILE`` installs a best-config table before the
workload; every row reports ``config_source`` and ``tune_key_hash``.

``cluster`` (``cluster/``) builds a seeded synthetic cluster whose
bulk CRUSH evaluation runs on the run's device, fires a churn storm
through the incremental path, balances it and heals damaged objects
by rateless first-k recovery under a straggler; ``--device host`` runs
the host mapper at a downscaled size.  ``scenario`` (``scenario/``)
serves the canonical client stream on the real clock while churn,
recovery and scrub interleave under the mClock arbiter; ``tenant-week``
runs the simulated multi-tenant week and its isolation gate.  Both run
on the run's device (``--device host``: the host executor).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..codes.registry import ErasureCodePluginRegistry
from ..telemetry import LatencyHistogram

# device-chaos and host-chaos on the card: passes a run may re-queue
# after a failure the supervisor raises (the scripts' losses fire on two
# calls)
_CARD_PASSES = 4

def _xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ^ b on tensors of one integer dtype; uint32 through an int32
    view, which every backend can XOR."""
    if a.dtype == torch.uint32:
        return (a.view(torch.int32) ^ b.view(torch.int32)).view(torch.uint32)
    return a ^ b


def build_chain(op, chain: str, packed: bool, full_init_of, reps: int):
    """The ONE chained harness shared by the encode path, the decode
    path and the roofline tool's kernel/harness probes (so the roofline
    numbers and the bench numbers are the same computation by
    construction).

    op: slab -> output (encode or decode step).
    chain='carry': XOR-fold full outputs into the carry
    (full_init_of(slabs) supplies the zero carry) — adds 3 output-sized
    memory streams per step.  chain='slice': carry one element (outputs
    4-dim when packed, 3-dim otherwise), so the chain's traffic is the
    op's own read + write.

    The reference scans the slabs inside one jitted program; here the
    chain is a Python loop with the carry a tensor.  PyTorch runs
    eagerly, so nothing eliminates dead work: the slice chain runs the
    full op on every step.

    Returns ``chained(slabs)``: ``reps`` passes over the leading axis of
    ``slabs``, each step ``carry ^= f(op(slab))``; returns the carry."""
    if chain not in ("slice", "carry"):
        raise ValueError(f"chain {chain!r} must be slice or carry")

    def chained(slabs: torch.Tensor) -> torch.Tensor:
        if chain == "slice":
            carry = torch.zeros((), dtype=slabs.dtype, device=slabs.device)
        else:
            carry = full_init_of(slabs)
        for _ in range(reps):
            for slab in slabs:
                out = op(slab)
                if chain == "slice":
                    out = (out[:1, :1, :1, :1] if packed
                           else out[:1, :1, :1]).reshape(())
                carry = _xor(carry, out)
        return carry

    return chained


class _LatTimer:
    """Per-call latency recorder for the timed benchmark loops: wraps
    each timed call in a perf_counter pair feeding a log-bucketed
    histogram, so every workload row reports p50/p99/p999 beside its
    GB/s.  One sample = one timed call — a stripe batch for the
    iteration loops, the whole chain for --loop mode."""

    def __init__(self) -> None:
        self.hist = LatencyHistogram()

    def run(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.hist.record(time.perf_counter() - t0)
        return out

    def record(self, seconds: float) -> None:
        self.hist.record(seconds)


def _parse_parameters(params: List[str]) -> Dict[str, str]:
    profile: Dict[str, str] = {}
    for p in params:
        if "=" not in p:
            raise ValueError(f"--parameter {p!r} must be name=value")
        name, value = p.split("=", 1)
        profile[name] = value
    return profile


def _sync(dev: torch.device) -> None:
    """The completion barrier: every launch on the card has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _xor_iota(staged: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) + staged.shape slabs, slab i = staged ^ i (elementwise, in
    the staged dtype: uint8 bytes, or uint32 words through int32)."""
    if staged.dtype == torch.uint32:
        iota = torch.arange(n, dtype=torch.int32, device=staged.device)
        iota = iota.reshape((n,) + (1,) * staged.dim())
        return (staged.view(torch.int32)[None] ^ iota).view(torch.uint32)
    iota = torch.arange(n, dtype=torch.uint8, device=staged.device)
    return staged[None] ^ iota.reshape((n,) + (1,) * staged.dim())


class ErasureCodeBench:
    """The benchmark (ceph_erasure_code_benchmark.cc -> ErasureCodeBench)."""

    def __init__(self) -> None:
        self.args = None
        self.profile: Dict[str, str] = {}
        # the serving workload's ServingRun; the recovery workloads'
        # RecoveryRun (the objects, their HashInfos and the stores
        # each timed pass healed)
        self.last_run = None

    # -- setup (ceph_erasure_code_benchmark.cc -> ErasureCodeBench::setup) --

    def setup(self, argv: List[str]) -> None:
        ap = argparse.ArgumentParser(
            prog="ceph_erasure_code_benchmark",
            description="erasure code benchmark (reference-CLI-compatible)")
        ap.add_argument("-p", "--plugin", default="jerasure",
                        help="erasure code plugin name")
        ap.add_argument("-w", "--workload", default="encode",
                        choices=["encode", "decode", "degraded",
                                 "repair-batched", "recovery-churn",
                                 "serving", "multichip", "cluster",
                                 "profile", "scenario",
                                 "tenant-week",
                                 "device-chaos", "host-chaos",
                                 "autotune"])
        ap.add_argument("-i", "--iterations", type=int, default=1)
        ap.add_argument("-s", "--size", type=int, default=1 << 20,
                        help="object size (bytes) per stripe")
        ap.add_argument("-P", "--parameter", action="append", default=[],
                        help="profile parameter name=value (repeatable)")
        ap.add_argument("-e", "--erasures", type=int, default=1,
                        help="number of chunks to erase "
                             "(decode/degraded workloads)")
        ap.add_argument("--corruptions", type=int, default=0,
                        help="shards to bit-flip per iteration "
                             "(degraded workload: scrub must detect "
                             "them, then repair treats them as "
                             "erasures)")
        ap.add_argument("--churn-every", type=int, default=2,
                        metavar="K",
                        help="recovery-churn workload: a seeded "
                             "MapChurn fires one mark_down/out/"
                             "reweight epoch every K pattern-batch "
                             "dispatches (0 disables churn — the "
                             "still-map control number)")
        ap.add_argument("--requests", type=int, default=256,
                        help="serving workload: requests in the "
                             "seeded mixed stream (the canonical "
                             "rs/shec/clay mix — --plugin/-P do not "
                             "apply to this workload)")
        ap.add_argument("--concurrency", type=int, default=64,
                        help="serving workload: closed-loop in-flight "
                             "window")
        ap.add_argument("--paged", action="store_true",
                        help="serving workload: paged stripe pool + "
                             "ragged kernels — mixed stripe sizes "
                             "co-batch into one device call per "
                             "(plugin, op) pattern")
        ap.add_argument("--page-size", type=int, default=None,
                        help="serving workload (--paged): pool page "
                             "size in bytes (default 512)")
        ap.add_argument("--pool-pages", type=int, default=None,
                        help="serving workload (--paged): pages per "
                             "queue pool (default 64)")
        ap.add_argument("--osds", type=int, default=1000,
                        help="cluster workload: synthetic cluster "
                             "device count (ClusterSpec.sized; "
                             "--device host downscales to keep the "
                             "host mapper's run in seconds)")
        ap.add_argument("--cluster-pgs", type=int, default=1024,
                        help="cluster workload: replicated pool "
                             "pg_num (the EC pool rides at 1/8)")
        ap.add_argument("--storm-events", type=int, default=40,
                        help="cluster workload: MapChurn storm epoch "
                             "budget")
        ap.add_argument("--redundancy", type=int, default=2,
                        help="cluster workload: rateless over-"
                             "planning factor r (1 = no over-"
                             "planning, the straggler-exposed "
                             "control)")
        ap.add_argument("--slow-factor", type=float, default=10.0,
                        help="cluster/scenario workloads: the "
                             "injected straggler's slowdown on "
                             "shard 0")
        ap.add_argument("--no-arbiter", action="store_true",
                        help="scenario workload: disable the mClock "
                             "QoS arbiter (the contention control "
                             "run)")
        ap.add_argument("--tune-table", default=None, metavar="FILE",
                        help="install this best-config table "
                             "(python -m ceph_tpu_torch.tools.autotune "
                             "output) before the workload; rows report "
                             "config_source=tuned")
        ap.add_argument("-E", "--erasures-generation", default="random",
                        choices=["random", "exhaustive"],
                        dest="erasures_generation")
        ap.add_argument("--erased", action="append", type=int, default=None,
                        help="explicit chunk id to erase (repeatable)")
        ap.add_argument("-v", "--verbose", action="store_true")
        # batching extensions
        ap.add_argument("--batch", type=int, default=1,
                        help="stripes per call (batching extension)")
        ap.add_argument("--device", default="cuda",
                        choices=["host", "cuda", "cpu"],
                        help="host: numpy region ops; cuda: the card's "
                             "kernels (default); cpu: the plain torch "
                             "tier on CPU tensors")
        ap.add_argument("--resident", action="store_true",
                        help="keep data on the device across iterations")
        ap.add_argument("--loop", type=int, default=0, metavar="N",
                        help="run N chained steps over distinct slabs "
                             "made before the clock starts; one "
                             "completion barrier at the end")
        ap.add_argument("--layout", default="bytes",
                        choices=["bytes", "packed"],
                        help="device data layout for the --loop encode/"
                             "decode chains: 'packed' keeps stripes as "
                             "uint32 words end to end (the resident "
                             "layout; same bytes; w=8 matrix codes "
                             "only)")
        ap.add_argument("--chain", default="carry",
                        choices=["carry", "slice"],
                        help="--loop chain linkage: 'carry' XOR-folds "
                             "each step's full output into the carry "
                             "(adds 3 output-sized memory streams per "
                             "step); 'slice' carries one element per "
                             "step, so the chain's traffic is the op's "
                             "own read + write (every step still runs "
                             "the full op)")
        ap.add_argument("--json", action="store_true", dest="json_out")
        ap.add_argument("--dump-perf", action="store_true",
                        help="print the perf-counter registry (perf "
                             "dump role) to stderr after the run")
        ap.add_argument("--profile-dir", default=None,
                        help="record a torch.profiler trace here")
        ap.add_argument("--hosts", type=int, default=2,
                        help="host-chaos workload: simulated host fault "
                             "domains the plane spans")
        ap.add_argument("--seed", type=int, default=42)
        self.args = ap.parse_args(argv)
        if self.args.iterations < 1:
            ap.error(f"--iterations {self.args.iterations} must be >= 1")
        if self.args.batch < 1:
            ap.error(f"--batch {self.args.batch} must be >= 1")
        if self.args.requests < 1:
            ap.error(f"--requests {self.args.requests} must be >= 1")
        if self.args.concurrency < 1:
            ap.error(f"--concurrency {self.args.concurrency} "
                     f"must be >= 1")
        if self.args.layout == "packed" and not (
                self.args.loop and self.args.device != "host"):
            ap.error("--layout packed applies to the --loop "
                     "--device cuda|cpu paths only")
        self.profile = _parse_parameters(self.args.parameter)

    # -- helpers ------------------------------------------------------------

    def _device(self) -> torch.device:
        """The torch device of the run: the CPU for host and cpu, the
        card for cuda (``NoDeviceError`` without one)."""
        from ..ops.fallback import resolve_device
        return resolve_device("cuda" if self.args.device == "cuda"
                              else "cpu")

    def _check_packed(self, ec) -> None:
        """--layout packed needs a coherent w=8 packed method pair;
        fail as a clean CLI error before any expensive warmup.  Two
        ways to qualify: the plugin defines its OWN packed method
        (shec's plan decode, clay/lrc's composite paths), or it
        inherits the mixin pair unshadowed (a plugin overriding the
        bytes-layout torch method while inheriting the mixin packed one
        would have the packed path bypass its semantics — rejected)."""
        from ..codes.techniques import MatrixCodeMixin
        attr = ("encode_chunks_packed_torch"
                if self.args.workload == "encode"
                else "decode_chunks_packed_torch")
        base_attr = attr.replace("_packed", "")
        own_packed = (getattr(type(ec), attr, None)
                      is not getattr(MatrixCodeMixin, attr, None))
        mixin_pair = (getattr(type(ec), base_attr, None)
                      is getattr(MatrixCodeMixin, base_attr, None))
        ok = (hasattr(ec, attr)
              and getattr(ec, "w", None) == 8
              and (own_packed or mixin_pair))
        if not ok:
            raise SystemExit(
                f"ceph_erasure_code_benchmark: error: --layout packed "
                f"is not supported by plugin {self.args.plugin!r} with "
                f"this profile (w=8 matrix codes only)")

    @staticmethod
    def _decode_matrix_static(ec, available, pat):
        """The static decode matrix the (available, erased) pattern runs
        (``codes.engine.decode_matrix_static``), None for bitmatrix
        techniques."""
        from ..codes.engine import decode_matrix_static
        return decode_matrix_static(ec, available, pat)

    def _decode_row_meta(self, ec, available, pat, packed: bool) -> dict:
        """Decode-row provenance: which engine tier the decode matrix
        routes to (``gf_kernels.select_matrix_engine``'s names: the
        reference's "xla" is "torch" here, "pallas" is "cuda") and,
        when the XOR-density probe schedules it, the schedule stats
        (length, xor_ops vs dense gf_ops, reduction ratio).  --device
        host rows pin engine="numpy".  Reads the routing table only:
        touches no device."""
        from ..ops.gf_kernels import select_matrix_engine
        from ..ops.xor_schedule import probe_schedule
        device = "cuda" if self.args.device == "cuda" else "cpu"
        override = "numpy" if self.args.device == "host" else None
        w = getattr(ec, "w", 8)
        if w != 8:
            return {"engine": select_matrix_engine(w, device, override),
                    "xor_schedule": None}
        ms = self._decode_matrix_static(ec, available, pat)
        if ms is None:
            return {"engine": None, "xor_schedule": None}
        chunk = ec.get_chunk_size(self.args.size)
        cols = len(ms[0])
        if packed:
            shape = (self.args.batch, cols, max(1, chunk // 512), 128)
        else:
            shape = (self.args.batch, cols, chunk)
        eng = select_matrix_engine(8, device, override, shape=shape,
                                   matrix_t=ms, packed=packed)
        sched = probe_schedule(ms, 8)
        return {"engine": eng,
                "xor_schedule": sched.stats() if sched else None}

    def _instance(self):
        registry = ErasureCodePluginRegistry.instance()
        ec = registry.factory(self.args.plugin, dict(self.profile),
                              device=self._device())
        if self.args.device == "host":
            # pin the numpy reference path: without this, batches over
            # min_xla_bytes would go to the torch tier and the "CPU
            # baseline" would not be the region ops
            ec.min_xla_bytes = float("inf")
        return ec

    def _make_batch(self, ec) -> np.ndarray:
        """(batch, k, chunk_size) uint8 of random stripes."""
        a = self.args
        k = ec.get_data_chunk_count()
        chunk_size = ec.get_chunk_size(a.size)
        rng = np.random.default_rng(a.seed)
        data = rng.integers(0, 256, size=(a.batch, k, chunk_size),
                            dtype=np.uint8)
        return data

    def _loop_shape(self, cap: int) -> tuple:
        """(slabs, passes) of a --loop chain: min(loop, cap) distinct
        slabs, ceil(loop / slabs) passes over them."""
        n_slabs = min(self.args.loop, cap)
        return n_slabs, -(-self.args.loop // n_slabs)

    def _stage(self, ec, host: np.ndarray, packed: bool) -> torch.Tensor:
        """The batch on the run's device, in the chain's layout."""
        if packed:
            self._check_packed(ec)
        staged = torch.from_numpy(host).to(self._device())
        if packed:
            from ..ops.gf_kernels import pack_chunks
            staged = pack_chunks(staged)
        return staged

    def _encode_chain(self, ec, data: np.ndarray):
        """(chained, slabs) of the --loop encode: S = min(loop, 16)
        slabs ``data ^ i`` on the device and the chain over them."""
        a = self.args
        n_slabs, reps = self._loop_shape(16)
        packed = a.layout == "packed"
        slabs = _xor_iota(self._stage(ec, data, packed), n_slabs)
        step = (ec.encode_chunks_packed_torch if packed
                else ec.encode_chunks_torch)
        m_ = ec.get_coding_chunk_count()

        def full_init(slabs):
            return torch.zeros((slabs.shape[1], m_) + slabs.shape[3:],
                               dtype=slabs.dtype, device=slabs.device)

        return build_chain(step, a.chain, packed, full_init, reps), slabs

    def _decode_chain(self, ec, allchunks: np.ndarray, available: tuple,
                      pat: tuple):
        """(chained, slabs) of the --loop decode: S = min(loop, 8) slabs
        ``(allchunks ^ i)[:, available]`` and the chain of decodes of
        the one pattern over them."""
        a = self.args
        n_slabs, reps = self._loop_shape(8)
        packed = a.layout == "packed"
        full = _xor_iota(self._stage(ec, allchunks, packed), n_slabs)
        idx = torch.tensor(available, device=full.device)
        if packed:
            # torch indexes no uint32 tensor on the card: an int32 view
            slabs = full.view(torch.int32).index_select(2, idx).view(
                torch.uint32)
            step = ec.decode_chunks_packed_torch
        else:
            slabs = full.index_select(2, idx)
            step = ec.decode_chunks_torch

        def full_init(slabs):
            return torch.zeros((allchunks.shape[0], len(pat))
                               + slabs.shape[3:], dtype=slabs.dtype,
                               device=slabs.device)

        chained = build_chain(lambda slab: step(slab, available, pat),
                              a.chain, packed, full_init, reps)
        return chained, slabs

    def _time_chain(self, chained, slabs, lat: _LatTimer) -> float:
        """One warm run, then the timed one up to the completion
        barrier; seconds."""
        dev = slabs.device
        chained(slabs)
        _sync(dev)
        begin = time.perf_counter()
        chained(slabs)
        _sync(dev)
        elapsed = time.perf_counter() - begin
        lat.record(elapsed)  # --loop is ONE timed chain
        return elapsed

    # -- encode (ceph_erasure_code_benchmark.cc -> encode()) ---------------

    def encode(self) -> dict:
        a = self.args
        ec = self._instance()
        data = self._make_batch(ec)
        in_bytes_per_iter = data.nbytes  # batch * k * chunk_size
        lat = _LatTimer()

        if a.device == "host":
            ec.encode_chunks_batch(data)  # warm caches
            begin = time.perf_counter()
            for _ in range(a.iterations):
                lat.run(lambda: ec.encode_chunks_batch(data))
            elapsed = time.perf_counter() - begin
        elif a.loop:
            chained, slabs = self._encode_chain(ec, data)
            elapsed = self._time_chain(chained, slabs, lat)
            n_slabs, reps = self._loop_shape(16)
            total_bytes = in_bytes_per_iter * n_slabs * reps
            return self._result("encode", elapsed, total_bytes, lat)
        elif a.resident:
            dev = self._device()
            dev_data = torch.from_numpy(data).to(dev)
            ec.encode_chunks_torch(dev_data)  # warmup
            _sync(dev)
            begin = time.perf_counter()
            for _ in range(a.iterations):
                # per-iteration samples are ENQUEUE latency here (the
                # completion barrier is one synchronize at the end)
                lat.run(lambda: ec.encode_chunks_torch(dev_data))
            _sync(dev)
            elapsed = time.perf_counter() - begin
        else:
            dev = self._device()

            def run():
                d = torch.from_numpy(data).to(dev)
                return ec.encode_chunks_torch(d).cpu().numpy()
            run()  # warmup outside the timed loop
            begin = time.perf_counter()
            for _ in range(a.iterations):
                lat.run(run)
            elapsed = time.perf_counter() - begin
        total_bytes = in_bytes_per_iter * a.iterations
        return self._result("encode", elapsed, total_bytes, lat)

    # -- decode (ceph_erasure_code_benchmark.cc -> decode()) ---------------

    def _erasure_patterns(self, ec, n: int) -> List[tuple]:
        """Sequence of erased-chunk tuples, one per iteration.

        Mirrors the reference: --erased pins an explicit set; exhaustive
        cycles all C(n, erasures) combinations; random draws per
        iteration (``default_rng(seed + 1)``).  Patterns the code cannot
        decode (possible for non-MDS codes like lrc/shec) are skipped,
        like the reference's decode() error-continue."""
        a = self.args

        def decodable(pat: tuple) -> bool:
            try:
                ec.minimum_to_decode(set(pat),
                                     set(range(n)) - set(pat))
                return True
            except IOError:
                return False

        if a.erasures > n:
            raise ValueError(
                f"--erasures {a.erasures} exceeds chunk count {n}")
        if a.erased:
            return [tuple(sorted(a.erased))] * a.iterations
        if a.erasures_generation == "exhaustive":
            combos = [c for c in
                      itertools.combinations(range(n), a.erasures)
                      if decodable(c)]
            if not combos:
                raise ValueError(
                    f"no decodable {a.erasures}-erasure pattern")
            reps = (a.iterations + len(combos) - 1) // len(combos)
            return (combos * reps)[:a.iterations]
        rng = np.random.default_rng(a.seed + 1)
        out: List[tuple] = []
        attempts = 0
        while len(out) < a.iterations:
            pat = tuple(sorted(rng.choice(n, size=a.erasures,
                                          replace=False)))
            attempts += 1
            if decodable(pat):
                out.append(pat)
            elif attempts > 100 * a.iterations:
                raise ValueError(
                    f"could not draw decodable {a.erasures}-erasure "
                    f"patterns")
        return out

    def _place_chunks(self, ec, data: np.ndarray,
                      parity: np.ndarray) -> np.ndarray:
        """(B, n, C) with data at get_chunk_mapping() positions (lrc
        scatters data; every other plugin is identity)."""
        n = ec.get_chunk_count()
        mapping = ec.get_chunk_mapping()
        data_pos = list(mapping) if mapping else list(range(data.shape[1]))
        parity_pos = [p for p in range(n) if p not in set(data_pos)]
        allchunks = np.empty((data.shape[0], n, data.shape[2]), np.uint8)
        allchunks[:, data_pos] = data
        allchunks[:, parity_pos] = parity
        return allchunks

    def _decode_setup(self):
        """(ec, data, allchunks, patterns) of a decode run."""
        ec = self._instance()
        n = ec.get_chunk_count()
        data = self._make_batch(ec)
        parity = np.asarray(ec.encode_chunks_batch(data))
        allchunks = self._place_chunks(ec, data, parity)
        return ec, data, allchunks, self._erasure_patterns(ec, n)

    def decode(self) -> dict:
        a = self.args
        ec, data, allchunks, patterns = self._decode_setup()
        n = ec.get_chunk_count()
        lat = _LatTimer()

        def avail(pat):
            return tuple(i for i in range(n) if i not in pat)

        if a.device != "host" and a.loop:
            # device decode throughput: N chained decodes of one fixed
            # erasure pattern (mirror of the encode --loop mode)
            pat = patterns[0]
            available = avail(pat)
            chained, slabs = self._decode_chain(ec, allchunks, available,
                                                pat)
            elapsed = self._time_chain(chained, slabs, lat)
            n_slabs, reps = self._loop_shape(8)
            total_bytes = data.nbytes * n_slabs * reps
            res = self._result("decode", elapsed, total_bytes, lat)
            res.update(self._decode_row_meta(ec, available, pat,
                                             a.layout == "packed"))
            return res
        if a.device != "host":
            dev = self._device()
            staged = torch.from_numpy(allchunks).to(dev)

            def run(pat):
                idx = torch.tensor(avail(pat), device=dev)
                return ec.decode_chunks_torch(staged.index_select(1, idx),
                                              avail(pat), pat)
            for pat in sorted(set(patterns)):
                run(pat)  # warm every distinct pattern
            _sync(dev)
            begin = time.perf_counter()
            for pat in patterns:
                # per-pattern samples are enqueue latency (one
                # synchronize at the end)
                lat.run(lambda: run(pat))
            _sync(dev)
            elapsed = time.perf_counter() - begin
        else:
            for pat in sorted(set(patterns)):  # warm decode-matrix caches
                ec.decode_chunks_batch(
                    np.ascontiguousarray(allchunks[:, avail(pat), :]),
                    avail(pat), pat)
            begin = time.perf_counter()
            for pat in patterns:
                survivors = np.ascontiguousarray(allchunks[:, avail(pat), :])
                lat.run(lambda: ec.decode_chunks_batch(
                    survivors, avail(pat), pat))
            elapsed = time.perf_counter() - begin
        total_bytes = data.nbytes * a.iterations
        res = self._result("decode", elapsed, total_bytes, lat)
        res.update(self._decode_row_meta(ec, avail(patterns[0]),
                                         patterns[0], packed=False))
        return res

    # -- output -------------------------------------------------------------

    def _topology(self) -> dict:
        """Which hardware ran this number: ``platform`` "gpu" for
        --device cuda, "cpu" for --device cpu, null for the host
        region ops; ``mesh_shape`` the active data plane's [dp, tp]
        (parallel/plane.py), null without one."""
        if self.args.device == "host":
            return {"platform": None, "device_count": 0,
                    "mesh_shape": None}
        from ..parallel.plane import plane_topology
        if self.args.device == "cuda":
            return {"platform": "gpu",
                    "device_count": torch.cuda.device_count(),
                    "mesh_shape": plane_topology()}
        return {"platform": "cpu", "device_count": 1,
                "mesh_shape": plane_topology()}

    def _result(self, workload: str, elapsed: float, total_bytes: int,
                lat: "_LatTimer | None" = None) -> dict:
        gbps = total_bytes / elapsed / 1e9 if elapsed > 0 else float("inf")
        # every row says which config regime produced it (the tuned
        # best-config table or the hand-picked defaults) and the table's
        # content hash (tune/table.py)
        from ..tune.table import active_source
        config_source, tune_key_hash = active_source()
        res = {
            "workload": workload,
            "plugin": self.args.plugin,
            "profile": dict(self.profile),
            "seconds": elapsed,
            "total_bytes": total_bytes,
            "batch": self.args.batch,
            "iterations": self.args.iterations,
            "size": self.args.size,
            "device": self.args.device,
            "layout": self.args.layout,
            "chain": self.args.chain,
            "loop": self.args.loop,
            "gbps": gbps,
            "config_source": config_source,
            "tune_key_hash": tune_key_hash,
            **self._topology(),
        }
        if lat is not None and lat.hist.count:
            pcts = lat.hist.percentiles()
            res["lat_p50_ms"] = pcts["p50"] * 1e3
            res["lat_p99_ms"] = pcts["p99"] * 1e3
            res["lat_p999_ms"] = pcts["p999"] * 1e3
            res["lat_samples"] = lat.hist.count
        return res

    def run(self) -> dict:
        from ..utils.perf import global_perf, profile_trace
        if self.args.tune_table:
            # install the persisted best-config table BEFORE the
            # workload builds anything (the consultation seams read it);
            # it stays installed for the process
            from ..tune.table import BestConfigTable, install_table
            install_table(BestConfigTable.load(self.args.tune_table))
        with profile_trace(self.args.profile_dir):
            res = self._run_workload()
        if self.args.dump_perf:
            print(json.dumps(global_perf().dump()), file=sys.stderr)
        return res

    def _run_traced(self, run_fn):
        """Run one serving measurement under a fresh causal-tracing
        collector (telemetry/tracing.py) and return ``(result,
        tail_attribution)``: the per-segment share of p99 time across
        all op classes (telemetry/analyzer.py::tail_shares).  The
        previous collector (if any) is restored."""
        from ..telemetry import analyzer, tracing
        coll = tracing.TraceCollector(seed=self.args.seed)
        prev = tracing.install(coll)
        try:
            out = run_fn()
        finally:
            tracing.install(prev)
        rows = analyzer.decompose_all(coll.to_dict())
        return out, analyzer.tail_shares(rows, "p99")

    # -- the recovery path (no reference analogue in upstream's tool:
    # the scrub → repair loop timed as a workload) ---------------------

    def _recovery_setup(self, ec):
        """(sinfo, objects, hinfos, pool) of the batched recovery
        workloads: --batch seeded objects of --size logical bytes,
        encoded through the stripe layer, and a small pool of
        (erased, flipped) fault patterns cycled across them, so the
        sweep exercises the grouping (a few patterns, many objects)."""
        from ..codes.stripe import HashInfo, StripeInfo
        from ..codes.stripe import encode as stripe_encode
        a = self.args
        n = ec.get_chunk_count()
        k = ec.get_data_chunk_count()
        chunk_size = ec.get_chunk_size(a.size)
        width = k * chunk_size
        sinfo = StripeInfo(k, width)
        rng = np.random.default_rng(a.seed)
        objects = []
        for _ in range(a.batch):
            obj = rng.integers(0, 256, size=width,
                               dtype=np.uint8).tobytes()
            shards = stripe_encode(sinfo, ec, obj)
            hinfo = HashInfo(n)
            hinfo.append(0, shards)
            objects.append((shards, hinfo))
        hinfos = [h for _, h in objects]
        prng = np.random.default_rng(a.seed + 1)
        n_pat = max(1, min(4, a.batch))
        pool = []
        for _ in range(n_pat):
            victims = prng.choice(n, size=a.erasures + a.corruptions,
                                  replace=False)
            pool.append(([int(v) for v in victims[:a.erasures]],
                         [int(v) for v in victims[a.erasures:]]))
        return sinfo, objects, hinfos, pool

    def _damaged_stores(self, sinfo, objects, pool):
        """One store per object, damaged by its pattern of the pool
        (seeded per object, so every call makes the same stores)."""
        from ..chaos import BitFlip, ShardErasure, inject
        stores = []
        for i, (shards, _) in enumerate(objects):
            erased, flipped = pool[i % len(pool)]
            injectors = []
            if erased:
                injectors.append(ShardErasure(shards=list(erased)))
            if flipped:
                injectors.append(BitFlip(shards=list(flipped), flips=1))
            store, _ = inject(shards, injectors, seed=self.args.seed + i,
                              chunk_size=sinfo.chunk_size)
            stores.append(store)
        return stores

    @staticmethod
    def _repair_on_card(workload: str, sinfo, ec, stores, hinfos):
        """One batched repair of ``stores`` on the card, re-queued on the
        stores as they stand (the objects healed stay healed) each time
        the supervisor raises ``DeviceDispatchError``, as recovery
        re-queues a failed op: the card's work never leaves it."""
        from ..scrub import repair_batched
        from ..utils.errors import DeviceDispatchError
        for _ in range(_CARD_PASSES):
            try:
                return repair_batched(sinfo, ec, stores, hinfos,
                                      device=True)
            except DeviceDispatchError:
                continue
        raise RuntimeError(f"{workload}: no pass completed in "
                           f"{_CARD_PASSES}")

    def _check_faults(self, n: int) -> None:
        a = self.args
        if a.erasures < 0 or a.corruptions < 0:
            raise ValueError("--erasures/--corruptions must be >= 0")
        if a.erasures + a.corruptions >= n:
            raise ValueError(
                f"{a.erasures} erasures + {a.corruptions} corruptions "
                f"leave no clean shards of {n}")

    def degraded(self) -> dict:
        """Recovery-path throughput: deep_scrub (vectorized crc verify +
        classify) + repair (decode, re-encode, crc re-verify) of an
        object with --erasures shards erased and --corruptions shards
        bit-flipped.  Fault injection and store setup run OUTSIDE the
        timer; GB/s is logical object bytes / elapsed — the
        client-visible recovery bandwidth.  With -e 0 and no
        corruptions this times the pure deep-scrub verify pass."""
        from ..chaos import BitFlip, ShardErasure, inject
        from ..codes.stripe import HashInfo, StripeInfo
        from ..codes.stripe import encode as stripe_encode
        from ..scrub import repair
        a = self.args
        ec = self._instance()
        n = ec.get_chunk_count()
        k = ec.get_data_chunk_count()
        self._check_faults(n)
        chunk_size = ec.get_chunk_size(a.size)
        width = k * chunk_size
        sinfo = StripeInfo(k, width)
        rng = np.random.default_rng(a.seed)
        obj = rng.integers(0, 256, size=width * a.batch,
                           dtype=np.uint8).tobytes()
        shards = stripe_encode(sinfo, ec, obj)
        hinfo = HashInfo(n)
        hinfo.append(0, shards)

        def make_store(it: int):
            # deterministic per-iteration victim pattern; repair heals
            # the store in place, so every timed pass gets a fresh one
            prng = np.random.default_rng(a.seed + 1000 * it)
            victims = prng.choice(n, size=a.erasures + a.corruptions,
                                  replace=False)
            injectors = []
            erased = [int(v) for v in victims[:a.erasures]]
            flipped = [int(v) for v in victims[a.erasures:]]
            if erased:
                injectors.append(ShardErasure(shards=erased))
            if flipped:
                injectors.append(BitFlip(shards=flipped, flips=1))
            store, _ = inject(shards, injectors, seed=a.seed + it,
                              chunk_size=sinfo.chunk_size)
            return store

        # warm every per-pattern decode-matrix cache outside the timer
        # (mirrors the decode workload's warmup-per-distinct-pattern)
        for it in range(a.iterations):
            repair(sinfo, ec, make_store(it), hinfo)
        stores = [make_store(it) for it in range(a.iterations)]
        lat = _LatTimer()
        begin = time.perf_counter()
        for store in stores:
            lat.run(lambda: repair(sinfo, ec, store, hinfo))
        elapsed = time.perf_counter() - begin
        self.last_run = RecoveryRun(sinfo, ec, [(shards, hinfo)],
                                    [[st] for st in stores])
        res = self._result("degraded", elapsed, len(obj) * a.iterations,
                           lat)
        res["erasures"] = a.erasures
        res["corruptions"] = a.corruptions
        return res

    def repair_batched(self) -> dict:
        """Batched recovery-path throughput: --batch objects of --size
        logical bytes each, --erasures/--corruptions faults per
        object, repaired through repair_batched (deep_scrub host CRC +
        grouped fused repair on the run's device).  GB/s is logical
        object bytes / elapsed; the result carries the pattern-batch
        and device-call counts so every row shows the batching held
        (pattern_batches == device_calls, not one call per object)."""
        from ..scrub import repair_batched
        a = self.args
        ec = self._instance()
        self._check_faults(ec.get_chunk_count())
        sinfo, objects, hinfos, pool = self._recovery_setup(ec)
        # --device host pins the grouped HOST path (_instance() already
        # pinned min_xla_bytes, so the plugin batch calls stay on numpy
        # too); cuda and cpu run the fused call on the code's device
        dev = a.device != "host"
        # warm pattern caches and kernel builds outside the timer
        repair_batched(sinfo, ec, self._damaged_stores(sinfo, objects,
                                                       pool),
                       hinfos, device=dev)
        runs = [self._damaged_stores(sinfo, objects, pool)
                for _ in range(a.iterations)]
        lat = _LatTimer()
        begin = time.perf_counter()
        rep = None
        for stores in runs:
            rep = lat.run(lambda: repair_batched(sinfo, ec, stores,
                                                 hinfos, device=dev))
        elapsed = time.perf_counter() - begin
        self.last_run = RecoveryRun(sinfo, ec, objects, runs, pool)
        res = self._result("repair-batched", elapsed,
                           sinfo.stripe_width * a.batch * a.iterations,
                           lat)
        res["erasures"] = a.erasures
        res["corruptions"] = a.corruptions
        res["pattern_batches"] = rep.pattern_batches
        res["device_calls"] = rep.device_calls
        res["host_batches"] = rep.host_batches
        return res

    def recovery_churn(self) -> dict:
        """Recovery throughput under OSDMap churn: --batch objects of
        --size logical bytes, --erasures/--corruptions faults each,
        driven to durable convergence by the recovery orchestrator
        (epoch fencing + intent journal + throttle) while a seeded
        MapChurn fires one epoch every --churn-every pattern-batch
        dispatches.  GB/s is logical object bytes / elapsed — the
        client-visible recovery bandwidth including every replan,
        regroup and journal pass churn forces; the result carries the
        replan/regroup counters so the fencing overhead is visible
        next to the still-map repair-batched row."""
        from ..chaos import MapChurn
        from ..crush import (CrushBuilder, step_chooseleaf_indep,
                             step_emit, step_take)
        from ..crush.osdmap import OSDMap, PGPool
        from ..recovery import healed, recover_to_completion
        a = self.args
        ec = self._instance()
        n = ec.get_chunk_count()
        if a.erasures < 1 or a.corruptions < 0:
            raise ValueError("recovery-churn needs --erasures >= 1")
        self._check_faults(n)
        sinfo, objects, hinfos, pool = self._recovery_setup(ec)

        def make_cluster():
            b = CrushBuilder()
            root = b.build_two_level(n + 3, 2)
            b.add_rule(0, [step_take(root),
                           step_chooseleaf_indep(n, b.type_id("host")),
                           step_emit()])
            osdmap = OSDMap(crush=b.map, device=str(self._device()))
            osdmap.pools[1] = PGPool(pool_id=1, pg_num=16, size=n,
                                     erasure=True)
            return osdmap

        dev = a.device != "host"
        runs = []

        def run_once(seed_off):
            # fresh map + stores each pass: churn mutates the map, so
            # a reused one would drift across iterations
            churn = (MapChurn(seed=a.seed + seed_off, max_down=1,
                              fire_every=a.churn_every,
                              stages=("dispatch",))
                     if a.churn_every else None)
            stores = self._damaged_stores(sinfo, objects, pool)
            rep = recover_to_completion(
                sinfo, ec, make_cluster(), 1, 9, stores, hinfos,
                churn=churn, device=dev)
            if not rep.converged or rep.unrecoverable:
                raise RuntimeError(
                    f"recovery-churn failed to converge: "
                    f"{rep.to_dict()}")
            if not healed(stores, [s for s, _ in objects]):
                raise RuntimeError("recovery-churn: data loss")
            runs.append(stores)
            return rep

        run_once(1000)                      # warm caches + kernel builds
        runs.clear()
        lat = _LatTimer()
        begin = time.perf_counter()
        rep = None
        for it in range(a.iterations):
            rep = lat.run(lambda: run_once(it))
        elapsed = time.perf_counter() - begin
        self.last_run = RecoveryRun(sinfo, ec, objects, runs, pool, rep)
        res = self._result("recovery-churn", elapsed,
                           sinfo.stripe_width * a.batch * a.iterations,
                           lat)
        res["erasures"] = a.erasures
        res["corruptions"] = a.corruptions
        res["churn_every"] = a.churn_every
        res["epochs_advanced"] = rep.epoch_end - rep.epoch_start
        res["replans"] = rep.replans
        res["regroups"] = rep.regroups
        res["rounds"] = rep.rounds
        res["pattern_batches"] = rep.pattern_batches
        res["device_calls"] = rep.device_calls
        return res

    # -- device-chaos (the supervised dispatch plane under injected
    # device-plane faults: recovery-under-fault throughput) --------------

    def device_chaos(self) -> dict:
        """Recovery throughput while the device plane FAILS mid-run:
        --batch objects of --size logical bytes, --erasures faults
        each, repaired through the batched fused-repair seam while a
        seeded DispatchFault script (transient error, out of memory,
        then a persistent backend loss) fires at the seam's Nth calls.
        The supervisor must retry and split the rung; the loss demotes
        the tier live and completes on the numpy twin for a CPU code,
        and on the card (whose work never leaves it) raises
        ``DeviceDispatchError``, upon which the pass is re-queued on the
        stores as they stand, as recovery re-queues a failed op.
        Byte-identical heal and zero data loss are gated in-workload,
        and the row carries the supervisor's counter deltas.

        ``--device host``: the same loop wraps the grouped host repair
        in the supervisor at a bench seam, so the classification
        machinery (retry, demoted completion) is still measured
        without a device."""
        from ..chaos.dispatch import (DispatchFault, DispatchFaultPlan,
                                      arm_plan)
        from ..ops.supervisor import global_supervisor
        from ..recovery.orchestrator import healed
        from ..scrub import repair_batched
        a = self.args
        ec = self._instance()
        n = ec.get_chunk_count()
        if a.erasures < 1 or a.erasures + a.corruptions >= n:
            raise ValueError("device-chaos needs 1 <= erasures + "
                             "corruptions < n")
        sinfo, objects, hinfos, pool = self._recovery_setup(ec)
        originals = [s for s, _ in objects]
        dev = a.device != "host"
        sup = global_supervisor()
        seam = "engine.fused_repair" if dev else "bench.device_chaos"

        def fault_script():
            # the seeded production-day failure script: a flaky call,
            # an out-of-memory error (device mode — the host seam fires
            # once per repair pass, so its script compresses to retry +
            # loss), then the backend dies for two calls
            if dev:
                faults = [DispatchFault("transient", seam=seam, at=2,
                                        calls=1),
                          DispatchFault("oom", seam=seam, at=3,
                                        calls=1),
                          DispatchFault("backend_loss", seam=seam,
                                        at=5, calls=2)]
            else:
                faults = [DispatchFault("transient", seam=seam, at=1,
                                        calls=1),
                          DispatchFault("backend_loss", seam=seam,
                                        at=2, calls=2)]
            return DispatchFaultPlan(faults, seed=a.seed)

        runs = []

        def run_once():
            stores = self._damaged_stores(sinfo, objects, pool)
            if dev:
                rep = self._repair_on_card("device-chaos", sinfo, ec,
                                           stores, hinfos)
            else:
                def call():
                    return repair_batched(sinfo, ec, stores, hinfos,
                                          device=False)
                rep = sup.dispatch(seam, call, (), host_fn=call,
                                   splittable=False)
            if not healed(stores, originals):
                raise RuntimeError("device-chaos: data loss under "
                                   "injected dispatch faults")
            runs.append(stores)
            return rep

        # warm pattern caches and kernel builds with NO faults armed
        run_once()
        runs.clear()
        before = {key: v for key, v in sup.stats().items()
                  if isinstance(v, int)}
        lat = _LatTimer()
        plans = []
        begin = time.perf_counter()
        for _ in range(a.iterations):
            plan = fault_script()
            prev = arm_plan(plan)
            try:
                lat.run(run_once)
                plan.clear()
                # drive the health probe to re-promotion so every
                # iteration starts from the healthy tier
                for _ in range(sup.promote_after + 2):
                    sup.tick()
            finally:
                arm_plan(prev)
            plans.append(plan.summary())
        elapsed = time.perf_counter() - begin
        after = sup.stats()
        self.last_run = RecoveryRun(sinfo, ec, objects, runs, pool)
        res = self._result("device-chaos", elapsed,
                           sinfo.stripe_width * a.batch * a.iterations,
                           lat)
        res["erasures"] = a.erasures
        res["supervisor"] = {
            key: after[key] - before.get(key, 0)
            for key in ("retries", "rung_downshifts", "demotions",
                        "quarantines", "card_failures", "repromotions",
                        "host_completions", "hangs",
                        "verify_failures")}
        res["faults_fired"] = sum(p["fired"] for p in plans)
        res["demoted_at_end"] = after["demoted"]
        res["verified"] = True
        return res

    # -- multichip (the data plane: encode fanned out across the plane's
    # members through the engine's mesh variant) ------------------------

    def multichip(self) -> dict:
        """Mesh-sharded encode throughput: --batch stripes of --size
        bytes through the serving encode seam's mesh variant
        (serve_dispatch_call under a plane over every visible member:
        the stripe batch cut into equal member shards, one supervised
        dispatch per call).  The output is checked byte for byte
        against the single-device call before timing, and the row
        carries the mesh shape, the member partition and
        ``physical_devices`` (the distinct devices among the members: a
        row over virtual members of one card labels itself).  With one
        member the plane degrades and the row IS the single-device
        number, labelled as such; ``--device host`` is that width-1 row
        on the host region ops."""
        from ..codes.engine import serve_dispatch_call
        from ..parallel.plane import mesh_plane, plane_topology
        from ..utils.shard import last_partition
        a = self.args
        ec = self._instance()
        data = self._make_batch(ec)
        lat = _LatTimer()
        if a.device == "host":
            ec.encode_chunks_batch(data)  # warm caches
            begin = time.perf_counter()
            for _ in range(a.iterations):
                lat.run(lambda: ec.encode_chunks_batch(data))
            elapsed = time.perf_counter() - begin
            res = self._result("multichip", elapsed,
                               data.nbytes * a.iterations, lat)
            res.update(n_devices=1, physical_devices=1,
                       stripes_per_device=[a.batch], verified=True)
            return res
        dev = self._device()
        staged = torch.from_numpy(data).to(dev)
        # the single-device call OUTSIDE the plane: the bytes to equal
        ref = serve_dispatch_call(ec, "encode", mesh=False)(staged)
        with mesh_plane(kind=dev.type) as plane:
            fn = serve_dispatch_call(ec, "encode")
            out = fn(staged)  # warmup
            if not torch.equal(out, ref):
                raise RuntimeError(
                    "multichip: sharded encode diverged from the "
                    "single-device engine")
            shards = last_partition() if plane is not None else [a.batch]
            _sync(dev)
            begin = time.perf_counter()
            for _ in range(a.iterations):
                out = lat.run(lambda: fn(staged))
            _sync(dev)
            elapsed = time.perf_counter() - begin
            res = self._result("multichip", elapsed,
                               data.nbytes * a.iterations, lat)
            res["mesh_shape"] = plane_topology(plane)
        res["n_devices"] = plane.n_devices if plane is not None else 1
        res["physical_devices"] = (len(set(plane.members))
                                   if plane is not None else 1)
        res["stripes_per_device"] = shards
        res["verified"] = True
        return res

    # -- host-chaos (a whole host fault domain drops mid-repair:
    # recovery-under-host-loss throughput) ------------------------------

    def host_chaos(self) -> dict:
        """Recovery throughput while a whole HOST fault domain fails
        mid-run: the batched fused-repair stream of device-chaos, on a
        plane of ``--hosts`` simulated fault domains over the visible
        members, while a seeded HostLoss (chaos/hosts.py) takes the last
        domain out at the seam's 2nd call for two calls.  The supervisor
        classifies ``host_loss``, halves the hosts (the survivor keeps
        its members, the work stays on the card), runs the journal
        reclaim hook, completes the batch and re-promotes to the full
        host width once the plan clears; zero data loss and the heal
        byte for byte are gated in-workload, and the row carries the
        supervisor's counter deltas.  Where no plane of two or more
        hosts forms on the card (one card, no virtual members), the
        process is its one fault domain: losing host 0 raises
        ``DeviceDispatchError`` and the pass is re-queued, as
        device-chaos does.

        ``--device host``: no plane forms, so the process is its one
        fault domain — losing host 0 demotes straight to the
        ground-truth twin (the width-1 ladder) at a bench seam around
        the grouped host repair."""
        from ..chaos.hosts import HostFaultPlan, HostLoss, arm_host_plan
        from ..ops.supervisor import global_supervisor
        from ..parallel import plane as planemod
        from ..recovery.orchestrator import healed
        from ..scrub import repair_batched
        a = self.args
        ec = self._instance()
        n = ec.get_chunk_count()
        if a.erasures < 1 or a.erasures + a.corruptions >= n:
            raise ValueError("host-chaos needs 1 <= erasures + "
                             "corruptions < n")
        sinfo, objects, hinfos, pool = self._recovery_setup(ec)
        originals = [s for s, _ in objects]
        dev = a.device != "host"
        sup = global_supervisor()
        seam = "engine.fused_repair" if dev else "bench.host_chaos"
        prev_plane = None
        plane = None
        if dev:
            prev_plane = planemod.data_plane()
            plane = planemod.activate(None, hosts=max(2, a.hosts),
                                      kind=self._device().type)
        hosts0 = plane.hosts if plane is not None else 1
        # the victim: the LAST host domain (host 0 when no plane can
        # form: the process itself is the one fault domain)
        lost = hosts0 - 1 if hosts0 > 1 else 0
        reclaims: List[str] = []
        prev_reclaim = sup.set_inflight_reclaim(
            lambda s: reclaims.append(s) or 0)

        def fault_script():
            return HostFaultPlan(
                [HostLoss(lost, seam=seam, at=(2 if dev else 1),
                          calls=2)],
                seed=a.seed)

        runs = []

        def run_once():
            stores = self._damaged_stores(sinfo, objects, pool)
            if dev:
                rep = self._repair_on_card("host-chaos", sinfo, ec,
                                           stores, hinfos)
            else:
                def call():
                    return repair_batched(sinfo, ec, stores, hinfos,
                                          device=False)
                rep = sup.dispatch(seam, call, (), host_fn=call,
                                   splittable=False)
            if not healed(stores, originals):
                raise RuntimeError("host-chaos: data loss under "
                                   "injected host loss")
            runs.append(stores)
            return rep

        try:
            # warm pattern caches and kernel builds with NO faults armed
            run_once()
            runs.clear()
            before = {key: v for key, v in sup.stats().items()
                      if isinstance(v, int)}
            lat = _LatTimer()
            plans = []
            begin = time.perf_counter()
            for _ in range(a.iterations):
                plan = fault_script()
                prev = arm_host_plan(plan)
                try:
                    lat.run(run_once)
                    plan.clear()
                    # drive the health probe to re-promotion so every
                    # iteration starts at full host width
                    for _ in range(sup.promote_after + 2):
                        sup.tick()
                finally:
                    arm_host_plan(prev)
                plans.append(plan.summary())
            elapsed = time.perf_counter() - begin
            after = sup.stats()
        finally:
            sup.set_inflight_reclaim(prev_reclaim)
            if dev:
                planemod.set_data_plane(prev_plane)
        self.last_run = RecoveryRun(sinfo, ec, objects, runs, pool)
        res = self._result("host-chaos", elapsed,
                           sinfo.stripe_width * a.batch * a.iterations,
                           lat)
        res["erasures"] = a.erasures
        res["hosts"] = hosts0
        res["supervisor"] = {
            key: after[key] - before.get(key, 0)
            for key in ("host_quarantines", "host_repromotions",
                        "journal_redispatches", "retries",
                        "demotions", "quarantines", "repromotions",
                        "host_completions", "card_failures")}
        res["faults_fired"] = sum(p["fired"] for p in plans)
        res["reclaim_calls"] = len(reclaims)
        res["demoted_at_end"] = after["demoted"]
        res["verified"] = True
        return res

    # -- serving (the continuous-batching front end: a seeded mixed
    # request stream through serve/) -------------------------------------

    def serving(self) -> dict:
        """Tail-latency serving numbers: the canonical mixed
        rs/shec/clay stream (serve.loadgen.default_spec, seeded by
        --seed) driven closed-loop through the admission queue and the
        continuous batcher on the REAL clock.  The row reports
        GB/s-under-SLO (only bytes of requests that met their
        deadline), request-latency p50/p99/p999, deadline-miss rate
        and padding overhead.  The stream is byte-verified against the
        generator's ground truth and, on the device executor, carries
        the kernel setups after warmup (``stream_compiles``, 0 on a warm
        stream)."""
        from ..serve import (default_spec, run_serving_scenario,
                             verify_results)
        a = self.args
        executor = "host" if a.device == "host" else "device"
        spec = default_spec(seed=a.seed, n_requests=a.requests,
                            stripe_size=a.size, erasures=a.erasures,
                            arrival="closed")
        spec.concurrency = a.concurrency
        if a.paged:
            spec.paged = True
            spec.page_size = a.page_size
            spec.pool_pages = a.pool_pages
        device = self._device()
        run, tail = self._run_traced(
            lambda: run_serving_scenario(spec, executor=executor,
                                         device=device))
        self.last_run = run
        bad = verify_results(run.results)
        if bad:
            raise RuntimeError(
                f"serving stream corrupted: {len(bad)} request(s) "
                f"differ from ground truth (ids {bad[:8]})")
        rep = run.report
        res = self._result("serving", rep["elapsed_s"], rep["bytes"])
        res["lat_p50_ms"] = rep["p50_ms"]
        res["lat_p99_ms"] = rep["p99_ms"]
        res["lat_p999_ms"] = rep["p999_ms"]
        res["lat_samples"] = rep["requests"]
        res["gbps_under_slo"] = rep["gbps_under_slo"]
        res["deadline_miss_rate"] = rep["deadline_miss_rate"]
        res["padding_overhead"] = rep["padding"]["padding_overhead"]
        res["paged"] = bool(rep["padding"].get("paged", False))
        res["cached_programs"] = rep["padding"].get("cached_programs")
        if res["paged"]:
            # live page-pool occupancy + lifetime accounting: after a
            # clean drain used_pages must be 0 and allocs == reclaims
            res["page_pool"] = rep["padding"].get("pool")
        res["requests"] = rep["requests"]
        res["rejected"] = rep["rejected"]
        res["dispatches"] = rep["padding"]["dispatches"]
        res["stream_compiles"] = rep.get("stream_compiles")
        res["op_classes"] = rep["op_classes"]
        res["tail_attribution"] = tail
        return res

    # -- profile (the program profiler: per-program cost/roofline
    # attribution for the engine's cached callables) -------------------

    def profile_workload(self) -> dict:
        """Cost/roofline attribution workload: drives the engine's
        cached callables — serve encode, serve decode and the fused
        decode -> re-encode repair — for the configured plugin on the
        run's device, and emits the global profiler's rows for them:
        the analytic cost (bytes, ops), the measured p50/p99 (CUDA
        events on the card), achieved GB/s, the model-bound GB/s at the
        memory roofline, utilization %.  On the card each iteration's
        three calls are queued behind a spin (``profiler.hold_stream``),
        so each event pair reads the card's time for its call, not the
        host's issue; a latency sample is one iteration, completion
        included, and the row's GB/s counts the spins' time too.

        ``--device host`` runs the numpy batch surfaces on a private
        profiler with the analytic matrix model (the XOR schedule's op
        count where the decode pattern runs one), timed on the host
        clock."""
        from ..telemetry import profiler as profmod
        a = self.args
        ec = self._instance()
        n = ec.get_chunk_count()
        m_ = ec.get_coding_chunk_count()
        data = self._make_batch(ec)
        chunk_size = data.shape[2]
        pat = self._erasure_patterns(ec, n)[0]
        available = tuple(i for i in range(n) if i not in pat)
        parity = np.asarray(ec.encode_chunks_batch(data))
        allchunks = self._place_chunks(ec, data, parity)
        survivors = np.ascontiguousarray(
            allchunks[:, np.array(available), :])
        lat = _LatTimer()
        plugin_cls = type(ec).__name__

        if a.device != "host":
            from ..codes.engine import (fused_repair_call,
                                        serve_dispatch_call)
            from ..telemetry import metrics as tel
            if not tel.enabled():
                raise ValueError("-w profile records through telemetry; "
                                 "it is disabled (metrics.set_enabled)")
            dev = self._device()
            prof = profmod.global_profiler()
            enc = serve_dispatch_call(ec, "encode")
            dec = serve_dispatch_call(ec, "decode", available, pat)
            rep = fused_repair_call(ec, available, pat)
            denc = torch.from_numpy(data).to(dev)
            dsurv = torch.from_numpy(survivors).to(dev)
            calls = [lambda: enc(denc), lambda: dec(dsurv),
                     lambda: rep(dsurv)]
            for fn in calls:            # warm: kernel setup + capture
                fn()
            _sync(dev)

            def one_round():
                profmod.hold_stream(dev, len(calls))
                for fn in calls:
                    fn()
                _sync(dev)
            begin = time.perf_counter()
            for _ in range(a.iterations):
                lat.run(one_round)
            elapsed = time.perf_counter() - begin
            total_bytes = (data.nbytes + 2 * survivors.nbytes) \
                * a.iterations
            rows = [r for r in prof.attribution_rows()
                    if r.get("plugin") == plugin_cls
                    and r.get("platform") == dev.type]
        else:
            # host tier: numpy batch surfaces + the analytic cost model
            prof = profmod.ProgramProfiler()
            ops = [
                ("encode", m_, ec.get_data_chunk_count(),
                 lambda: ec.encode_chunks_batch(data)),
                ("decode", len(pat), len(available),
                 lambda: ec.decode_chunks_batch(survivors, available,
                                                pat)),
            ]
            for opname, rows_, cols_, fn in ops:
                key = ("bench.profile", plugin_cls, opname)
                # the analytic model extended to XOR schedules: when the
                # decode matrix the pattern runs is XOR-scheduled, the
                # cost side carries the schedule's op count (and the
                # row says engine="xor")
                cost = profmod.analytic_matrix_cost(
                    a.batch, rows_, cols_, chunk_size)
                host_engine = "host"
                ms = (self._decode_matrix_static(ec, available, pat)
                      if opname == "decode"
                      and getattr(ec, "w", 8) == 8 else None)
                if ms is not None:
                    from ..ops.xor_schedule import preferred_schedule
                    mr, mc = len(ms), len(ms[0])
                    unit = chunk_size // getattr(ec, "sub_chunk_no", 1)
                    sched = preferred_schedule(ms, 8)
                    if sched is not None:
                        cost = profmod.analytic_xor_schedule_cost(
                            a.batch, mr, mc, unit, sched.vpu_ops)
                        host_engine = "xor"
                    else:
                        cost = profmod.analytic_matrix_cost(
                            a.batch, mr, mc, unit)
                prof.capture(
                    key, name=f"host.{opname}", platform="cpu",
                    cost=cost,
                    arg_bytes=a.batch * cols_ * chunk_size,
                    plugin=plugin_cls, kind=f"host-{opname}",
                    pattern="e" + "_".join(map(str, pat)),
                    engine=host_engine, devices=0, batch=a.batch)
                fn()                    # warm caches
            begin = time.perf_counter()
            for _ in range(a.iterations):
                for opname, _r, _c, fn in ops:
                    key = ("bench.profile", plugin_cls, opname)
                    t0 = time.perf_counter()
                    fn()
                    dt = time.perf_counter() - t0
                    lat.record(dt)
                    prof.observe(key, dt)
            elapsed = time.perf_counter() - begin
            total_bytes = (data.nbytes + survivors.nbytes) \
                * a.iterations
            rows = prof.attribution_rows()

        res = self._result("profile", elapsed, total_bytes, lat)
        res["erasures"] = len(pat)
        res["programs"] = len(rows)
        res["profile_rows"] = rows
        return res

    # -- autotune (the config search as a measured workload: tune/ and
    # ceph_tpu_torch/tools/autotune.py) --------------------------------

    def autotune_workload(self) -> dict:
        """Profiler-driven config sweep as a bench row: the timed sweep
        on the run's device (min-of-N device times of every tier it can
        dispatch, byte identity asserted across every candidate), or
        with ``--device host`` the host-only analytic roofline sweep.
        The row carries the tuner's before/after rows, the tuned key
        list, and ``utilization_pct`` (the best tuned program's
        after-utilization)."""
        from ..tune import sweep as tsweep
        a = self.args
        begin = time.perf_counter()
        if a.device != "host":
            rep = tsweep.timed_sweep(
                plugin=a.plugin, profile=self.profile or None,
                size=a.size, batch=a.batch,
                repeats=max(2, a.iterations), seed=a.seed,
                device=self._device())
        else:
            rep = tsweep.analytic_sweep(seed=a.seed)
        elapsed = time.perf_counter() - begin
        # bytes actually priced/measured by the sweep (the attribution
        # rows record arg_bytes x observed calls per program)
        total_bytes = sum(
            int(r["arg_bytes"]) * int(r["calls"] or 1)
            for r in rep.attribution if r.get("arg_bytes"))
        res = self._result("autotune", elapsed, max(1, total_bytes))
        res["mode"] = rep.mode
        res["seed"] = rep.seed
        res["tuned_keys"] = sorted(rep.table.entries)
        res["n_tuned"] = len(rep.table)
        res["rows"] = rep.rows
        res["table"] = rep.table.to_dict()
        utils = [r["after"].get("utilization_pct") for r in rep.rows
                 if isinstance(r.get("after"), dict)
                 and isinstance(r["after"].get("utilization_pct"),
                                (int, float))]
        res["utilization_pct"] = max(utils) if utils else None
        head = rep.headline()
        res["improvement_pct"] = (head or {}).get("improvement_pct")
        res["improved_rows"] = len(rep.improved)
        # the timed sweep asserts byte identity across every candidate
        # tier (a mismatch raises and aborts the row); the analytic
        # sweep dispatches nothing
        res["verified"] = True
        return res

    # -- cluster (the 10k-OSD cluster plane: storm → balance → rateless
    # recover from one seed — cluster/) ---------------------------------

    def cluster(self) -> dict:
        """Cluster-plane numbers: a seeded synthetic cluster (--osds
        devices, ClusterSpec.sized) whose bulk CRUSH evaluation runs on
        the run's device takes a --storm-events MapChurn storm through
        the incremental path (full-cluster remap convergence measured
        per epoch on the bulk evaluator, pinned equivalent to a rebuilt
        map and a catch_up replay), the balancer loop closes to max
        deviation <= 1, and a rateless first-k recovery (--redundancy
        copies across the shards) heals --batch damaged objects with
        the fused repair on the run's device under an injected
        straggler (shard 0 at --slow-factor), byte-verified and
        compared against the same schedule with no straggler — the p99
        ratio IS the straggler-tolerance claim.  --device host runs the
        identical loop over the host mapper at a downscaled size."""
        from ..chaos import MapChurn, ShardErasure, Straggler
        from ..cluster import (ClusterSpec, balance_cluster,
                               build_cluster, rateless_recover,
                               run_churn_storm,
                               verify_storm_equivalence)
        from ..cluster.rateless import plan_assignments, \
            simulate_first_k
        from ..cluster.topology import EC_POOL
        from ..codes.stripe import StripeInfo
        from ..recovery import healed
        from ..scenario.runner import stage_damaged_objects
        a = self.args
        host = a.device == "host"
        # the host engine walks the python mapper per pg per epoch —
        # the downscale keeps the host row in seconds while running
        # the identical loop
        n_osds = min(a.osds, 120) if host else a.osds
        pgs = min(a.cluster_pgs, 128) if host else a.cluster_pgs
        events = min(a.storm_events, 6) if host else a.storm_events
        engine = "host" if host else "bulk"
        measure_every = 2 if host else 1
        spec = ClusterSpec.sized(
            n_osds, seed=a.seed, replicated_pg_num=pgs,
            ec_pg_num=max(32, pgs // 8))
        device = self._device()
        m = build_cluster(spec, device=device)

        ec = self._instance()
        k = ec.get_data_chunk_count()
        chunk_size = ec.get_chunk_size(a.size)
        width = k * chunk_size
        sinfo = StripeInfo(k, width)
        n_objects = max(4, a.batch)
        # one shared erasure pattern (shard 1): one pattern batch, one
        # fused dispatch — and the control sim below can reconstruct
        # the unit work exactly
        objects, stores, hinfos, _ = stage_damaged_objects(
            sinfo, ec, n_objects, seed=a.seed,
            injectors_for=lambda i: [ShardErasure(shards=[1])])

        churn = MapChurn(seed=a.seed + 1, max_down=8, fire_every=1,
                         max_events=events)
        lat = _LatTimer()
        begin = time.perf_counter()
        storm = lat.run(lambda: run_churn_storm(
            m, churn=churn, events=events, engine=engine,
            measure_every=measure_every))
        verify_storm_equivalence(
            m, churn, lambda: build_cluster(spec, device=device),
            engine=engine, scalar_samples=4)
        bal = lat.run(lambda: balance_cluster(
            m, max_deviation=1.0, engine=engine))
        straggler = Straggler(seed=a.seed + 2,
                              slow={0: a.slow_factor})
        rec, rr = lat.run(lambda: rateless_recover(
            sinfo, ec, m, EC_POOL, 5, stores, hinfos,
            redundancy=a.redundancy, straggler=straggler,
            seed=a.seed + 3, device=not host))
        elapsed = time.perf_counter() - begin
        if not rec.converged or rec.unrecoverable:
            raise RuntimeError(
                f"cluster: recovery failed: {rec.to_dict()}")
        if not healed(stores, objects):
            raise RuntimeError("cluster: data loss after rateless "
                               "recovery")
        # no-straggler control: the SAME plan/work simulated on a
        # clean service model — the denominator of the p99 claim;
        # every object lost exactly shard 1 of chunk_size bytes, so
        # each unit's work matches rateless_recover's classification
        work = [chunk_size / float(1 << 16)] * rr.n_units
        plan = plan_assignments(rr.n_units, rr.n_shards,
                                rr.redundancy, seed=a.seed + 3)
        baseline = simulate_first_k(
            plan, Straggler(seed=a.seed + 2), work)
        base_p99 = float(np.percentile(
            np.asarray(baseline.completion_s), 99)) \
            if baseline.completion_s else 0.0

        res = self._result("cluster", elapsed,
                           width * n_objects, lat)
        res["osds"] = spec.n_osds
        res["total_pgs"] = sum(p.pg_num for p in m.pools.values())
        res["engine"] = engine
        res["storm_events"] = storm.events + storm.drain_events
        res["remap_convergence_epochs"] = storm.epochs_to_quiescence
        res["remapped_total"] = storm.total_remapped
        res["mean_remap_fraction"] = round(
            storm.mean_remap_fraction, 6)
        res["balancer_iterations"] = bal.iterations
        res["balancer_moves"] = bal.moves
        res["balancer_converged"] = bal.converged
        res["balancer_max_dev_final"] = round(bal.max_dev_final, 4)
        res["balancer_remap_fraction"] = round(bal.remap_fraction, 6)
        res["redundancy"] = rr.redundancy
        res["n_shards"] = rr.n_shards
        res["p99_recovery_ms"] = round(rr.p99_s * 1e3, 4)
        res["p99_baseline_ms"] = round(base_p99 * 1e3, 4)
        res["p99_ratio"] = (round(rr.p99_s / base_p99, 4)
                            if base_p99 > 0 else None)
        res["straggler_reassignments"] = \
            rr.schedule.straggler_reassignments if rr.schedule else 0
        res["verified"] = True
        return res

    # -- scenario (the composed production day: client traffic at SLO
    # + churn storm + straggler recovery under mClock QoS arbitration
    # — scenario/) -------------------------------------------------------

    def scenario_workload(self) -> dict:
        """Production-day contention numbers: the canonical mixed
        rs/shec/clay client stream serves at SLO while a churn storm
        remaps the cluster, recovery rounds heal straggler-skewed
        damage and scrub verifies — all on ONE real clock,
        admission-gated by the mClock arbiter (scenario/qos.py;
        --no-arbiter is the unthrottled control), on the run's device
        (--device host: the host executor).  The row reports
        GB/s-under-SLO, p99 and the deadline-miss rate, and
        ``tail_attribution`` (per-segment share of p99 time from the
        causal tracing plane, telemetry/analyzer.py).  Correctness
        gates run in-workload: client stream byte-verified against
        ground truth, recovery converged with byte-identical heal, zero
        data loss."""
        from ..scenario import default_scenario, run_scenario
        a = self.args
        executor = "host" if a.device == "host" else "device"
        device = self._device()
        spec = default_scenario(
            seed=a.seed, n_requests=a.requests, stripe_size=a.size,
            damaged_objects=max(2, a.batch), erasures=a.erasures,
            storm_events=min(a.storm_events, 12),
            straggler_factor=a.slow_factor)
        run, tail = self._run_traced(
            lambda: run_scenario(spec, executor=executor, device=device,
                                 enable_arbiter=not a.no_arbiter))
        rep = run.report
        if not rep.ok():
            raise RuntimeError(f"scenario gates failed: {rep.gates}")
        res = self._result("scenario", rep.slo["elapsed_s"],
                           rep.slo["bytes"])
        res["lat_p50_ms"] = rep.slo["p50_ms"]
        res["lat_p99_ms"] = rep.slo["p99_ms"]
        res["lat_p999_ms"] = rep.slo["p999_ms"]
        res["lat_samples"] = rep.slo["requests"]
        res["gbps_under_slo"] = rep.gbps_under_slo
        res["deadline_miss_rate"] = rep.deadline_miss_rate
        res["arbiter_enabled"] = rep.arbiter_enabled
        res["qos_scale_min"] = rep.qos["scale_min"]
        res["qos_burn_trips"] = rep.qos["burn_trips"]
        res["slo_burn_trips"] = rep.slo_burn_trips
        res["recovery_rounds"] = rep.recovery_rounds
        res["recovery_ops_completed"] = \
            rep.recovery["ops_completed"]
        res["churn_events"] = rep.churn["events"]
        res["straggler_reassignments"] = \
            rep.rateless["straggler_reassignments"]
        res["rateless_p99_ratio"] = rep.rateless["p99_ratio"]
        res["stream_compiles"] = rep.slo.get("stream_compiles")
        res["tail_attribution"] = tail
        res["verified"] = True
        return res

    # -- tenant-week (the multi-tenant compressed week: per-tenant
    # diurnal streams under the per-tenant mClock door, discrete-event
    # fast-forward, staged correlated disasters — scenario/week.py) -----

    def tenant_week_workload(self) -> dict:
        """Multi-tenant isolation numbers: the 3-tenant compressed week
        — diurnal streams merged on one arrival timeline, the noisy
        tenant's burst storm clamped at the door by its mClock limit
        tag, all four staged disasters healing byte-identically — runs
        as a discrete-event simulation on an EventClock (the service
        model charges modeled time, so every number is deterministic
        from the seed), its dispatches on the run's device (--device
        host: the host executor).  The row carries per-tenant
        scorecards plus the isolation-gate verdict against per-tenant
        isolated baselines; ``--no-arbiter`` is the control arm that
        must FAIL that gate.  Correctness gates in-workload: recovery
        converged, heal byte-identical, every served request
        byte-verified."""
        from ..scenario import (isolated_baseline, isolation_gate,
                                run_tenant_week, tenant_week_scenario)
        a = self.args
        executor = "host" if a.device == "host" else "device"
        device = self._device()
        # the bench row runs the tiny-scale week; scale rides
        # --iterations as days
        spec = tenant_week_scenario(
            seed=a.seed, days=max(2, a.iterations), day_s=6.0,
            peak_rates=(40.0, 30.0, 20.0), burst_factor=80.0)
        run = run_tenant_week(spec, executor=executor, device=device,
                              enable_arbiter=not a.no_arbiter)
        rep = run.report
        g = rep.gates
        if not (g["converged"] and g["healed"]
                and g["verified_requests"]):
            raise RuntimeError(f"tenant-week gates failed: {g}")
        victims = tuple(t.name for t in spec.tenants
                        if t.limit == 0.0)
        base = {n: isolated_baseline(spec, n, executor=executor,
                                     device=device)
                for n in victims}
        gate = isolation_gate(rep, base, victims=victims)
        if not a.no_arbiter and not gate["ok"]:
            raise RuntimeError(
                f"tenant-week isolation gate failed: {gate}")
        res = self._result("tenant-week", rep.slo["elapsed_s"],
                           rep.slo["bytes"])
        res["lat_p50_ms"] = rep.slo["p50_ms"]
        res["lat_p99_ms"] = rep.slo["p99_ms"]
        res["lat_p999_ms"] = rep.slo["p999_ms"]
        res["lat_samples"] = rep.slo["requests"]
        res["gbps_under_slo"] = rep.gbps_under_slo
        res["deadline_miss_rate"] = rep.deadline_miss_rate
        res["arbiter_enabled"] = rep.arbiter_enabled
        res["requests_offered"] = g["requests_offered"]
        res["dispatched"] = g["dispatched"]
        res["dispatch_crc"] = g["dispatch_crc"]
        res["tenants"] = rep.tenants
        # victims' GB/s-under-SLO with the burst storm raging is THE
        # isolation number
        res["victim_gbps_under_slo"] = sum(
            (rep.tenants.get(n, {}).get("gbps_under_slo") or 0.0)
            for n in victims)
        res["isolation_ok"] = gate["ok"]
        res["isolation_victims"] = gate["victims"]
        res["disasters"] = rep.disasters
        res["disasters_healed"] = all(
            d["healed"] for d in rep.disasters)
        res["fence_deferrals"] = sum(
            d["fence_deferrals"] for d in rep.disasters)
        res["recovery_rounds"] = rep.recovery_rounds
        res["scrub_ticks"] = rep.scrub_ticks
        res["churn_events"] = rep.churn["events"]
        res["verified"] = True
        return res

    def _run_workload(self) -> dict:
        if self.args.workload == "autotune":
            return self.autotune_workload()
        if self.args.workload == "profile":
            return self.profile_workload()
        if self.args.workload == "encode":
            return self.encode()
        if self.args.workload == "degraded":
            return self.degraded()
        if self.args.workload == "repair-batched":
            return self.repair_batched()
        if self.args.workload == "recovery-churn":
            return self.recovery_churn()
        if self.args.workload == "serving":
            return self.serving()
        if self.args.workload == "device-chaos":
            return self.device_chaos()
        if self.args.workload == "multichip":
            return self.multichip()
        if self.args.workload == "host-chaos":
            return self.host_chaos()
        if self.args.workload == "cluster":
            return self.cluster()
        if self.args.workload == "scenario":
            return self.scenario_workload()
        if self.args.workload == "tenant-week":
            return self.tenant_week_workload()
        return self.decode()


@dataclass
class RecoveryRun:
    """What a recovery workload leaves on ``ErasureCodeBench.last_run``
    for a caller that checks the heal: the geometry and code, the
    undamaged objects as ``(shards, HashInfo)``, the stores each timed
    pass healed, the fault-pattern pool and the last RecoveryReport
    (recovery-churn)."""

    sinfo: object
    ec: object
    objects: list
    runs: list
    pool: list = field(default_factory=list)
    report: object = None


def main(argv: List[str] | None = None) -> int:
    bench = ErasureCodeBench()
    bench.setup(argv if argv is not None else sys.argv[1:])
    res = bench.run()
    if bench.args.json_out:
        print(json.dumps(res))
    else:
        # reference output: "<elapsed seconds>\t<total KiB>"
        print(f"{res['seconds']:.6f}\t{res['total_bytes'] // 1024}")
        if bench.args.verbose:
            print(f"{res['gbps']:.3f} GB/s", file=sys.stderr)
    return 0


__all__ = ["ErasureCodeBench", "RecoveryRun", "build_chain", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
