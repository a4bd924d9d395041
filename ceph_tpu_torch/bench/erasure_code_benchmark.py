"""ErasureCodeBench — the metric source, CLI-compatible with the reference.

A port of ``ceph_tpu/bench/erasure_code_benchmark.py``, which mirrors
src/test/erasure-code/ceph_erasure_code_benchmark.{h,cc} -> class
ErasureCodeBench:

- setup(): the flags --plugin/-p, --workload/-w, --iterations/-i,
  --size/-s, --parameter/-P (repeated k=v into the ErasureCodeProfile),
  --erasures/-e, --erasures-generation/-E random|exhaustive, --erased
  (repeated chunk ids), --verbose/-v, with the reference's defaults.
- run() -> encode() | decode() | serving(); prints
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

Not ported yet, each with the ROADMAP Queue A item that brings its
module: the degraded, repair-batched, recovery-churn and device-chaos
workloads (item 4), multichip and host-chaos (item 5), profile and
autotune, and --tune-table (item 6), cluster, scenario and tenant-week
(item 7).  They stay in the flag choices, so --help matches the
reference, and exit with a CLI error.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..codes.registry import ErasureCodePluginRegistry
from ..telemetry import LatencyHistogram

# workloads whose modules are not ported yet -> the ROADMAP Queue A item
# that ports them
UNPORTED_WORKLOADS = {
    "degraded": "item 4 (scrub)",
    "repair-batched": "item 4 (scrub)",
    "recovery-churn": "item 4 (recovery)",
    "device-chaos": "item 4 (chaos, supervision)",
    "multichip": "item 5 (the data plane)",
    "host-chaos": "item 5 (the data plane's host partition)",
    "profile": "item 6 (the program profiler)",
    "autotune": "item 6 (tuning)",
    "cluster": "item 7 (cluster)",
    "scenario": "item 7 (scenario)",
    "tenant-week": "item 7 (scenario)",
}


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
        self.last_run = None  # the serving workload's ServingRun

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
                             "(degraded workload, not ported yet)")
        ap.add_argument("--churn-every", type=int, default=2,
                        metavar="K",
                        help="recovery-churn workload (not ported yet): "
                             "one map epoch every K pattern-batch "
                             "dispatches")
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
                        help="cluster workload (not ported yet): "
                             "synthetic cluster device count")
        ap.add_argument("--cluster-pgs", type=int, default=1024,
                        help="cluster workload (not ported yet): "
                             "replicated pool pg_num")
        ap.add_argument("--storm-events", type=int, default=40,
                        help="cluster workload (not ported yet): storm "
                             "epoch budget")
        ap.add_argument("--redundancy", type=int, default=2,
                        help="cluster workload (not ported yet): "
                             "rateless over-planning factor r")
        ap.add_argument("--slow-factor", type=float, default=10.0,
                        help="cluster/scenario workloads (not ported "
                             "yet): the injected straggler's slowdown")
        ap.add_argument("--no-arbiter", action="store_true",
                        help="scenario workload (not ported yet): "
                             "disable the QoS arbiter")
        ap.add_argument("--tune-table", default=None, metavar="FILE",
                        help="install this best-config table before "
                             "the workload (not ported yet: ROADMAP "
                             "Queue A item 6)")
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
                        help="host-chaos workload (not ported yet): "
                             "simulated host fault domains")
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
        item = UNPORTED_WORKLOADS.get(self.args.workload)
        if item is not None:
            ap.error(f"--workload {self.args.workload} is not ported "
                     f"yet (ROADMAP Queue A {item})")
        if self.args.tune_table:
            ap.error("--tune-table is not ported yet (ROADMAP Queue A "
                     "item 6 (tuning))")
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
        """The static composite/plan decode matrix the (available,
        erased) pattern actually runs, across the plugin families:
        clay/lrc probed composites, shec's minimum-read plan matrix,
        the mixin decode matrix.  None when the plugin has no matrix
        surface (bitmatrix techniques)."""
        available, pat = tuple(available), tuple(pat)
        comp = getattr(ec, "_decode_composite", None)
        if comp is not None:
            try:
                return comp(available, pat)[1]
            except Exception:  # noqa: BLE001 - advisory probe only
                return None
        tcache = getattr(ec, "tcache", None)
        if tcache is not None and hasattr(ec, "_plan_static"):  # shec
            try:
                plan = tcache.get_plan(ec.matrix, ec.k, ec.w,
                                       frozenset(available),
                                       frozenset(pat))
                return ec._plan_static(plan)[1]
            except Exception:  # noqa: BLE001 - advisory probe only
                return None
        dm = getattr(ec, "_decode_matrix", None)
        if dm is not None:
            try:
                return dm(available, pat)[1]
            except Exception:  # noqa: BLE001 - advisory probe only
                return None
        return None

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
        region ops; ``mesh_shape`` null until the data plane is ported
        (ROADMAP Queue A item 5)."""
        if self.args.device == "host":
            return {"platform": None, "device_count": 0,
                    "mesh_shape": None}
        if self.args.device == "cuda":
            return {"platform": "gpu",
                    "device_count": torch.cuda.device_count(),
                    "mesh_shape": None}
        return {"platform": "cpu", "device_count": 1, "mesh_shape": None}

    def _result(self, workload: str, elapsed: float, total_bytes: int,
                lat: "_LatTimer | None" = None) -> dict:
        gbps = total_bytes / elapsed / 1e9 if elapsed > 0 else float("inf")
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
            # the hand-picked defaults until the tuning table is ported
            # (ROADMAP Queue A item 6)
            "config_source": "default",
            "tune_key_hash": None,
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

    def _run_workload(self) -> dict:
        if self.args.workload == "encode":
            return self.encode()
        if self.args.workload == "serving":
            return self.serving()
        return self.decode()


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


__all__ = ["ErasureCodeBench", "UNPORTED_WORKLOADS", "build_chain", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
