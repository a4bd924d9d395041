"""Device-plane cost/roofline attribution for the port's programs — a
port of ``ceph_tpu/telemetry/profiler.py``.

One :class:`ProgramProfiler` holds a :class:`ProgramRecord` per program
(an engine seam's callable at one batch rung, CRUSH's first-rung block,
an entry point of the registry):

- **cost side** — there is no ``cost_analysis`` in torch, so every
  record's cost comes from the analytic models below, with
  ``source="analytic"``.  ``bytes accessed`` is the traffic of the
  *function* (each input read once, each output written once), the
  same whichever tier runs it, so a utilization read off it means the
  same thing whatever kernel ran.  The reference's two models are
  copied (:func:`analytic_matrix_cost`, :func:`analytic_xor_schedule_cost`);
  the port adds the card's INT32 models of its word kernels
  (:func:`analytic_kernel_cost`, the packet product's
  :func:`analytic_bitmatrix_cost`, the column walk's
  :func:`analytic_walk_cost`), the fused repair as the sum of its decode
  and re-encode (:func:`analytic_fused_repair_cost`), and CRUSH's first
  rung priced by its straw2 draws (:func:`analytic_crush_cost`).
  :func:`roofline_ms` turns a cost into the least time the card could
  take; ``chip_smoke.py`` and ``tools/dense_times.py`` read their
  kernels' bounds from it, so the kernel table and the attribution rows
  count the same work.
- **measured side** — a LatencyHistogram per record.  A record on the
  CPU reads the profiler's injectable clock around the call, so
  FakeClock and tick-clock runs give byte-identical rows.  A record on
  a CUDA device records a pair of ``torch.cuda.Event(enable_timing=
  True)`` on the device's current stream around the call: the host
  clock would read the host's issue, not the program.  The pairs are
  resolved lazily — in :meth:`ProgramProfiler.attribution_rows` /
  ``to_dict``, or, without blocking, when the pending list reaches
  ``MAX_PENDING`` — never with a synchronize per call.  A pair reads
  the stream's time from the call's first to its last operation: when
  the host is ahead of the card (work queued before the call), that is
  the program's device time; on an idle stream it also holds the host's
  issue inside the call.  :func:`hold_stream` queues a spin ahead of a
  round of calls, so a measurement can read device time.  A pair's own
  cost on the stream (two event records: 3.0 µs on an H100 80GB HBM3
  at 700 W in PERF.md §6) is measured
  once per device, the first time a call there is timed
  (:func:`event_pair_overhead`, which synchronizes), and subtracted
  from every pair.
- **join** — :meth:`ProgramProfiler.attribution_rows` emits one row per
  (program, plugin, pattern, engine tier, device count): bytes/ops from
  the cost model, measured p50/p99, achieved GB/s, the model-bound GB/s
  at the memory roofline, and utilization %.

The roofline peak (:func:`resolve_peak_gbps`): ``"cpu"`` keeps the
reference's nominal 64 GB/s (plumbing only, not a kernel claim); a CUDA
record resolves by the card's name through :data:`CARD_PEAK_GBPS`
(``torch.cuda.get_device_name()``); an unknown card has no peak, and its
rows no utilization, unless ``CEPH_TPU_HBM_PEAK_GBPS`` is set.

Host-side at module scope: torch is imported inside the CUDA paths, and
:func:`profiler_selftest` drives the whole join on synthetic records
with no device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

from .histogram import LatencyHistogram
from .metrics import series_name
from ..utils.detcheck import default_clock
from ..utils.locks import make_lock

# Nominal peak memory bandwidth per platform, GB/s — the roofline
# denominator.  cpu: the reference's nominal dual-channel DDR5 (order of
# magnitude only: CPU rows exist for plumbing tests).  A CUDA record
# resolves by the card's name in CARD_PEAK_GBPS instead.
HBM_PEAK_GBPS: Dict[str, float] = {"cpu": 64.0}

# the cards whose memory rate the port states: the H100 SXM5's HBM3,
# 3.35 TB/s (NVIDIA's datasheet; PERF.md §3)
H100 = "NVIDIA H100 80GB HBM3"
CARD_PEAK_GBPS: Dict[str, float] = {H100: 3350.0}
# the same card's INT32 peak: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (16.7 Tops/s), the rate the GF kernels' word operations run at
CARD_INT32_OPS_PER_S: Dict[str, float] = {H100: 132 * 64 * 1.98e9}

# INT32 instructions per straw2 draw on sm_90: hash32_3 is 5 mixes of 9
# steps, each an IADD3 (a - b - c), a SHF and a LOP3 (the xor), plus two
# LOP3 for seed ^ a ^ b ^ c; the 16-bit mask; the 64-bit divide of a
# numerator below 2^49 by a 32-bit weight (no integer divider: a
# reciprocal estimate and two 64-bit multiply-subtract corrections,
# about 24 instructions, an estimate, not read from SASS); the argmin's
# 64-bit compare and select (4)
STRAW2_DRAW_OPS = 5 * 9 * 3 + 2 + 1 + 24 + 4

TOP_N = 10  # hot-program list length in to_dict()
# CUDA event pairs kept before a non-blocking resolve is attempted
MAX_PENDING = 4096
# spin cycles per call that hold_stream queues: ~0.5 ms at the H100's
# 1.98 GHz, more than one seam call's host issue
HOLD_CYCLES_PER_CALL = 1_000_000


class _SystemClock:
    def monotonic(self) -> float:
        return time.monotonic()


# CEPH_TPU_PROFILE=0 disables the cost-capture side (the reference's
# knob); the measured histograms keep recording either way, so rows
# degrade to latency-only instead of vanishing.
_capture_enabled = os.environ.get(
    "CEPH_TPU_PROFILE", "1").strip() != "0"


def capture_enabled() -> bool:
    return _capture_enabled


def set_capture_enabled(on: bool) -> bool:
    """Toggle cost capture (tests / overhead probes); returns the
    previous setting."""
    global _capture_enabled
    prev = _capture_enabled
    _capture_enabled = on
    return prev


def _card_name() -> Optional[str]:
    """The current card's name, without initialising CUDA on a host
    path: None unless CUDA is already initialised."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.get_device_name()


def resolve_peak_gbps(platform: Optional[str],
                      device_name: Optional[str] = None
                      ) -> Optional[float]:
    """The roofline peak for ``platform`` (env override wins).  A
    ``"cuda"`` platform resolves by ``device_name`` (default: the
    current card's) through CARD_PEAK_GBPS; an unknown card gives
    None."""
    env = os.environ.get("CEPH_TPU_HBM_PEAK_GBPS", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if platform is None:
        return None
    if platform == "cuda":
        name = device_name if device_name is not None else _card_name()
        return CARD_PEAK_GBPS.get(name) if name else None
    return HBM_PEAK_GBPS.get(platform)


# ----------------------------------------------------------------------
# the analytic cost models

def analytic_matrix_cost(batch: int, rows: int, cols: int,
                         chunk_bytes: int) -> Dict[str, float]:
    """GF(2^8) matrix-apply cost model (the reference's): ``out[r] =
    xor_c M[r,c] * in[c]`` over ``chunk_bytes``-byte chunks — one GF
    multiply + one XOR per (row, col, byte), input read once, output
    written once."""
    gf_ops = float(batch) * rows * cols * chunk_bytes
    return {"flops": 2.0 * gf_ops,
            "bytes accessed": float(batch) * (rows + cols) * chunk_bytes}


def analytic_xor_schedule_cost(batch: int, rows: int, cols: int,
                               chunk_bytes: int,
                               vpu_ops: int) -> Dict[str, float]:
    """Cost model for an XOR-scheduled matrix apply (the reference's):
    the schedule is a straight-line program of ``vpu_ops`` full-width
    vector ops, each touching one chunk-sized tile — so flops = batch *
    vpu_ops * chunk_bytes (byte-ops), while the memory side is the dense
    model's (input read once, output written once)."""
    return {"flops": float(batch) * vpu_ops * chunk_bytes,
            "bytes accessed": float(batch) * (rows + cols) * chunk_bytes}


def analytic_kernel_cost(batch: int, rows: int, cols: int,
                         chunk_bytes: int, ops_per_word: float,
                         live: Optional[int] = None) -> Dict[str, float]:
    """The card's model of a GF word kernel (the dense, XOR-schedule,
    packet and column-walk kernels): every kernel walks the chunks as
    32-bit words, ``ops_per_word`` INT32 instructions per word position
    of a stripe (``gf_kernels.sm90_op_floor``, ``xor_schedule_op_count``
    ...), and moves each of the ``cols`` input chunks in once and each
    of the ``rows`` output chunks out once.  ``live``: the stripes of a
    ragged pool the mask keeps (then only they are read and computed,
    every output stripe is written, and the (batch,) byte mask is read
    once); every stripe by default.  ``flops`` here counts INT32
    instructions."""
    read = batch if live is None else live
    mask = 0 if live is None else batch
    return {"flops": float(ops_per_word) * read * chunk_bytes / 4,
            "bytes accessed": float(read * cols + batch * rows)
            * chunk_bytes + mask}


def analytic_bitmatrix_cost(batch: int, rows: int, cols: int,
                            chunk_bytes: int, op_count: int, w: int,
                            reads: Optional[int] = None
                            ) -> Dict[str, float]:
    """The packet (GF(2) bitmatrix) product: each chunk is blocks of
    ``w`` packet rows; ``op_count`` INT32 instructions per word position
    of one packet row (``gf_kernels.bitmatrix_op_count`` /
    ``schedule_op_count``); ``reads`` input packet rows of a block the
    product reads (every one of the ``cols * w`` by default), each once,
    and the ``rows * w`` output packet rows written once."""
    row_bytes = batch * chunk_bytes // w
    reads = cols * w if reads is None else reads
    return {"flops": float(op_count) * row_bytes / 4,
            "bytes accessed": float(row_bytes) * (reads + rows * w)}


def analytic_walk_cost(batch: int, rows: int, cols: int,
                       chunk_bytes: int, op_count: int
                       ) -> Dict[str, float]:
    """The column walk (the mxu row): ``op_count`` INT32 instructions
    per word position of a stripe for the whole sparse matrix
    (``gf_kernels.walk_op_count``)."""
    return analytic_kernel_cost(batch, rows, cols, chunk_bytes, op_count)


def analytic_fused_repair_cost(decode: Dict[str, float],
                               encode: Dict[str, float]
                               ) -> Dict[str, float]:
    """The fused decode -> re-encode: the sum of its two programs."""
    return {k: float(decode[k]) + float(encode[k])
            for k in ("flops", "bytes accessed")}


def analytic_crush_cost(lanes: int, tries: int, replicas: int,
                        width: int, result_max: int) -> Dict[str, float]:
    """CRUSH's first rung: ``lanes x tries x replicas x width`` straw2
    draws (the take bucket level's width) at STRAW2_DRAW_OPS INT32
    instructions each; each x read once (int64), each lane's
    ``result_max`` int32 placements, its count (int64) and its need-host
    flag written once."""
    draws = float(lanes) * tries * replicas * width
    return {"flops": draws * STRAW2_DRAW_OPS,
            "bytes accessed": float(lanes) * (8 + 4 * result_max + 8 + 1)}


def roofline_ms(cost: Dict[str, float], peak_gbps: float = 3350.0,
                ops_per_s: float = CARD_INT32_OPS_PER_S[H100]
                ) -> Tuple[float, str]:
    """The least time the card could take for ``cost``: the larger of
    its bytes over the memory rate and its ops (``flops``) over their
    type's peak (INT32 unless ``ops_per_s`` says otherwise), and which
    of the two bounds it (``"bytes"`` or ``"operations"``).  Defaults:
    the H100's."""
    t_mem = cost["bytes accessed"] / (peak_gbps * 1e9) * 1e3
    t_ops = cost["flops"] / ops_per_s * 1e3
    return max(t_mem, t_ops), ("operations" if t_ops >= t_mem else "bytes")


_pair_overhead: Dict[str, float] = {}


def event_pair_overhead(device) -> float:
    """Seconds an empty CUDA event pair reads on ``device``'s current
    stream when the host is ahead of the card (the pairs queued behind
    :func:`hold_stream`): the pair's own cost, which every CUDA record
    subtracts.  Measured once per device, the median of 16 pairs; the
    measurement synchronizes with the card."""
    key = str(device)
    hit = _pair_overhead.get(key)
    if hit is None:
        import torch
        stream = torch.cuda.current_stream(device)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(16)]
        hold_stream(device, 4)
        for start, end in pairs:
            start.record(stream)
            end.record(stream)
        pairs[-1][1].synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        hit = _pair_overhead.setdefault(key, times[len(times) // 2] / 1e3)
    return hit


def hold_stream(device, calls: int) -> None:
    """Queue a spin on ``device``'s current stream long enough for the
    host to issue ``calls`` calls behind it, so their CUDA event pairs
    read the card's time for each call rather than the host's issue
    (a no-op off the card)."""
    if getattr(device, "type", device) != "cuda":
        return
    import torch
    with torch.cuda.device(device):
        torch.cuda._sleep(HOLD_CYCLES_PER_CALL * max(1, calls))


def _normalize_cost(cost) -> Optional[Dict[str, float]]:
    """An explicit cost as {flops, bytes accessed} floats (absent keys
    -> 0.0), or None when it is not a dict."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else None
    if not isinstance(cost, dict):
        return None
    return {"flops": float(cost.get("flops", 0.0)),
            "bytes accessed": float(cost.get("bytes accessed", 0.0))}


def _nbytes(args) -> Optional[int]:
    total = 0
    for a in args:
        n = getattr(a, "nbytes", None)
        if n is None:
            return None
        total += int(n)
    return total


@dataclasses.dataclass
class ProgramRecord:
    """One program's attribution state."""

    key: tuple
    name: str
    labels: Dict[str, str]          # plugin/kind/pattern/engine/devices
    platform: Optional[str] = None
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    arg_bytes: Optional[int] = None
    source: str = "none"            # "analytic" | "none"
    error: Optional[str] = None
    hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def series(self) -> str:
        return series_name(
            self.name,
            tuple(sorted((str(k), str(v))
                         for k, v in self.labels.items())))


class ProgramProfiler:
    """Process-wide per-program cost/roofline attribution registry.

    Capture is **idempotent per key** (the engine seams capture at a
    key's first dispatch; later calls are a dict lookup) and **never
    raises** into the dispatch path."""

    def __init__(self, clock=None) -> None:
        self.clock = clock if clock is not None \
            else default_clock("telemetry.profiler.ProgramProfiler",
                               _SystemClock)
        self._lock = make_lock("telemetry.profiler.ProgramProfiler._lock")
        self._records: Dict[tuple, ProgramRecord] = {}
        # CUDA event pairs not yet read: (key, start, end), stream order
        self._pending: List[tuple] = []
        self.captures = 0
        self.capture_errors = 0

    # -- capture ---------------------------------------------------------

    def has(self, key: tuple) -> bool:
        with self._lock:
            return key in self._records

    def capture(self, key: tuple, args: tuple = (), *,
                name: str, platform: Optional[str] = None,
                cost: Optional[dict] = None,
                arg_bytes: Optional[int] = None,
                **labels) -> ProgramRecord:
        """Register program ``key`` with its analytic ``cost`` ({flops,
        bytes accessed}); ``arg_bytes`` defaults to the bytes of
        ``args``.  Later calls with the same key return the record."""
        with self._lock:
            hit = self._records.get(key)
            if hit is not None:
                return hit
        rec = ProgramRecord(
            key=key, name=name,
            labels={str(k): str(v) for k, v in sorted(labels.items())},
            platform=platform,
            arg_bytes=arg_bytes if arg_bytes is not None
            else _nbytes(args))
        norm = (_normalize_cost(cost)
                if cost is not None and _capture_enabled else None)
        if norm is not None:
            rec.flops = norm["flops"]
            rec.bytes_accessed = norm["bytes accessed"]
            rec.source = "analytic"
        with self._lock:
            race = self._records.get(key)
            if race is not None:
                return race
            self._records[key] = rec
            self.captures += 1
        from . import metrics as tel
        tel.counter("profiler_captures", source=rec.source)
        tel.gauge("profiler_programs", len(self._records))
        return rec

    # -- measured side ---------------------------------------------------

    def observe(self, key: tuple, seconds: float) -> None:
        with self._lock:
            rec = self._records.get(key)
        if rec is not None:
            rec.hist.record(seconds)

    @contextlib.contextmanager
    def timed(self, key: tuple, eager: bool = True, device=None):
        """Time one dispatch into the program's histogram: on the
        profiler clock, or, for a CUDA ``device``, with a CUDA event
        pair on its current stream, read later.  ``eager=False`` or
        telemetry disabled records nothing."""
        from . import metrics as tel
        if not (eager and tel.enabled()):
            yield
            return
        if device is not None and getattr(device, "type", device) == "cuda":
            import torch
            overhead = event_pair_overhead(device)
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                with self._lock:
                    self._pending.append((key, start, end, overhead))
                    full = len(self._pending) >= MAX_PENDING
                if full:
                    self.resolve(block=False)
            return
        t0 = self.clock.monotonic()
        try:
            yield
        finally:
            self.observe(key, self.clock.monotonic() - t0)

    def resolve(self, block: bool = True) -> int:
        """Read the pending CUDA event pairs into their histograms (each
        less the pair's own cost), in stream order; ``block=False``
        stops at the first pair the card has not finished.  Returns the
        pairs read."""
        with self._lock:
            pending, self._pending = self._pending, []
        done = 0
        for i, (key, start, end, overhead) in enumerate(pending):
            if block:
                end.synchronize()
            elif not end.query():
                with self._lock:
                    self._pending[:0] = pending[i:]
                break
            self.observe(key, max(start.elapsed_time(end) / 1e3 - overhead,
                                  0.0))
            done += 1
        return done

    # -- the join --------------------------------------------------------

    def attribution_rows(self) -> List[dict]:
        """One deterministic row per program: cost model × measured
        dispatch latency × roofline.

        - ``achieved_gbps``   = arg_bytes / p50 (input-byte rate, the
          unit every bench row speaks)
        - ``hbm_gbps``        = bytes_accessed / p50 (modeled memory
          traffic rate)
        - ``model_bound_gbps``= peak × arg_bytes / bytes_accessed (the
          input-byte rate this program would reach at the memory peak)
        - ``utilization_pct`` = 100 × hbm_gbps / peak
        """
        if self._pending:
            self.resolve()
        with self._lock:
            records = sorted(
                self._records.values(),
                key=lambda r: (r.name, tuple(sorted(r.labels.items()))))
        rows = []
        for rec in records:
            p50 = p99 = None
            if rec.hist.count:
                pcts = rec.hist.percentiles()
                p50, p99 = pcts["p50"], pcts["p99"]
            peak = resolve_peak_gbps(rec.platform)
            row = {
                "name": rec.name,
                "series": rec.series(),
                "platform": rec.platform,
                "source": rec.source,
                "flops": rec.flops,
                "bytes_accessed": rec.bytes_accessed,
                "arg_bytes": rec.arg_bytes,
                "calls": rec.hist.count,
                "p50_ms": round(p50 * 1e3, 6) if p50 else None,
                "p99_ms": round(p99 * 1e3, 6) if p99 else None,
                "achieved_gbps": None,
                "hbm_gbps": None,
                "model_bound_gbps": None,
                "utilization_pct": None,
                "flops_per_byte": None,
                "error": rec.error,
            }
            row.update(rec.labels)
            if rec.flops and rec.bytes_accessed:
                row["flops_per_byte"] = round(
                    rec.flops / rec.bytes_accessed, 6)
            if p50:
                if rec.arg_bytes:
                    row["achieved_gbps"] = round(
                        rec.arg_bytes / p50 / 1e9, 6)
                if rec.bytes_accessed:
                    row["hbm_gbps"] = round(
                        rec.bytes_accessed / p50 / 1e9, 6)
            if peak and rec.bytes_accessed:
                if rec.arg_bytes:
                    row["model_bound_gbps"] = round(
                        peak * rec.arg_bytes / rec.bytes_accessed, 6)
                if row["hbm_gbps"] is not None:
                    row["utilization_pct"] = round(
                        100.0 * row["hbm_gbps"] / peak, 4)
            rows.append(row)
        return rows

    def top_programs(self, n: int = TOP_N) -> List[dict]:
        """The hot list: programs by total measured dispatch seconds."""
        with self._lock:
            records = sorted(
                self._records.values(),
                key=lambda r: (-r.hist.sum, r.name,
                               tuple(sorted(r.labels.items()))))
        return [{"series": r.series(),
                 "total_s": round(r.hist.sum, 6),
                 "calls": r.hist.count}
                for r in records[:n] if r.hist.count]

    def to_dict(self) -> dict:
        """The perf-dump ``profile`` section (schema.py validates)."""
        rows = self.attribution_rows()
        return {"programs": len(rows),
                "captures": self.captures,
                "capture_errors": self.capture_errors,
                "rows": rows,
                "top": self.top_programs()}

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._pending.clear()
            self.captures = 0
            self.capture_errors = 0


_global: Optional[ProgramProfiler] = None
_global_lock = make_lock("telemetry.profiler._global_lock")


def global_profiler() -> ProgramProfiler:
    global _global
    with _global_lock:
        if _global is None:
            _global = ProgramProfiler()
        return _global


def set_global_profiler(profiler: Optional[ProgramProfiler]
                        ) -> Optional[ProgramProfiler]:
    """Swap the process profiler (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev = _global
        _global = profiler
        return prev


# ----------------------------------------------------------------------
# entry-point sweep: an attribution row for every device entry of the
# registry (analysis/entrypoints.py)

def analytic_io_cost(args, out) -> Dict[str, float]:
    """An entry point's function traffic: every input tensor read once,
    every output tensor written once (no op count)."""
    def nbytes(x) -> int:
        if isinstance(x, (tuple, list)):
            return sum(nbytes(v) for v in x)
        return int(getattr(x, "nbytes", 0))
    return {"flops": 0.0, "bytes accessed": float(nbytes(args)
                                                  + nbytes(out))}


def profile_entrypoints(filters: Tuple[str, ...] = (),
                        measure: bool = True, repeats: int = 3,
                        profiler: Optional[ProgramProfiler] = None,
                        device=None) -> Tuple[List[dict], List[str]]:
    """Walk the registry (analysis/entrypoints.py), build every device
    entry on ``device`` (default: the card), capture its function
    traffic (:func:`analytic_io_cost`) and, with ``measure``, time
    ``repeats`` warm calls.  Returns ``(rows, failed)``: an entry that
    cannot produce a row lands in ``failed``."""
    import torch

    from ..analysis.entrypoints import registry
    from ..ops.fallback import resolve_device

    dev = resolve_device(device)
    prof = profiler if profiler is not None else global_profiler()
    failed: List[str] = []
    for ep in registry():
        if ep.kind != "device":
            continue
        if filters and not any(f in ep.name for f in filters):
            continue
        try:
            built = ep.build(dev)
            out = built.fn(*built.args)
            key = ("entry", ep.name)
            prof.capture(key, built.args, name=ep.name,
                         platform=dev.type,
                         cost=analytic_io_cost(built.args, out),
                         plugin=ep.family, kind="entrypoint",
                         engine=dev.type, devices=1)
            if measure:
                for _ in range(repeats):
                    with prof.timed(key, device=dev):
                        built.fn(*built.args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            failed.append(f"{ep.name}: {type(e).__name__}: {e}")
    return prof.attribution_rows(), failed


# ----------------------------------------------------------------------
# the host-tier audit workload

class _Tick:
    """Deterministic auto-advancing clock (1 ms per read)."""

    def __init__(self, step: float = 0.001) -> None:
        self.now = 0.0
        self.step = step

    def monotonic(self) -> float:
        self.now += self.step
        return self.now


def profiler_selftest() -> dict:
    """The ``telemetry.profiler_selftest`` host-tier audit entry: the
    whole capture → observe → attribution-join → section-dump pipeline
    on an isolated profiler with synthetic (analytic) costs and a
    deterministic tick clock.  Touches no device and returns only host
    data."""
    import json

    from .schema import validate_profile_section

    prof = ProgramProfiler(clock=_Tick())
    key = ("selftest", "encode")
    prof.capture(key, name="selftest.encode", platform="cpu",
                 cost=analytic_matrix_cost(4, 3, 8, 4096),
                 arg_bytes=4 * 8 * 4096,
                 plugin="selftest", kind="serve-encode",
                 engine="device", devices=1)
    prof.capture(key, name="selftest.encode")  # idempotent fast path
    with prof.timed(key):
        pass
    prof.observe(key, 0.002)
    rows = prof.attribution_rows()
    if len(rows) != 1:
        raise AssertionError(f"selftest expected 1 row, got {len(rows)}")
    row = rows[0]
    for field in ("flops", "bytes_accessed", "p50_ms",
                  "achieved_gbps", "utilization_pct"):
        if not isinstance(row[field], (int, float)):
            raise AssertionError(f"selftest row missing {field}: {row}")
    section = prof.to_dict()
    errors = validate_profile_section("profile", section)
    if errors:
        raise AssertionError(f"profile section invalid: {errors}")
    if json.dumps(section, sort_keys=True) != \
            json.dumps(prof.to_dict(), sort_keys=True):
        raise AssertionError("profile section is not deterministic")
    return section


__all__ = ["CARD_INT32_OPS_PER_S", "CARD_PEAK_GBPS", "HBM_PEAK_GBPS",
           "HOLD_CYCLES_PER_CALL", "MAX_PENDING", "ProgramProfiler",
           "ProgramRecord", "STRAW2_DRAW_OPS", "analytic_bitmatrix_cost",
           "analytic_crush_cost", "analytic_fused_repair_cost",
           "analytic_io_cost", "analytic_kernel_cost", "analytic_matrix_cost",
           "analytic_walk_cost", "analytic_xor_schedule_cost",
           "capture_enabled", "event_pair_overhead", "global_profiler",
           "hold_stream", "profile_entrypoints", "profiler_selftest",
           "resolve_peak_gbps", "roofline_ms", "set_capture_enabled",
           "set_global_profiler"]
