"""Continuous shape-bucketed batcher — ragged request streams onto
fixed-shape device calls, with no rebuild on a warm stream.

A port of ``ceph_tpu/serve/batcher.py``.  The data plane underneath
(codes/engine.py + ops/) holds one cached callable per (plugin,
profile, op, erasure pattern, device), and its kernels are built once
per process; a ragged serving stream maps onto it in the reference's
two ways:

- **Shape buckets** (dense).  Requests coalesce into buckets keyed like
  the PatternCache — (plugin class, profile, serve-op kind, available,
  erased) via :func:`~ceph_tpu_torch.codes.engine.pattern_key`, plus the
  chunk size — and the batch dimension is padded up a small fixed rung
  ladder (default 1/4/16/64).  Padding waste is counted per dispatch
  (``serve_padded_stripes`` / ``padded_bytes``).
- **Deadline-aware firing.**  A bucket fires when it reaches the top
  rung (full) or when its oldest request's slack — deadline minus now
  minus twice the bucket's EWMA service estimate — runs out.

**Paged mode** (``paged=True``) replaces the shape buckets with
per-(plugin, profile, op, pattern) queues over a bounded
:class:`~ceph_tpu_torch.serve.pool.PagedStripePool`: mixed stripe sizes
co-batch into one ragged dispatch per queue
(codes/engine.py :: serve_dispatch_ragged, the page mask as data to the
ragged kernel), the only padding is page-tail bytes, pool exhaustion is
the backpressure signal (fire + retry) and pages are reclaimed
explicitly at demux.

Execution goes through :func:`~ceph_tpu_torch.codes.engine.serve_dispatch_call`
/ ``serve_dispatch_ragged`` (``executor="device"``: instances on
``device``, the card unless the caller passes ``device="cpu"``; each
fire copies its stack or whole pool to the device once, and its
outputs back once) or the plugins' numpy batch surfaces
(``executor="host"``: instances on the CPU, pinned to the host tier).
Every dispatch is demuxed back to per-request
:class:`~ceph_tpu_torch.serve.queue.EcResult`\\ s; padded rows are
dropped on the host side, so batched results are byte-identical to
per-request execution by construction.  With a FakeClock and a
service model, the dispatch log and the SLO report equal the
reference's letter for letter.  The rung ladder is the best-config
table's when one is installed (:func:`tuned_ladder`).  Not ported: the
reference's service-jitter bisect seam.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.fallback import resolve_device
from ..telemetry import metrics as tel
from ..telemetry import span
from ..telemetry import tracing
from ..utils.detcheck import default_clock
from ..utils.errors import DeviceDispatchError
from ..utils.log import dout
from .pool import (PagedStripePool, PoolExhausted, effective_page_size,
                   tuned_pool_config)
from .queue import AdmissionQueue, EcRequest, EcResult

# padded stripe-batch sizes: every dispatch shape's batch dim is one
# of these, so steady-state traffic holds |ladder| programs per bucket
LADDER = (1, 4, 16, 64)


def tuned_ladder(default: Tuple[int, ...] = LADDER) -> Tuple[int, ...]:
    """The autotuner's rung-ladder consultation seam: the tuned ladder
    from the installed best-config table (kind ``serve-ladder``),
    validated strictly-increasing positive ints, else ``default``
    byte-identically.  Consulted at batcher construction only — a
    running batcher's ladder never changes underneath it."""
    from ..tune.table import consult
    cfg = consult("serve-ladder")
    if cfg:
        lad = cfg.get("ladder")
        try:
            t = tuple(int(x) for x in lad)
        except (TypeError, ValueError):
            return tuple(default)
        if t and all(x > 0 for x in t) and t == tuple(sorted(set(t))):
            return t
    return tuple(default)


# EWMA smoothing for the per-bucket service-time estimate
_EWMA_ALPHA = 0.3

# service-time jitter seam (replay_bisect's self-test): when set, each
# measured service time passes through this hook BEFORE the EWMA
# update, so the perturbation propagates into slack deadlines and
# changes downstream batch composition.  Signature:
# (service_s, dispatch_index) -> service_s.  Never set in production;
# ``ceph_tpu_torch.tools.replay_bisect`` installs a deterministic
# jitter on one run only and names the first divergent checkpoint.
_SERVICE_JITTER: Optional[Callable[[float, int], float]] = None


def set_service_jitter(
        fn: Optional[Callable[[float, int], float]]) -> None:
    """Install (or clear, with ``None``) the service-time jitter
    hook.  Test/bisect seam — see ``_SERVICE_JITTER`` above."""
    global _SERVICE_JITTER
    _SERVICE_JITTER = fn


# floor on the service estimate (seconds): a fresh bucket with no
# dispatch history must still fire BEFORE its deadline by enough to
# land the dispatch — with a zero estimate it would fire exactly at
# the deadline and the service time would push every completion past
# it (found by the first FakeClock scenario run)
_MIN_SLACK = 1e-3


def rung_for(n: int, ladder: Tuple[int, ...],
             strict: bool = False) -> int:
    """Smallest ladder rung holding ``n`` requests.  Occupancy above
    the top rung maps to the TOP rung — the batcher splits oversized
    admissions into top-rung batches instead of erroring (each slice
    its own warmed program, so the zero-recompile contract holds).
    ``strict=True`` restores the legacy erroring contract for callers
    that sized their admission path to the ladder."""
    for r in ladder:
        if n <= r:
            return r
    if strict:
        raise ValueError(f"occupancy {n} exceeds top rung {ladder[-1]}")
    return ladder[-1]


class _Bucket:
    """One shape bucket: same plugin/profile/op/pattern/chunk-size —
    same device program family."""

    __slots__ = ("key", "ec", "op", "available", "erased", "chunk_size",
                 "rows", "requests")

    def __init__(self, key, ec, op, available, erased, chunk_size,
                 rows) -> None:
        self.key = key
        self.ec = ec
        self.op = op
        self.available = available
        self.erased = erased
        self.chunk_size = chunk_size
        self.rows = rows
        self.requests: List[EcRequest] = []

    @property
    def oldest_deadline(self) -> float:
        return min(r.deadline for r in self.requests)


class _RaggedQueue:
    """One paged queue: same plugin/profile/op/pattern — same ragged
    device call, ANY chunk size (the shape-bucket collapse).  Owns the bounded page pool; ``chunk_size`` is the PAGE
    size and a firing "rung" is the live page count, so the
    ``(bucket, rung) -> seconds`` service-model contract carries over
    bytes-exact (rung * rows * chunk_size == live_pages * rows *
    page_size)."""

    __slots__ = ("key", "ec", "op", "available", "erased", "rows",
                 "page_size", "pool", "requests")

    def __init__(self, key, ec, op, available, erased, rows,
                 page_size, pool_pages) -> None:
        self.key = key
        self.ec = ec
        self.op = op
        self.available = available
        self.erased = erased
        self.rows = rows
        self.page_size = page_size
        self.pool = PagedStripePool(pool_pages, rows, page_size,
                                    ec.page_interleave())
        self.requests: List[EcRequest] = []

    @property
    def chunk_size(self) -> int:
        return self.page_size

    @property
    def oldest_deadline(self) -> float:
        return min(r.deadline for r in self.requests)


class ContinuousBatcher:
    """Coalesce an admission queue into shape-bucketed dispatches.

    ``executor``: ``"device"`` fires the cached ``serve_dispatch_call``
    / ``serve_dispatch_ragged`` callables on ``device`` (default: the
    card; :class:`~ceph_tpu_torch.utils.errors.NoDeviceError` when
    there is none and the caller did not pass ``device="cpu"``);
    ``"host"`` runs the numpy batch surfaces, its plugin instances on
    the CPU and pinned to the host tier.

    ``service_model``: optional ``(bucket, rung) -> seconds``
    deterministic service-time simulator.  When set, the clock is
    advanced by the model after each dispatch instead of measuring
    wall time — a seeded scenario on a FakeClock then produces
    byte-identical batch compositions AND SLO reports across runs
    (and equal to the reference's on the same seed).
    """

    def __init__(self, clock=None,
                 ladder: Optional[Tuple[int, ...]] = None,
                 executor: str = "device",
                 service_model: Optional[Callable] = None,
                 min_slack: float = _MIN_SLACK,
                 paged: bool = False,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 device=None) -> None:
        from ..utils.retry import SystemClock

        if ladder is None:
            ladder = tuned_ladder()
        if executor not in ("device", "host"):
            raise ValueError(f"executor {executor!r} must be "
                             f"device|host")
        # the host tier runs numpy on CPU instances; the device tier
        # runs on the card unless the caller asked for the CPU
        self.device = (torch.device("cpu") if executor == "host"
                       else resolve_device(device))
        if tuple(ladder) != tuple(sorted(set(ladder))):
            raise ValueError(f"ladder {ladder} must be strictly "
                             f"increasing")
        self.clock = clock if clock is not None \
            else default_clock("serve.batcher.ContinuousBatcher",
                               SystemClock)
        self.ladder = tuple(ladder)
        self.executor = executor
        self.service_model = service_model
        self.min_slack = min_slack
        self.paged = bool(paged)
        if self.paged:
            cfg_ps, cfg_pp = tuned_pool_config()
            self.page_size = (int(page_size) if page_size is not None
                              else cfg_ps)
            self.pool_pages = (int(pool_pages) if pool_pages is not None
                               else cfg_pp)
            if self.page_size < 1 or self.pool_pages < 1:
                raise ValueError(
                    f"page_size {self.page_size} / pool_pages "
                    f"{self.pool_pages} must be positive")
        else:
            self.page_size = page_size
            self.pool_pages = pool_pages
        self._instances: Dict[tuple, object] = {}
        self._buckets: "Dict[tuple, _Bucket]" = {}
        self._queues: "Dict[tuple, _RaggedQueue]" = {}
        # distinct programs this stream exercised: dense (key, rung)
        # pairs vs one key per paged queue — the collapse witness
        self._programs: set = set()
        self._est: Dict[tuple, float] = {}
        # per-dispatch composition log (bucket key, rung, req ids) —
        # the byte-identical-replay witness tests and the demo print
        self.dispatch_log: List[dict] = []
        self.dispatches = 0
        self.stripes = 0
        self.padded_stripes = 0
        self.padded_bytes = 0
        # paged-mode byte accounting: the only padding is page-tail
        # bytes, so overhead is byte-based, not stripe-based
        self.paged_tail_bytes = 0
        self.paged_data_bytes = 0
        self.warmup_dispatches = 0
        # the card's work never leaves the card: a fire whose supervised
        # dispatch raised DeviceDispatchError keeps its requests, in
        # order, and its unit is held (never due) until release_holds()
        # — the caller's word that the backend is back
        self._held: set = set()
        self.card_failures = 0

    # -- plugin instance + bucket resolution ----------------------------

    def _instance(self, plugin: str, profile: Dict[str, str]):
        pkey = (plugin, tuple(sorted((str(k), str(v))
                                     for k, v in profile.items())))
        ec = self._instances.get(pkey)
        if ec is None:
            from ..codes.registry import ErasureCodePluginRegistry

            ec = ErasureCodePluginRegistry.instance().factory(
                plugin, dict(profile), device=self.device)
            if self.executor == "host":
                # pin the numpy reference path: the host tier never
                # dispatches to a device at any batch size
                ec.min_xla_bytes = float("inf")
            self._instances[pkey] = ec
        return ec

    def bucket_key(self, req: EcRequest) -> tuple:
        """The bucket identity — the PatternCache key of the program
        the bucket will fire, extended with the chunk size (the only
        shape axis the pattern alone doesn't fix)."""
        from ..codes.engine import pattern_key

        ec = self._instance(req.plugin, req.profile)
        chunk = ec.get_chunk_size(req.stripe_size)
        return pattern_key(ec, f"serve-{req.op}", req.available,
                           req.erased, extra=(chunk,))

    def _bucket_for(self, req: EcRequest) -> _Bucket:
        key = self.bucket_key(req)
        b = self._buckets.get(key)
        if b is None:
            ec = self._instance(req.plugin, req.profile)
            chunk = ec.get_chunk_size(req.stripe_size)
            rows = (ec.get_data_chunk_count() if req.op == "encode"
                    else len(req.available))
            b = self._buckets[key] = _Bucket(
                key, ec, req.op, req.available, req.erased, chunk, rows)
        return b

    def ragged_key(self, req: EcRequest) -> tuple:
        """The paged-queue identity — the PatternCache key WITHOUT the
        chunk-size extra: mixed stripe sizes co-batch into one queue,
        one pool, ONE ragged device program."""
        from ..codes.engine import pattern_key

        ec = self._instance(req.plugin, req.profile)
        return pattern_key(ec, f"serve-{req.op}", req.available,
                           req.erased)

    def _queue_for(self, req: EcRequest) -> _RaggedQueue:
        key = self.ragged_key(req)
        q = self._queues.get(key)
        if q is None:
            ec = self._instance(req.plugin, req.profile)
            rows = (ec.get_data_chunk_count() if req.op == "encode"
                    else len(req.available))
            ps = effective_page_size(self.page_size, ec.page_unit())
            q = self._queues[key] = _RaggedQueue(
                key, ec, req.op, req.available, req.erased, rows, ps,
                self.pool_pages)
        return q

    # -- admission -------------------------------------------------------

    def admit(self, requests: List[EcRequest]) -> List[EcResult]:
        """Classify requests into buckets; a bucket reaching the top
        rung fires immediately (continuous batching — full buckets
        never wait for the next poll)."""
        if self.paged:
            return self._admit_paged(requests)
        results: List[EcResult] = []
        for req in requests:
            b = self._bucket_for(req)
            want = (b.rows, b.chunk_size)
            if tuple(req.payload.shape) != want:
                raise ValueError(
                    f"request {req.req_id}: payload shape "
                    f"{tuple(req.payload.shape)} != {want} for "
                    f"op={req.op} plugin={req.plugin}")
            b.requests.append(req)
            if req.trace is not None:
                # the request→bucket link: bucket identity ≡ device-
                # program identity, so the trace names the program
                # family it will ride before the batch even fires
                req.trace.add("bucket", self.clock.monotonic(),
                              bucket="|".join(str(p) for p in b.key),
                              pending=len(b.requests))
            if len(b.requests) >= self.ladder[-1]:
                results += self._fire(b)
        return results

    def _admit_paged(self, requests: List[EcRequest]) -> List[EcResult]:
        """Paged admission: stage each request's pages into its
        queue's pool.  A full pool is the backpressure signal — fire
        the queue NOW (demux reclaims every page), then retry the
        write; a pool with no free page left after a write fires too
        (continuous batching).  A single request no empty pool could
        hold raises ValueError (size the pool, don't wedge it)."""
        results: List[EcResult] = []
        for req in requests:
            q = self._queue_for(req)
            chunk = q.ec.get_chunk_size(req.stripe_size)
            want = (q.rows, chunk)
            if tuple(req.payload.shape) != want:
                raise ValueError(
                    f"request {req.req_id}: payload shape "
                    f"{tuple(req.payload.shape)} != {want} for "
                    f"op={req.op} plugin={req.plugin}")
            try:
                q.pool.write(req.req_id, req.payload)
            except PoolExhausted:
                results += self._fire_ragged(q)
                q.pool.write(req.req_id, req.payload)
            q.requests.append(req)
            if req.trace is not None:
                req.trace.add("bucket", self.clock.monotonic(),
                              bucket="|".join(str(p) for p in q.key),
                              pending=len(q.requests),
                              pages=q.pool.used_pages())
            if q.pool.free_pages() == 0:
                results += self._fire_ragged(q)
        return results

    # -- deadline-aware firing ------------------------------------------

    def est_service(self, key: tuple) -> float:
        """EWMA service-time estimate for the bucket's dispatches
        (seeded by the timed warmup dispatch, 0.0 for a bucket that
        never warmed)."""
        return self._est.get(key, 0.0)

    def _margin(self, key: tuple) -> float:
        """How far BEFORE its deadline a bucket must fire: twice the
        service estimate plus the floor.  Firing at exactly
        ``deadline - est`` puts every completion on the knife edge
        (any estimate error = a miss); the 2x margin lands the
        completion ~one service time early instead."""
        return 2.0 * self.est_service(key) + self.min_slack

    def _due(self, b, now: float) -> bool:
        if not b.requests or b.key in self._held:
            return False
        return b.oldest_deadline - now - self._margin(b.key) <= 0.0

    def _units(self):
        """Every fireable unit — dense buckets and paged queues (both
        carry key / requests / oldest_deadline, so the deadline-slack
        policy is mode-blind)."""
        yield from self._buckets.values()
        yield from self._queues.values()

    def _fire_unit(self, b) -> List[EcResult]:
        if isinstance(b, _RaggedQueue):
            reqs = list(b.requests)
            try:
                return self._fire_ragged(b)
            except DeviceDispatchError as e:
                return self._hold(b, reqs, e)
        return self._fire(b)

    def _hold(self, unit, reqs: List[EcRequest],
              err: DeviceDispatchError) -> List[EcResult]:
        """A fire failed on the card: its requests go back to the front
        of their unit, in order, and the unit is held."""
        unit.requests = list(reqs) + unit.requests
        self._held.add(unit.key)
        self.card_failures += 1
        tel.counter("serve_card_holds", op=unit.op)
        dout("serve", 1, f"fire of {len(reqs)} {unit.op} request(s) "
                         f"failed on the card; held ({err})")
        return []

    def held(self) -> int:
        """Requests held by a fire that failed on the card."""
        return sum(len(b.requests) for b in self._units()
                   if b.key in self._held)

    def release_holds(self) -> None:
        """Make the held units fireable again (the backend is back)."""
        self._held.clear()

    def poll(self, queue: Optional[AdmissionQueue] = None
             ) -> List[EcResult]:
        """One batcher turn: drain the queue, fire full buckets, then
        fire every bucket whose oldest request's slack has run out —
        earliest deadline first, so a tight-deadline bucket never
        queues behind a lazy one."""
        results: List[EcResult] = []
        if queue is not None:
            results += self.admit(queue.drain())
        now = self.clock.monotonic()
        due = sorted((b for b in self._units() if self._due(b, now)),
                     key=lambda b: b.oldest_deadline)
        for b in due:
            results += self._fire_unit(b)
        return results

    def flush(self) -> List[EcResult]:
        """Fire every non-empty bucket/queue (end of stream)."""
        results: List[EcResult] = []
        for b in sorted((b for b in self._units()
                         if b.requests and b.key not in self._held),
                        key=lambda b: b.oldest_deadline):
            results += self._fire_unit(b)
        return results

    def next_wakeup(self) -> Optional[float]:
        """Earliest absolute time any bucket becomes due (the sim
        event loop advances its FakeClock here when idle)."""
        times = [b.oldest_deadline - self._margin(b.key)
                 for b in self._units()
                 if b.requests and b.key not in self._held]
        return min(times) if times else None

    def pending(self) -> int:
        return sum(len(b.requests) for b in self._units())

    # -- dispatch --------------------------------------------------------

    @staticmethod
    def _fetch(op: str, out):
        """Device outputs -> op-shaped host arrays, one copy per fire
        (a repair's two outputs travel as one tensor)."""
        if op == "repair":
            rec, parity = out
            both = torch.cat([rec, parity], dim=1).cpu().numpy()
            n = rec.shape[1]
            return both[:, :n], both[:, n:]
        return out.cpu().numpy()

    def _execute(self, b: _Bucket, stack: np.ndarray):
        """One batched execution: the cached serve callable (device) or
        the numpy batch surfaces (host).  Returns op-shaped host
        arrays (the stack copied to the device once, the outputs back
        once)."""
        self._programs.add((b.key, stack.shape[0]))
        if self.executor == "device":
            from ..codes.engine import serve_dispatch_call

            call = serve_dispatch_call(b.ec, b.op, b.available, b.erased)
            return self._fetch(b.op, call(
                torch.from_numpy(stack).to(b.ec.device)))
        # host tier: numpy end to end (the trace still names the
        # program family it rode, "serve.host")
        if tracing.enabled():
            tracing.note_program(
                "serve.host", {"op": b.op,
                               "plugin": type(b.ec).__name__})
        if b.op == "encode":
            return np.asarray(b.ec.encode_chunks_batch(stack))
        if b.op == "decode":
            return np.asarray(b.ec.decode_chunks_batch(
                stack, b.available, b.erased))
        return _host_repair(b.ec, stack, b.available, b.erased)

    def _fire(self, b: _Bucket) -> List[EcResult]:
        """Fire a bucket; occupancy above the top rung (an oversized
        admission burst) is split into top-rung slices — every slice
        rides an already-warmed program, so the legacy hard error is
        gone without any new shape."""
        reqs, b.requests = b.requests, []
        results: List[EcResult] = []
        top = self.ladder[-1]
        while reqs:
            take, reqs = reqs[:top], reqs[top:]
            try:
                results += self._fire_slice(b, take)
            except DeviceDispatchError as e:
                return results + self._hold(b, take + reqs, e)
        return results

    def _fire_slice(self, b: _Bucket,
                    reqs: List[EcRequest]) -> List[EcResult]:
        n = len(reqs)
        rung = rung_for(n, self.ladder)
        stack = np.zeros((rung, b.rows, b.chunk_size), np.uint8)
        for i, r in enumerate(reqs):
            stack[i] = r.payload
        traced = (tracing.enabled()
                  and any(r.trace is not None for r in reqs))
        if traced:
            tracing.clear_program()
        t0 = self.clock.monotonic()
        with span("serve.batch", op=b.op, occupancy=n, rung=rung,
                  plugin=type(b.ec).__name__):
            with span("serve.dispatch", executor=self.executor):
                out = self._execute(b, stack)
            if self.service_model is not None:
                # sim mode: deterministic service time instead of wall
                # time — byte-identical SLO reports from a seed
                self.clock.sleep(self.service_model(b, rung))
        t1 = self.clock.monotonic()
        service = t1 - t0
        if _SERVICE_JITTER is not None:
            service = _SERVICE_JITTER(service, self.dispatches)
        self._est[b.key] = (service if b.key not in self._est else
                            (1 - _EWMA_ALPHA) * self._est[b.key]
                            + _EWMA_ALPHA * service)
        self.dispatches += 1
        self.stripes += n
        pad = rung - n
        self.padded_stripes += pad
        self.padded_bytes += pad * b.rows * b.chunk_size
        tel.counter("serve_dispatches", op=b.op)
        tel.counter("serve_stripes", n, op=b.op)
        if pad:
            tel.counter("serve_padded_stripes", pad, op=b.op)
        tel.observe("serve_batch_occupancy", n, op=b.op)
        self.dispatch_log.append({
            "bucket": "|".join(str(p) for p in b.key),
            "op": b.op, "occupancy": n, "rung": rung,
            "req_ids": [r.req_id for r in reqs]})
        results = []
        for i, r in enumerate(reqs):
            if b.op == "repair":
                rec, parity = out
                payload_out = (rec[i], parity[i])
            else:
                payload_out = out[i]
            wait = t0 - (r.arrival if r.arrival is not None else t0)
            tel.observe("serve_queue_wait_seconds", max(0.0, wait),
                        op=b.op)
            results.append(EcResult(
                request=r, output=payload_out, completed=t1,
                queue_wait=max(0.0, wait), service=service,
                batch_occupancy=n, batch_rung=rung,
                deadline_met=(r.deadline is None or t1 <= r.deadline)))
        if traced:
            # the fire decision + the program the batch rode + the
            # per-request demux completion, stamped on the SAME clock
            # as the SLO ledger (on a FakeClock t_done == t1 — demux
            # is host bookkeeping, charged only on the real clock)
            program = tracing.take_program()
            batch_seq = self.dispatches - 1
            t_done = self.clock.monotonic()
            for r, res in zip(reqs, results):
                tr = r.trace
                if tr is None:
                    continue
                tr.add("fire", t0, occupancy=n, rung=rung,
                       batch_seq=batch_seq, executor=self.executor,
                       co_batched=[q.req_id for q in reqs])
                if program is not None:
                    tr.add("program", t0, series=program)
                tr.add("dispatch_end", t1)
                tr.add("done", t_done,
                       deadline_met=res.deadline_met)
        return results

    # -- ragged dispatch -------------------------------------------------

    def _execute_ragged(self, q: _RaggedQueue, mask: np.ndarray):
        """One ragged execution over the queue's WHOLE pool: the
        mask-gated cached callable (device,
        engine.serve_dispatch_ragged) or the identical masked numpy
        batch surfaces (host).  Either way the call consumes
        ``(pages, rows, page_size) + (pages,)`` with the mask as data —
        one cached callable per queue at any occupancy.  The device
        tier copies the whole host pool (dead pages included) and its
        mask to the card on every fire, as the reference hands its
        program the host buffer."""
        self._programs.add(q.key)
        if self.executor == "device":
            from ..codes.engine import serve_dispatch_ragged

            call = serve_dispatch_ragged(
                q.ec, q.op, q.available, q.erased,
                pages=q.pool.pages, page_size=q.page_size)
            dev = q.ec.device
            return self._fetch(q.op, call(
                torch.from_numpy(q.pool.buf).to(dev),
                torch.from_numpy(mask).to(dev)))
        if tracing.enabled():
            tracing.note_program(
                "serve.host", {"op": q.op, "paged": True,
                               "plugin": type(q.ec).__name__})
        # the host tier runs the IDENTICAL ragged program: mask-gate
        # the pool (dead pages carry stale bytes), then the batch
        # surfaces over pages-as-mini-chunks
        x = q.pool.buf * (mask != 0).astype(np.uint8)[:, None, None]
        if q.op == "encode":
            return np.asarray(q.ec.encode_chunks_batch(x))
        if q.op == "decode":
            return np.asarray(q.ec.decode_chunks_batch(
                x, q.available, q.erased))
        return _host_repair(q.ec, x, q.available, q.erased)

    def _fire_ragged(self, q: _RaggedQueue) -> List[EcResult]:
        reqs, q.requests = q.requests, []
        if not reqs:
            return []
        n = len(reqs)
        mask = q.pool.mask()
        live = int(mask.sum())
        traced = (tracing.enabled()
                  and any(r.trace is not None for r in reqs))
        if traced:
            tracing.clear_program()
        t0 = self.clock.monotonic()
        with span("serve.batch", op=q.op, occupancy=n, rung=live,
                  plugin=type(q.ec).__name__, paged=True):
            with span("serve.dispatch", executor=self.executor):
                out = self._execute_ragged(q, mask)
            if self.service_model is not None:
                # sim mode: the rung is the live page count, so the
                # modeled bytes (live * rows * page_size) are EXACT —
                # no padded-rung bytes in the model either
                self.clock.sleep(self.service_model(q, live))
        t1 = self.clock.monotonic()
        service = t1 - t0
        if _SERVICE_JITTER is not None:
            service = _SERVICE_JITTER(service, self.dispatches)
        self._est[q.key] = (service if q.key not in self._est else
                            (1 - _EWMA_ALPHA) * self._est[q.key]
                            + _EWMA_ALPHA * service)
        self.dispatches += 1
        self.stripes += n
        # the ONLY padding in the paged path: per-request page-tail
        # bytes (zero whenever page_size divides the chunk size)
        tail_cols = sum(q.pool.tail_bytes(r.req_id) for r in reqs)
        self.padded_bytes += tail_cols * q.rows
        self.paged_tail_bytes += tail_cols * q.rows
        self.paged_data_bytes += sum(
            r.payload.shape[1] * q.rows for r in reqs)
        tel.counter("serve_dispatches", op=q.op)
        tel.counter("serve_stripes", n, op=q.op)
        if tail_cols:
            tel.counter("serve_page_tail_bytes", tail_cols * q.rows,
                        op=q.op)
        tel.observe("serve_batch_occupancy", n, op=q.op)
        tel.observe("serve_pool_live_pages", live, op=q.op)
        self.dispatch_log.append({
            "bucket": "|".join(str(p) for p in q.key),
            "op": q.op, "occupancy": n, "rung": live,
            "req_ids": [r.req_id for r in reqs], "paged": True})
        results = []
        for r in reqs:
            if q.op == "repair":
                rec, parity = out
                payload_out = (q.pool.read(r.req_id, rec),
                               q.pool.read(r.req_id, parity))
            else:
                payload_out = q.pool.read(r.req_id, out)
            wait = t0 - (r.arrival if r.arrival is not None else t0)
            tel.observe("serve_queue_wait_seconds", max(0.0, wait),
                        op=q.op)
            results.append(EcResult(
                request=r, output=payload_out, completed=t1,
                queue_wait=max(0.0, wait), service=service,
                batch_occupancy=n, batch_rung=live,
                deadline_met=(r.deadline is None or t1 <= r.deadline)))
            # explicit page reclaim at demux — the pool is empty again
            # the moment every rider has its bytes back
            q.pool.reclaim(r.req_id)
        if traced:
            program = tracing.take_program()
            batch_seq = self.dispatches - 1
            t_done = self.clock.monotonic()
            for r, res in zip(reqs, results):
                tr = r.trace
                if tr is None:
                    continue
                tr.add("fire", t0, occupancy=n, rung=live,
                       batch_seq=batch_seq, executor=self.executor,
                       paged=True,
                       co_batched=[x.req_id for x in reqs])
                if program is not None:
                    tr.add("program", t0, series=program)
                tr.add("dispatch_end", t1)
                tr.add("done", t_done,
                       deadline_met=res.deadline_met)
        return results

    # -- warmup ----------------------------------------------------------

    def warmup(self, requests: List[EcRequest]) -> int:
        """Warm the whole bucket ladder for every distinct bucket the
        request list will touch: one zero-filled dispatch per (bucket,
        rung) builds every cache entry, loads every kernel and uploads
        every kernel datum the stream needs.  After this, a stream drawn
        from the same mix builds nothing — the armed recompile budget
        and the kernel-setup count both stay flat.  Returns the number
        of warmup dispatches.

        Paged mode warms one callable per queue instead of |ladder| per
        bucket — the activity mask is data, so one entry covers every
        occupancy."""
        if self.paged:
            return self._warmup_paged(requests)
        seen = set()
        fired = 0
        for req in requests:
            key = self.bucket_key(req)
            if key in seen:
                continue
            seen.add(key)
            b = self._bucket_for(req)
            for rung in self.ladder:
                zeros = np.zeros((rung, b.rows, b.chunk_size), np.uint8)
                self._warm(lambda: self._execute(b, zeros))
                fired += 1
            # seed the service estimator with a timed WARM dispatch of
            # the top rung (the first run above paid the setup, so
            # this measures steady-state service) —
            # deadline-slack firing then has an honest worst-case
            # estimate before the first real request is at stake.  In
            # sim mode the model is the estimator; skip the extra
            # dispatch and don't touch the sim clock.
            if self.service_model is not None:
                self._est[key] = self.service_model(b, self.ladder[-1])
            else:
                top = np.zeros((self.ladder[-1], b.rows, b.chunk_size),
                               np.uint8)
                t0 = self.clock.monotonic()
                if self._warm(lambda: self._execute(b, top)):
                    self._est[key] = self.clock.monotonic() - t0
                fired += 1
        self.warmup_dispatches += fired
        if fired:
            tel.counter("serve_warmup_dispatches", fired)
            dout("serve", 10,
                 f"warmed {len(seen)} buckets x {len(self.ladder)} "
                 f"rungs ({fired} dispatches)")
        return fired

    def _warm(self, run: Callable[[], object]) -> bool:
        """One warm dispatch; one that fails on the card is counted,
        not held (no request rides it)."""
        try:
            run()
            return True
        except DeviceDispatchError as e:
            self.card_failures += 1
            dout("serve", 1, f"warm dispatch failed on the card ({e})")
            return False

    def _warmup_paged(self, requests: List[EcRequest]) -> int:
        """One zero-mask dispatch per distinct queue pays the setup;
        a second (full-mask, zero pool) dispatch times steady-state
        service for the deadline-slack estimator (the sim model is the
        estimator in sim mode, as on the dense path)."""
        seen = set()
        fired = 0
        for req in requests:
            key = self.ragged_key(req)
            if key in seen:
                continue
            seen.add(key)
            q = self._queue_for(req)
            self._warm(lambda: self._execute_ragged(
                q, np.zeros(q.pool.pages, np.uint8)))
            fired += 1
            if self.service_model is not None:
                self._est[key] = self.service_model(q, q.pool.pages)
            else:
                full = np.ones(q.pool.pages, np.uint8)
                t0 = self.clock.monotonic()
                if self._warm(lambda: self._execute_ragged(q, full)):
                    self._est[key] = self.clock.monotonic() - t0
                fired += 1
        self.warmup_dispatches += fired
        if fired:
            tel.counter("serve_warmup_dispatches", fired)
            dout("serve", 10,
                 f"warmed {len(seen)} paged queues ({fired} "
                 f"dispatches, one program each)")
        return fired

    # -- accounting ------------------------------------------------------

    def cached_program_count(self) -> int:
        """Distinct programs this batcher's stream exercised, counted as
        the reference counts them: dense = (bucket, rung) pairs, paged =
        one per queue (every occupancy and chunk size shares one) — the
        program-count collapse the paged path exists for."""
        return len(self._programs)

    def pool_stats(self) -> dict:
        """Aggregate page-pool accounting across the paged queues
        (live occupancy feeds the bench serving rows)."""
        qs = list(self._queues.values())
        return {
            "queues": len(qs),
            "pages": sum(q.pool.pages for q in qs),
            "used_pages": sum(q.pool.used_pages() for q in qs),
            "high_water": sum(q.pool.high_water for q in qs),
            "allocs": sum(q.pool.allocs for q in qs),
            "reclaims": sum(q.pool.reclaims for q in qs),
            "backpressure": sum(q.pool.backpressure for q in qs),
        }

    def padding_stats(self) -> dict:
        if self.paged:
            total = self.paged_data_bytes + self.paged_tail_bytes
            return {
                "dispatches": self.dispatches,
                "stripes": self.stripes,
                # paged mode never pads whole stripes; overhead is the
                # byte-based page-tail ratio (0.0 when the page size
                # divides every chunk size in the mix)
                "padded_stripes": 0,
                "padded_bytes": self.padded_bytes,
                "padding_overhead": (
                    round(self.paged_tail_bytes / total, 6)
                    if total else 0.0),
                "warmup_dispatches": self.warmup_dispatches,
                "paged": True,
                "cached_programs": self.cached_program_count(),
                "pool": self.pool_stats(),
            }
        total = self.stripes + self.padded_stripes
        return {
            "dispatches": self.dispatches,
            "stripes": self.stripes,
            "padded_stripes": self.padded_stripes,
            "padded_bytes": self.padded_bytes,
            "padding_overhead": (round(self.padded_stripes / total, 6)
                                 if total else 0.0),
            "warmup_dispatches": self.warmup_dispatches,
            "paged": False,
            "cached_programs": self.cached_program_count(),
        }


def _host_repair(ec, stack: np.ndarray, available: Tuple[int, ...],
                 erased: Tuple[int, ...]):
    """Numpy mirror of engine.fused_repair_call: decode the erased
    shards, assemble the data chunks from survivor and decoded columns
    by index, re-encode the full parity set.  Byte-identical to the
    device call by construction (same surfaces, same column
    assembly)."""
    from ..codes.stripe import _chunk_mapping

    rec = np.asarray(ec.decode_chunks_batch(stack, available, erased))
    mapping = _chunk_mapping(ec)
    aidx = {s: t for t, s in enumerate(available)}
    eidx = {s: t for t, s in enumerate(erased)}
    cols = []
    for c in range(ec.get_data_chunk_count()):
        shard = mapping[c]
        if shard in aidx:
            cols.append(stack[:, aidx[shard], :])
        elif shard in eidx:
            cols.append(rec[:, eidx[shard], :])
        else:
            raise IOError(
                f"data shard {shard} neither available nor erased "
                f"(avail={available}, erased={erased})")
    data = np.stack(cols, axis=1)
    parity = np.asarray(ec.encode_chunks_batch(data))
    return rec, parity
