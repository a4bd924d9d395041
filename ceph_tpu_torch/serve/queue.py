"""EcRequest + the admission queue — the serving front door.

Production traffic is a *stream* of mixed requests, not a pre-stacked
batch: every request names an op (encode / decode / repair), a plugin
profile, a stripe size and a deadline.  This module is the host-side
front door for that stream:

- :class:`EcRequest` — one erasure-coding request.  The payload is the
  op's natural array form (encode: the ``(k, C)`` data chunks;
  decode/repair: the ``(n_avail, C)`` survivors plus the
  available/erased pattern), so the batcher can stack same-shaped
  requests into one device dispatch without reshaping.
- :class:`AdmissionQueue` — a bounded FIFO with an injectable clock.
  ``submit`` stamps the arrival time, applies the per-op default
  deadline from the :class:`~ceph_tpu_torch.serve.sla.SloPolicy` when the
  request carries none, and REJECTS (never blocks, never drops
  silently) once the queue is at capacity — the classic
  admission-control contract: under overload the system sheds load at
  the front door with a counted, observable refusal instead of letting
  queue waits blow every deadline downstream.

Everything here is host bookkeeping.  A copy of
``ceph_tpu/serve/queue.py``.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import metrics as tel
from ..telemetry import tracing
from ..utils.locks import make_lock

OPS = ("encode", "decode", "repair")

_req_ids = itertools.count()


@dataclass
class EcRequest:
    """One erasure-coding request in the serving stream.

    ``payload`` shape by op (C = chunk bytes for the profile at
    ``stripe_size``):

    - ``encode``: ``(k, C)`` data chunks → result: ``(m, C)`` parity
    - ``decode``: ``(n_avail, C)`` survivors (plugin shard order) →
      result: ``(n_erased, C)`` reconstructed chunks
    - ``repair``: same input as decode → result:
      ``(decoded (n_erased, C), parity (m, C))`` — the fused
      decode→re-encode the scrub write-back gate needs
    """

    op: str
    plugin: str
    profile: Dict[str, str]
    stripe_size: int
    payload: np.ndarray
    available: Tuple[int, ...] = ()
    erased: Tuple[int, ...] = ()
    # absolute deadline on the serving clock; None = stamped at admit
    # from the SloPolicy's per-op default
    deadline: Optional[float] = None
    req_id: int = field(default_factory=lambda: next(_req_ids))
    # stamped by AdmissionQueue.submit
    arrival: Optional[float] = None
    # logical stripe bytes this request moves (the GB/s numerator);
    # defaults to the payload's data bytes for encode, k*C for
    # decode/repair is set by the loadgen/batcher via work_bytes
    work_bytes: int = 0
    # ground truth for --validate paths (demo/tests only; the server
    # never reads it)
    expect: object = None
    # causal-trace context (telemetry/tracing.py), minted at admission
    # when a collector is installed AND the deterministic sampling
    # draw passes; None otherwise — every downstream hook gates on it
    trace: object = None
    # multi-tenant scenarios (scenario/week.py): the tenant this
    # request bills against; "" = the single-tenant legacy streams,
    # where nothing downstream consults it
    tenant: str = ""

    def __post_init__(self) -> None:
        if self.op not in OPS:
            raise ValueError(f"op {self.op!r} not in {OPS}")
        if self.op in ("decode", "repair") and not self.erased:
            raise ValueError(f"{self.op} request needs an erased pattern")
        self.available = tuple(self.available)
        self.erased = tuple(self.erased)
        if not self.work_bytes:
            self.work_bytes = int(self.payload.nbytes)


@dataclass
class EcResult:
    """One served request: the output plus the latency breakdown the
    SLO evaluation consumes."""

    request: EcRequest
    output: object
    completed: float            # absolute clock time the batch landed
    queue_wait: float           # arrival → dispatch start
    service: float              # dispatch start → completion
    batch_occupancy: int        # real requests in the fired bucket
    batch_rung: int             # padded stripe-batch size dispatched
    deadline_met: bool = True

    @property
    def latency(self) -> float:
        return self.queue_wait + self.service


class AdmissionQueue:
    """Bounded FIFO admission queue with an injectable clock.

    ``submit`` returns False (and counts ``serve_rejected``) when the
    queue is full — backpressure by refusal, the only honest answer a
    deadline-driven front-end can give under overload.  The batcher
    drains the queue on every poll; per-request queue waits are
    measured from the ``arrival`` stamp set here.
    """

    def __init__(self, clock=None, capacity: int = 4096,
                 slo=None) -> None:
        from .sla import SloPolicy
        from ..utils.detcheck import default_clock
        from ..utils.retry import SystemClock

        self.clock = clock if clock is not None \
            else default_clock("serve.queue.AdmissionQueue",
                               SystemClock)
        self.capacity = capacity
        self.slo = slo if slo is not None else SloPolicy()
        self._lock = make_lock("serve.queue.AdmissionQueue._lock")
        self._pending: Deque[EcRequest] = deque()
        self.admitted = 0
        self.rejected = 0

    def submit(self, req: EcRequest) -> bool:
        now = self.clock.monotonic()
        # telemetry is emitted AFTER the lock drops: counter/event
        # take the registry and recorder locks, and the admission lock
        # is the hottest in the serve path — holding it across another
        # lock's critical section stretches every competing submit()
        with self._lock:
            depth = len(self._pending)
            admitted_now = depth < self.capacity
            if admitted_now:
                req.arrival = now
                if req.deadline is None:
                    req.deadline = now + self.slo.deadline_for(req.op)
                self._pending.append(req)
                self.admitted += 1
                depth += 1
            else:
                self.rejected += 1
        if not admitted_now:
            # serve_rejected carries tenant + reason so multi-tenant
            # overload shedding is attributable at the door (the SLO
            # ledger separately counts the reject as a miss —
            # serve/sla.py::record_reject — so shedding can never
            # flatter the miss rate)
            tel.counter("serve_rejected", op=req.op,
                        tenant=req.tenant, reason="capacity")
            tel.event("serve_admission_reject", op=req.op,
                      req_id=req.req_id, depth=depth,
                      tenant=req.tenant, reason="capacity")
            return False
        tel.counter("serve_admitted", op=req.op)
        tel.gauge("serve_queue_depth", depth)
        # causal trace minted AT admission (outside the queue lock —
        # minting is collector bookkeeping): the trace's first event
        # is the same `arrival` stamp the SLO ledger measures from
        if tracing.enabled():
            tracing.mint(req)
        return True

    def drain(self) -> List[EcRequest]:
        """Pop everything pending, arrival order (the batcher calls
        this each poll; bucket membership, not queue position, decides
        dispatch order from here)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        if out:
            # gauge emitted outside the lock (registry lock nests
            # under it otherwise; same discipline as submit)
            tel.gauge("serve_queue_depth", 0)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)
