"""Per-op-class SLO policy and evaluation.

A copy of ``ceph_tpu/serve/sla.py``.

Two halves:

- :class:`SloPolicy` — the declarative side: per-op-class deadline
  defaults (seconds of slack a request gets when it arrives without
  an explicit deadline) and latency objectives (the p99 targets the
  report grades against).  The batcher's deadline-aware dispatch reads
  ``deadline_for``; nothing else in the data plane consults the
  policy.
- :class:`SlaRecorder` — the measuring side: every
  :class:`~ceph_tpu_torch.serve.queue.EcResult` lands here.  Latency
  percentiles ride :class:`~ceph_tpu_torch.telemetry.LatencyHistogram`
  per op class (exact-at-the-edges p50/p99/p999, the same machinery
  every bench row uses), deadline misses and bytes-under-SLO are
  counted per class, and ``report()`` folds them into one
  deterministic dict: sorted keys, derived rates rounded — two runs
  of the same seeded scenario on a FakeClock serialize
  byte-identically, and identically to the reference's.

GB/s-under-SLO is the serving headline: ONLY the bytes of requests
that met their deadline count in the numerator, over wall-clock
elapsed — throughput you could have promised, not throughput you
happened to reach.  A padded dispatch that blows deadlines buys
nothing here, which is exactly the tension the bucket ladder +
slack-based firing is tuned against.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..telemetry import LatencyHistogram
from ..telemetry import metrics as tel
from .queue import OPS, EcResult

# generous host-scale defaults; serving scenarios set their own
DEFAULT_DEADLINES = {"encode": 0.200, "decode": 0.200, "repair": 0.500}

# burn-rate defaults (the reference's docs/OBSERVABILITY.md "Burn-rate
# windows"): the SRE error-budget discipline on request-count windows (deterministic
# under FakeClock — a wall-clock window would make seeded scenarios
# timing-dependent).  budget = the tolerated steady-state deadline-miss
# rate; a window trips when its rolling miss rate reaches
# budget × burn — the short window catches a sharp cliff in ~1 bucket
# flight, the long window catches a slow leak that never spikes.
DEFAULT_MISS_BUDGET = 0.02
DEFAULT_BURN_WINDOWS: Tuple[Tuple[int, float], ...] = (
    (64, 4.0),     # fast burn: >=8% misses over the last 64 requests
    (512, 1.5),    # slow burn: >=3% misses over the last 512
)


class BurnRateMonitor:
    """Rolling-window deadline-miss burn-rate monitor.

    Feeds from :meth:`SlaRecorder.record`; when a window's miss rate
    reaches ``budget × burn`` (window full — a half-warm window never
    alarms), the monitor counts ``serve_slo_burn_trips``, emits a
    structured event, and freezes a flight-recorder post-mortem
    (telemetry/recorder.py) so the batch composition / padding /
    queue-depth evidence survives the incident.  Each window re-arms
    only after its miss rate falls back below threshold — a sustained
    breach is ONE trip, not one per request.
    """

    def __init__(self, budget: float = DEFAULT_MISS_BUDGET,
                 windows: Tuple[Tuple[int, float], ...] =
                 DEFAULT_BURN_WINDOWS) -> None:
        if not 0.0 < budget < 1.0:
            raise ValueError(f"miss budget {budget} must be in (0, 1)")
        self.budget = budget
        self._windows = [{"size": int(s), "burn": float(b),
                          "buf": deque(maxlen=int(s)), "misses": 0,
                          "armed": True}
                         for s, b in windows]
        self.trips: List[dict] = []

    def record(self, op: str, deadline_met: bool) -> List[dict]:
        """Fold one served request in; returns the trips it fired."""
        miss = 0 if deadline_met else 1
        fired: List[dict] = []
        for w in self._windows:
            buf = w["buf"]
            if len(buf) == buf.maxlen:
                w["misses"] -= buf[0]
            buf.append(miss)
            w["misses"] += miss
            if len(buf) < buf.maxlen:
                continue
            rate = w["misses"] / len(buf)
            threshold = self.budget * w["burn"]
            if rate >= threshold:
                if w["armed"]:
                    w["armed"] = False
                    trip = {"window": w["size"], "burn": w["burn"],
                            "miss_rate": round(rate, 6),
                            "threshold": round(threshold, 6),
                            "budget": self.budget, "op": op}
                    self.trips.append(trip)
                    fired.append(trip)
                    self._on_trip(trip)
            else:
                w["armed"] = True
        return fired

    def _on_trip(self, trip: dict) -> None:
        tel.counter("serve_slo_burn_trips", window=str(trip["window"]))
        tel.event("slo_burn", **trip)
        from ..telemetry import recorder
        recorder.trip(
            "slo_burn",
            f"deadline-miss burn: {trip['miss_rate']:.4f} over "
            f"last {trip['window']} >= {trip['threshold']:.4f} "
            f"({trip['burn']}x budget {trip['budget']})",
            **trip)


@dataclass(frozen=True)
class SloPolicy:
    """Per-op-class service-level objectives.

    ``deadlines``: seconds of slack granted at admission when the
    request has no explicit deadline.  ``p99_targets`` (optional):
    latency objectives the report grades against (informational —
    dispatch uses deadlines, not percentiles).
    """

    deadlines: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_DEADLINES))
    p99_targets: Dict[str, float] = field(default_factory=dict)

    def deadline_for(self, op: str) -> float:
        if op not in OPS:
            raise ValueError(f"op {op!r} not in {OPS}")
        return self.deadlines.get(op, DEFAULT_DEADLINES[op])


class SlaRecorder:
    """Accumulates served results into the per-op-class SLO ledger."""

    def __init__(self, policy: Optional[SloPolicy] = None,
                 monitor: Optional[BurnRateMonitor] = None) -> None:
        self.policy = policy if policy is not None else SloPolicy()
        # the burn-rate monitor rides every recorder by default: SLO
        # breaches must page (and flight-dump) in production, not only
        # when someone remembered to wire a monitor
        self.monitor = monitor if monitor is not None \
            else BurnRateMonitor()
        self._hist: Dict[str, LatencyHistogram] = {}
        self._wait: Dict[str, LatencyHistogram] = {}
        self.count: Dict[str, int] = {}
        self.misses: Dict[str, int] = {}
        self.ok_bytes: Dict[str, int] = {}
        self.total_bytes: Dict[str, int] = {}
        # rejected-at-the-door accounting: op -> reason ->
        # count.  A reject IS a deadline miss — the request got
        # nothing by its deadline — so report() folds these into the
        # miss-rate denominators; a recorder that never sees a reject
        # reports byte-identically to before.
        self.rejects: Dict[str, Dict[str, int]] = {}
        # per-tenant scorecard ledgers ("" requests bill no tenant)
        self._tenant: Dict[str, dict] = {}

    def _tenant_slot(self, name: str) -> dict:
        t = self._tenant.get(name)
        if t is None:
            t = self._tenant[name] = {
                "hist": LatencyHistogram(), "count": 0, "misses": 0,
                "ok_bytes": 0, "total_bytes": 0, "rejects": {}}
        return t

    def record_reject(self, req, reason: str = "capacity") -> None:
        """Fold one front-door rejection into the ledger: counted as
        a deadline miss against its op class AND its tenant, never
        silently shed."""
        op = req.op
        by_reason = self.rejects.setdefault(op, {})
        by_reason[reason] = by_reason.get(reason, 0) + 1
        self.monitor.record(op, False)
        tenant = getattr(req, "tenant", "")
        if tenant:
            t = self._tenant_slot(tenant)
            t["rejects"][reason] = t["rejects"].get(reason, 0) + 1
        tel.counter("serve_deadline_miss", op=op, rejected="1")

    def record(self, result: EcResult) -> None:
        op = result.request.op
        self.monitor.record(op, result.deadline_met)
        h = self._hist.get(op)
        if h is None:
            h = self._hist[op] = LatencyHistogram()
            self._wait[op] = LatencyHistogram()
            self.count[op] = self.misses[op] = 0
            self.ok_bytes[op] = self.total_bytes[op] = 0
        # exemplar link: a traced request's latency sample carries its
        # trace id, so the report's p99+ exemplars point straight at
        # the causal trace that explains them.  With tracing off, trace is None
        # and the histograms dump byte-identically to before.
        trace = getattr(result.request, "trace", None)
        tid = trace.trace_id if trace is not None else None
        h.record(result.latency, exemplar=tid)
        self._wait[op].record(result.queue_wait)
        self.count[op] += 1
        self.total_bytes[op] += result.request.work_bytes
        if result.deadline_met:
            self.ok_bytes[op] += result.request.work_bytes
        else:
            self.misses[op] += 1
            tel.counter("serve_deadline_miss", op=op)
        # mirror into the unified metrics plane (perf dump / prom)
        tel.observe("serve_request_seconds", result.latency,
                    exemplar=tid, op=op)
        tenant = getattr(result.request, "tenant", "")
        if tenant:
            t = self._tenant_slot(tenant)
            t["hist"].record(result.latency, exemplar=tid)
            t["count"] += 1
            t["total_bytes"] += result.request.work_bytes
            if result.deadline_met:
                t["ok_bytes"] += result.request.work_bytes
            else:
                t["misses"] += 1

    # -- readout ---------------------------------------------------------

    def _pcts(self, hist: Optional[LatencyHistogram]) -> dict:
        if hist is None or not hist.count:
            return {"p50_ms": None, "p99_ms": None, "p999_ms": None}
        p = hist.percentiles()
        return {"p50_ms": round(p["p50"] * 1e3, 6),
                "p99_ms": round(p["p99"] * 1e3, 6),
                "p999_ms": round(p["p999"] * 1e3, 6)}

    def report(self, elapsed: float,
               padding: Optional[dict] = None) -> dict:
        """The serving scorecard: per-op-class latency percentiles,
        deadline-miss rates and GB/s-under-SLO, plus the overall roll-
        up (and the batcher's padding accounting when provided).
        Deterministic: dict insertion order is sorted, every derived
        float is rounded."""
        ops = sorted(set(self.count) | set(self.rejects))
        per_op = {}
        for op in ops:
            n = self.count.get(op, 0)
            rej = sum(self.rejects.get(op, {}).values())
            denom = n + rej
            per_op[op] = {
                "requests": n,
                "deadline_miss_rate": (
                    round((self.misses.get(op, 0) + rej) / denom, 6)
                    if denom else None),
                "bytes": self.total_bytes.get(op, 0),
                "gbps_under_slo": (
                    round(self.ok_bytes.get(op, 0) / elapsed / 1e9, 6)
                    if elapsed > 0 else None),
                **self._pcts(self._hist.get(op)),
                "queue_wait": self._pcts(self._wait.get(op)),
            }
            if rej:
                # rejects fold into the miss rate above; the key only
                # appears when a reject happened, so legacy reports
                # serialize byte-identically
                per_op[op]["rejected"] = dict(
                    sorted(self.rejects[op].items()))
            if op not in self.count:
                continue
            exemplars = self._hist[op].exemplars()
            if exemplars:
                # top-quantile samples with their trace ids (only
                # traced runs capture any — the report shape is
                # unchanged otherwise)
                per_op[op]["p99_exemplars"] = [
                    {"latency_ms": round(e["value"] * 1e3, 6),
                     "trace_id": e["trace_id"]} for e in exemplars]
            target = self.policy.p99_targets.get(op)
            if target is not None:
                p99 = per_op[op]["p99_ms"]
                per_op[op]["p99_target_ms"] = round(target * 1e3, 6)
                per_op[op]["p99_met"] = (p99 is not None
                                         and p99 <= target * 1e3)
        total = sum(self.count.values())
        total_bytes = sum(self.total_bytes.values())
        ok_bytes = sum(self.ok_bytes.values())
        misses = sum(self.misses.values())
        rejected = sum(sum(r.values()) for r in self.rejects.values())
        denom = total + rejected
        # all-ops roll-up: bucket-exact merge of the per-class
        # histograms (same log2 grid, so counts just add)
        merged = LatencyHistogram()
        for op in ops:
            if op in self._hist:
                merged.merge(self._hist[op])
        out = {
            "elapsed_s": round(elapsed, 6),
            "requests": total,
            "deadline_miss_rate": (round((misses + rejected) / denom, 6)
                                   if denom else None),
            "bytes": total_bytes,
            "gbps": (round(total_bytes / elapsed / 1e9, 6)
                     if elapsed > 0 else None),
            "gbps_under_slo": (round(ok_bytes / elapsed / 1e9, 6)
                               if elapsed > 0 else None),
            **self._pcts(merged if merged.count else None),
            "op_classes": per_op,
        }
        if rejected:
            out["rejected_misses"] = rejected
        if self._tenant:
            out["tenants"] = self.tenant_report(elapsed)
        if padding is not None:
            out["padding"] = dict(sorted(padding.items()))
        return out

    def tenant_report(self, elapsed: float) -> dict:
        """Per-tenant scorecards: served/rejected counts, the
        miss rate WITH rejects folded in, latency percentiles and
        GB/s-under-SLO — the isolation gate's per-victim evidence.
        Deterministic like the rest of the report."""
        out = {}
        for name in sorted(self._tenant):
            t = self._tenant[name]
            rej = sum(t["rejects"].values())
            denom = t["count"] + rej
            out[name] = {
                "requests": denom,
                "served": t["count"],
                "rejected": dict(sorted(t["rejects"].items())),
                "deadline_miss_rate": (
                    round((t["misses"] + rej) / denom, 6)
                    if denom else None),
                "served_miss_rate": (
                    round(t["misses"] / t["count"], 6)
                    if t["count"] else None),
                "bytes": t["total_bytes"],
                "gbps_under_slo": (
                    round(t["ok_bytes"] / elapsed / 1e9, 6)
                    if elapsed > 0 else None),
                **self._pcts(t["hist"]),
            }
        return out
