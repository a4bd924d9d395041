"""Critical-path analyzer — segment decomposition, tail-latency
attribution and timeline export for the causal tracing plane
(telemetry/tracing.py).  A copy of ``ceph_tpu/telemetry/analyzer.py``:
pure Python over ``tracing.SEGMENTS``.

Every completed client trace decomposes into the named segments of
``tracing.SEGMENTS``:

==================  ==================================================
segment             meaning
==================  ==================================================
queue_wait          admission → bucket assignment, minus any
                    background charge overlapping that window
batch_wait          bucket assignment → batch fire, minus overlapping
                    background charge (waiting for co-batchees /
                    deadline slack)
arbiter_hold        the carved-out background charge: clock time
                    granted to recovery/scrub/rebalance work (under —
                    or, with ``--no-arbiter``, free of — mClock
                    arbitration) while this request waited
retry_backoff       supervisor retry backoff intervals inside the
                    dispatch window (ops/supervisor.py)
device_dispatch     batch fire → dispatch end, minus retry backoff
                    (assigned as the integer residual, so the six
                    segments sum EXACTLY to the end-to-end time)
demux               dispatch end → per-request demux completion
==================  ==================================================

All arithmetic is integer nanoseconds on the collector's injectable
clock, so ``sum(segments) == end_to_end_ns`` is an exact equality,
not a float approximation — the property tests/test_tracing.py pins
across rs/shec/clay and all three ops.

Two exports:

- :func:`analyze` — the JSON report: per-trace segment rows plus the
  per-op tail-attribution table (:func:`tail_attribution` — which
  segment dominates at p50 vs p99 vs p999).
- :func:`chrome_trace` — a Chrome trace-event file (load it in
  Perfetto / chrome://tracing): client requests on per-op lanes,
  background work on its own class tracks, QoS denials and supervisor
  incidents as instant events.  A seeded production day renders as a
  browsable timeline.

Host arithmetic only: no torch, no numpy, no device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from .tracing import SEGMENTS

QUANTILES = (("p50", 0.50), ("p99", 0.99), ("p999", 0.999))


# ----------------------------------------------------------------------
# interval arithmetic (integer ns)

def _merge(intervals: Sequence[Tuple[int, int]]
           ) -> List[Tuple[int, int]]:
    """Merge possibly-overlapping intervals so overlap accounting
    never double-counts a nanosecond."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _overlap(merged: Sequence[Tuple[int, int]], lo: int,
             hi: int) -> int:
    """Total ns of ``merged`` intervals inside ``[lo, hi]``."""
    total = 0
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(b, hi) - max(a, lo)
    return total


# ----------------------------------------------------------------------
# per-trace decomposition

def decompose(trace: dict, background: Sequence[Tuple[int, int]],
              retries: Sequence[Tuple[int, int]]) -> Optional[dict]:
    """Decompose one completed client trace (dict form) into the
    segment taxonomy.  Returns None for incomplete traces (rejected
    at admission, or still in flight at export time).

    ``background``/``retries`` are pre-merged interval lists.  The
    six segments sum exactly to ``end_to_end_ns``: five are computed,
    ``device_dispatch`` is the integer residual (equal to
    ``(dispatch_end - fire) - retry_backoff`` by construction, but
    assigned as the residual so the sum telescopes exactly)."""
    ev = {e["name"]: e for e in trace.get("events", ())}
    need = ("admit", "bucket", "fire", "dispatch_end", "done")
    if any(name not in ev for name in need):
        return None
    t_arr = ev["admit"]["t_ns"]
    t_bucket = ev["bucket"]["t_ns"]
    t_fire = ev["fire"]["t_ns"]
    t_end = ev["dispatch_end"]["t_ns"]
    t_done = ev["done"]["t_ns"]
    e2e = t_done - t_arr
    hold_q = _overlap(background, t_arr, t_bucket)
    hold_b = _overlap(background, t_bucket, t_fire)
    retry = _overlap(retries, t_fire, t_end)
    segments = {
        "queue_wait": (t_bucket - t_arr) - hold_q,
        "batch_wait": (t_fire - t_bucket) - hold_b,
        "arbiter_hold": hold_q + hold_b,
        "retry_backoff": retry,
        "demux": t_done - t_end,
    }
    segments["device_dispatch"] = e2e - sum(segments.values())
    segments = {k: segments[k] for k in SEGMENTS}
    fire = ev["fire"]
    return {
        "trace_id": trace["trace_id"],
        "op": trace.get("op", ""),
        "plugin": (trace.get("attrs") or {}).get("plugin"),
        "end_to_end_ns": e2e,
        "segments": segments,
        "program": ev.get("program", {}).get("series"),
        "batch_seq": fire.get("batch_seq"),
        "occupancy": fire.get("occupancy"),
        "rung": fire.get("rung"),
        "deadline_met": ev["done"].get("deadline_met"),
    }


def decompose_all(dump: dict) -> List[dict]:
    """Decompose every completed client trace in a collector dump
    (``TraceCollector.to_dict()`` shape)."""
    background = _merge([(iv["t0_ns"], iv["t1_ns"])
                         for iv in dump.get("background", ())])
    retries = _merge([(iv["t0_ns"], iv["t1_ns"])
                      for iv in dump.get("retries", ())])
    rows = []
    for trace in dump.get("traces", ()):
        if trace.get("kind") != "client":
            continue
        row = decompose(trace, background, retries)
        if row is not None:
            rows.append(row)
    return rows


# ----------------------------------------------------------------------
# tail attribution

def _rank(n: int, q: float) -> int:
    """The 1-indexed rank quantile ``q`` names — the same
    ``min(n, max(1, ceil(q*n)))`` semantics LatencyHistogram pins."""
    return min(n, max(1, math.ceil(q * n)))


def tail_attribution(rows: List[dict],
                     quantiles=QUANTILES) -> Dict[str, dict]:
    """Per-op (plus ``all``) tail-attribution table: at each latency
    quantile, the mean per-segment time and share over the requests AT
    OR ABOVE that quantile's rank — "which segment dominates at p50 vs
    p99 vs p999".  Shares are of total tail time, so they sum to 1.0
    (rounding aside); ``seconds`` carries the absolute mean so shrink
    claims aren't confounded by everything shrinking together."""
    by_op: Dict[str, List[dict]] = {"all": []}
    for row in rows:
        by_op["all"].append(row)
        by_op.setdefault(row["op"], []).append(row)
    table: Dict[str, dict] = {}
    for op in sorted(by_op):
        ranked = sorted(by_op[op],
                        key=lambda r: (r["end_to_end_ns"],
                                       r["trace_id"]))
        n = len(ranked)
        if not n:
            continue
        entry: Dict[str, dict] = {"requests": n}
        for label, q in quantiles:
            tail = ranked[_rank(n, q) - 1:]
            tot = sum(r["end_to_end_ns"] for r in tail)
            segs = {}
            for seg in SEGMENTS:
                ns = sum(r["segments"][seg] for r in tail)
                segs[seg] = {
                    "mean_ms": round(ns / len(tail) / 1e6, 6),
                    "share": (round(ns / tot, 6) if tot else 0.0),
                }
            dominant = max(
                SEGMENTS, key=lambda s: (segs[s]["share"], s))
            entry[label] = {
                "latency_ms": round(
                    ranked[_rank(n, q) - 1]["end_to_end_ns"] / 1e6, 6),
                "tail_requests": len(tail),
                "segments": segs,
                "dominant": dominant,
            }
        table[op] = entry
    return table


def tail_shares(rows: List[dict], label: str = "p99") -> dict:
    """The compact bench blob (metric_version 12): per-segment share
    of tail time at one quantile, across all ops, plus the dominant
    segment — ``{"shares": {...}, "dominant": ..., "requests": n}``."""
    table = tail_attribution(rows)
    allq = table.get("all", {}).get(label)
    if not allq:
        return {"shares": None, "dominant": None, "requests": 0}
    return {
        "shares": {seg: allq["segments"][seg]["share"]
                   for seg in SEGMENTS},
        "mean_ms": {seg: allq["segments"][seg]["mean_ms"]
                    for seg in SEGMENTS},
        "dominant": allq["dominant"],
        "requests": table["all"]["requests"],
    }


def analyze(dump: dict) -> dict:
    """The full analyzer report for one collector dump: decomposed
    rows + the tail table + the dump's own accounting.  Deterministic
    (sorted keys at serialization; every derived float rounded)."""
    rows = decompose_all(dump)
    complete = {r["trace_id"] for r in rows}
    incomplete = sum(1 for t in dump.get("traces", ())
                     if t.get("kind") == "client"
                     and t["trace_id"] not in complete)
    return {
        "trace_schema_version": dump.get("trace_schema_version"),
        "seed": dump.get("seed"),
        "requests": len(rows),
        "incomplete": incomplete,
        "dropped": dump.get("dropped", 0),
        "background_intervals": len(dump.get("background", ())),
        "qos_decisions": len(dump.get("qos", ())),
        "retry_intervals": len(dump.get("retries", ())),
        "rows": rows,
        "tail_attribution": tail_attribution(rows),
    }


# ----------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)

_OP_TID = {"encode": 100, "decode": 200, "repair": 300}
_CLS_TID = {"recovery": 10, "scrub": 11, "rebalance": 12}
_QOS_TID = 20
_ANN_TID = 21
_LANES = 8      # request lanes per op track group


def _us(ns: int) -> float:
    return ns / 1e3


def chrome_trace(dump: dict) -> dict:
    """Render a collector dump as a Chrome trace-event object
    (``json.dump`` it, then open in https://ui.perfetto.dev).  Client
    requests ride per-op lane groups (wait → dispatch → demux phases
    as complete events carrying the trace id and program series in
    ``args``); background classes, QoS denials and supervisor
    annotations get their own tracks.  Deterministic: events sorted
    by (ts, tid, name)."""
    events: List[dict] = []
    meta_named = set()

    def name_track(tid: int, label: str) -> None:
        if tid in meta_named:
            return
        meta_named.add(tid)
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": label}})

    for trace in dump.get("traces", ()):
        ev = {e["name"]: e for e in trace.get("events", ())}
        if trace.get("kind") != "client":
            # background unit traces (recovery rounds): one event per
            # recorded span pair when present
            start = ev.get("round_start")
            end = ev.get("round_end")
            if start and end:
                tid = _CLS_TID.get("recovery", 10)
                name_track(tid, "recovery rounds")
                events.append({
                    "ph": "X", "pid": 1, "tid": tid,
                    "name": f"recovery round "
                            f"{start.get('round', '?')}",
                    "ts": _us(start["t_ns"]),
                    "dur": _us(end["t_ns"] - start["t_ns"]),
                    "args": {"trace_id": trace["trace_id"],
                             **{k: v for k, v in end.items()
                                if k not in ("name", "t_ns")}}})
            continue
        need = ("admit", "bucket", "fire", "dispatch_end", "done")
        if any(n not in ev for n in need):
            continue
        op = trace.get("op", "op")
        base = _OP_TID.get(op, 900)
        tid = base + (trace["num"] % _LANES)
        name_track(tid, f"client {op} lane "
                        f"{trace['num'] % _LANES}")
        args = {"trace_id": trace["trace_id"],
                "req_id": trace["num"],
                "program": ev.get("program", {}).get("series")}
        phases = (("wait", ev["admit"]["t_ns"], ev["fire"]["t_ns"]),
                  ("dispatch", ev["fire"]["t_ns"],
                   ev["dispatch_end"]["t_ns"]),
                  ("demux", ev["dispatch_end"]["t_ns"],
                   ev["done"]["t_ns"]))
        for phase, lo, hi in phases:
            if hi <= lo and phase != "dispatch":
                continue
            events.append({
                "ph": "X", "pid": 1, "tid": tid,
                "name": f"{op}.{phase}",
                "ts": _us(lo), "dur": _us(hi - lo), "args": args})
    for iv in dump.get("background", ()):
        tid = _CLS_TID.get(iv["cls"], 13)
        name_track(tid, f"background {iv['cls']}")
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": iv["cls"],
            "ts": _us(iv["t0_ns"]),
            "dur": _us(iv["t1_ns"] - iv["t0_ns"]),
            "args": {k: v for k, v in iv.items()
                     if k not in ("cls", "t0_ns", "t1_ns")}})
    for dec in dump.get("qos", ()):
        if dec.get("granted"):
            continue
        name_track(_QOS_TID, "qos denials")
        events.append({
            "ph": "i", "s": "t", "pid": 1, "tid": _QOS_TID,
            "name": f"deny {dec['cls']} ({dec['why']})",
            "ts": _us(dec["t_ns"]),
            "args": {"pressure": dec["pressure"],
                     "scale": dec["scale"]}})
    for ann in dump.get("annotations", ()):
        name_track(_ANN_TID, "supervisor")
        events.append({
            "ph": "i", "s": "t", "pid": 1, "tid": _ANN_TID,
            "name": ann["kind"], "ts": _us(ann["t_ns"]),
            "args": {k: v for k, v in ann.items()
                     if k not in ("kind", "t_ns")}})
    body = [e for e in events if e["ph"] != "M"]
    meta = [e for e in events if e["ph"] == "M"]
    meta.sort(key=lambda e: e["tid"])
    body.sort(key=lambda e: (e["ts"], e["tid"], e["name"]))
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


__all__ = ["QUANTILES", "analyze", "chrome_trace", "decompose",
           "decompose_all", "tail_attribution", "tail_shares"]
