"""JSON shape validation for the unified telemetry dump; a copy of
``ceph_tpu/telemetry/schema.py``.

A seeded repair scenario dumps and validates here — a refactor that
silently drops a section (or emits a histogram without its quantiles)
fails instead of shipping a dump nobody can parse.  The validator is
hand-rolled (stdlib-only) but the rules below ARE the schema, versioned
by ``SCHEMA_VERSION`` inside the dump itself; the same dump passes or
fails here exactly as it does in the reference.
"""

from __future__ import annotations

from typing import List

# v2: optional `profile` (device-plane cost/roofline attribution
# rows, the reference's telemetry/profiler.py) and `flight_recorder`
# (post-mortem ring + dumps, telemetry/recorder.py) sections join the
# dump; both validated below when present.  An optional
# `traces` section (the causal-tracing collector dump,
# telemetry/tracing.py) carrying its OWN trace_schema_version —
# validated by validate_trace_dump like the flight blobs.
SCHEMA_VERSION = 2
TRACE_SCHEMA_VERSION = 1

_HIST_REQUIRED = ("count", "sum", "min", "max", "p50", "p99", "p999",
                  "buckets")
_SPAN_REQUIRED = ("name", "start", "end", "duration")
# every attribution row must carry the full join: identity, cost
# model, measured latency and the roofline verdict (values may be
# null — a never-dispatched program has no p50 — but the KEYS may not
# silently vanish)
_PROFILE_ROW_REQUIRED = ("name", "series", "source", "flops",
                         "bytes_accessed", "arg_bytes", "calls",
                         "p50_ms", "achieved_gbps", "utilization_pct")
_FLIGHT_REQUIRED = ("flight_schema_version", "trigger", "reason",
                    "time", "entries", "spans", "metrics",
                    "metrics_delta")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_hist(path: str, v: dict, errors: List[str]) -> None:
    for k in _HIST_REQUIRED:
        if k not in v:
            errors.append(f"{path}: histogram missing {k!r}")
    if not isinstance(v.get("count"), int) or v.get("count", 0) < 0:
        errors.append(f"{path}: histogram count must be int >= 0")
    if not isinstance(v.get("buckets", None), dict):
        errors.append(f"{path}: histogram buckets must be an object")
    if "exemplars" in v:
        ex = v["exemplars"]
        if not isinstance(ex, list) or any(
                not isinstance(e, dict) or "value" not in e
                or "trace_id" not in e for e in ex):
            errors.append(f"{path}: exemplars must be objects with "
                          f"value+trace_id")
    if v.get("count"):
        for q in ("p50", "p99", "p999", "min", "max"):
            if not _is_num(v.get(q)):
                errors.append(f"{path}: non-empty histogram {q} must "
                              f"be a number")


def _check_series(path: str, v, errors: List[str]) -> None:
    if isinstance(v, dict):
        if "buckets" in v:
            _check_hist(path, v, errors)
        elif set(v) == {"avgcount", "sum"}:
            if not isinstance(v["avgcount"], int) or \
                    not _is_num(v["sum"]):
                errors.append(f"{path}: time pair must be "
                              f"{{avgcount: int, sum: number}}")
        else:
            errors.append(f"{path}: unknown series object shape "
                          f"{sorted(v)[:4]}")
    elif not _is_num(v):
        errors.append(f"{path}: series value must be a number")


def _check_span(path: str, sp, errors: List[str]) -> None:
    if not isinstance(sp, dict):
        errors.append(f"{path}: span must be an object")
        return
    for k in _SPAN_REQUIRED:
        if k not in sp:
            errors.append(f"{path}: span missing {k!r}")
    if not isinstance(sp.get("name"), str):
        errors.append(f"{path}: span name must be a string")
    if sp.get("end") is not None and _is_num(sp.get("start")) \
            and _is_num(sp.get("end")) and sp["end"] < sp["start"]:
        errors.append(f"{path}: span ends before it starts")
    for i, child in enumerate(sp.get("children", ())):
        _check_span(f"{path}.children[{i}]", child, errors)


def validate_profile_section(path: str, section,
                             errors: List[str] = None) -> List[str]:
    """Validate the device-plane profiler section (profiler.to_dict
    shape: program count + attribution rows + hot list)."""
    errors = [] if errors is None else errors
    if not isinstance(section, dict):
        errors.append(f"{path}: profile section must be an object")
        return errors
    if not isinstance(section.get("programs"), int):
        errors.append(f"{path}.programs must be an int")
    rows = section.get("rows")
    if not isinstance(rows, list):
        errors.append(f"{path}.rows must be a list")
        return errors
    if len(rows) != section.get("programs"):
        errors.append(f"{path}.programs != len(rows)")
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            errors.append(f"{path}.rows[{i}] must be an object")
            continue
        for k in _PROFILE_ROW_REQUIRED:
            if k not in row:
                errors.append(f"{path}.rows[{i}] missing {k!r}")
        if not isinstance(row.get("name"), str):
            errors.append(f"{path}.rows[{i}].name must be a string")
    if not isinstance(section.get("top", []), list):
        errors.append(f"{path}.top must be a list")
    return errors


def validate_flight_dump(blob) -> List[str]:
    """Validate one flight-recorder post-mortem blob."""
    errors: List[str] = []
    if not isinstance(blob, dict):
        return ["flight dump must be a JSON object"]
    for k in _FLIGHT_REQUIRED:
        if k not in blob:
            errors.append(f"flight dump missing {k!r}")
    if blob.get("flight_schema_version") != 1:
        errors.append("flight_schema_version must be 1")
    entries = blob.get("entries")
    if not isinstance(entries, list) or any(
            not isinstance(e, dict) or "seq" not in e or "kind" not in e
            or "t" not in e for e in entries):
        errors.append("entries must be objects with seq+kind+t")
    elif [e["seq"] for e in entries] != sorted(
            e["seq"] for e in entries):
        errors.append("entries must be seq-ordered")
    spans = blob.get("spans")
    if not isinstance(spans, dict) or "spans" not in spans:
        errors.append("flight dump spans must be {spans: [...]}")
    else:
        for i, sp in enumerate(spans["spans"]):
            _check_span(f"flight.spans[{i}]", sp, errors)
    if not isinstance(blob.get("metrics"), dict):
        errors.append("flight dump metrics must be an object")
    if not isinstance(blob.get("metrics_delta"), dict):
        errors.append("flight dump metrics_delta must be an object")
    return errors


_TRACE_REQUIRED = ("trace_schema_version", "seed", "sample",
                   "dropped", "traces", "background", "qos",
                   "retries", "annotations")


def _check_interval(path: str, iv, key: str,
                    errors: List[str]) -> None:
    if not isinstance(iv, dict) or key not in iv \
            or "t0_ns" not in iv or "t1_ns" not in iv:
        errors.append(f"{path}: interval must carry {key}+t0_ns+t1_ns")
        return
    if not isinstance(iv["t0_ns"], int) \
            or not isinstance(iv["t1_ns"], int):
        errors.append(f"{path}: interval stamps must be integer ns")
    elif iv["t1_ns"] < iv["t0_ns"]:
        errors.append(f"{path}: interval ends before it starts")


def validate_trace_dump(dump) -> List[str]:
    """Validate one causal-tracing collector dump
    (telemetry/tracing.py::TraceCollector.to_dict shape): trace
    events carry integer-ns non-decreasing stamps, intervals are
    ordered, QoS decisions carry pressure/scale."""
    errors: List[str] = []
    if not isinstance(dump, dict):
        return ["trace dump must be a JSON object"]
    for k in _TRACE_REQUIRED:
        if k not in dump:
            errors.append(f"trace dump missing {k!r}")
    if dump.get("trace_schema_version") != TRACE_SCHEMA_VERSION:
        errors.append(f"trace_schema_version must be "
                      f"{TRACE_SCHEMA_VERSION}")
    traces = dump.get("traces", [])
    if not isinstance(traces, list):
        errors.append("traces must be a list")
        traces = []
    for i, t in enumerate(traces):
        path = f"traces[{i}]"
        if not isinstance(t, dict) or "trace_id" not in t \
                or "kind" not in t or "events" not in t:
            errors.append(f"{path}: trace must carry "
                          f"trace_id+kind+events")
            continue
        if not isinstance(t["trace_id"], str) or not t["trace_id"]:
            errors.append(f"{path}: trace_id must be a non-empty "
                          f"string")
        prev = None
        for j, ev in enumerate(t.get("events", ())):
            if not isinstance(ev, dict) or "name" not in ev \
                    or "t_ns" not in ev:
                errors.append(f"{path}.events[{j}]: event must carry "
                              f"name+t_ns")
                continue
            if not isinstance(ev["t_ns"], int):
                errors.append(f"{path}.events[{j}]: t_ns must be an "
                              f"integer (ns)")
                continue
            if prev is not None and ev["t_ns"] < prev:
                errors.append(f"{path}.events[{j}]: events must be "
                              f"time-ordered")
            prev = ev["t_ns"]
    for i, iv in enumerate(dump.get("background", ())):
        _check_interval(f"background[{i}]", iv, "cls", errors)
    for i, iv in enumerate(dump.get("retries", ())):
        _check_interval(f"retries[{i}]", iv, "seam", errors)
    for i, dec in enumerate(dump.get("qos", ())):
        if not isinstance(dec, dict) or "cls" not in dec \
                or "granted" not in dec or "pressure" not in dec \
                or "scale" not in dec or "t_ns" not in dec:
            errors.append(f"qos[{i}]: decision must carry cls+granted"
                          f"+pressure+scale+t_ns")
    if not isinstance(dump.get("dropped", 0), int):
        errors.append("dropped must be an int")
    return errors


def _check_flight_section(path: str, section,
                          errors: List[str]) -> None:
    if not isinstance(section, dict) or "dumps" not in section \
            or "entries" not in section:
        errors.append(f"{path}: flight_recorder section must be "
                      f"{{entries: [...], dumps: [...]}}")
        return
    for i, blob in enumerate(section["dumps"]):
        for e in validate_flight_dump(blob):
            errors.append(f"{path}.dumps[{i}]: {e}")


def validate_dump(dump: dict) -> List[str]:
    """Validate the unified ``dump_all()`` shape; returns a list of
    error strings (empty = valid)."""
    errors: List[str] = []
    if not isinstance(dump, dict):
        return ["dump must be a JSON object"]
    if dump.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"schema_version must be {SCHEMA_VERSION}")
    spans = dump.get("spans")
    if not isinstance(spans, dict) or "spans" not in spans \
            or "dropped" not in spans:
        errors.append("spans section must be {spans: [...], "
                      "dropped: int}")
    else:
        for i, sp in enumerate(spans["spans"]):
            _check_span(f"spans[{i}]", sp, errors)
    if "profile" in dump:
        validate_profile_section("profile", dump["profile"], errors)
    if "flight_recorder" in dump:
        _check_flight_section("flight_recorder",
                              dump["flight_recorder"], errors)
    if "traces" in dump:
        for e in validate_trace_dump(dump["traces"]):
            errors.append(f"traces: {e}")
    registries = [k for k in dump
                  if k not in ("schema_version", "spans", "profile",
                               "flight_recorder", "traces")]
    if not registries:
        errors.append("dump carries no metric registries")
    for reg in registries:
        body = dump[reg]
        if not isinstance(body, dict):
            errors.append(f"{reg}: registry must be an object")
            continue
        for key, v in body.items():
            if key == "__events__":
                if not isinstance(v, list) or any(
                        not isinstance(e, dict) or "event" not in e
                        or "seq" not in e for e in v):
                    errors.append(f"{reg}.__events__: events must be "
                                  f"objects with event+seq")
                continue
            _check_series(f"{reg}.{key}", v, errors)
    return errors


__all__ = ["SCHEMA_VERSION", "TRACE_SCHEMA_VERSION", "validate_dump",
           "validate_flight_dump", "validate_profile_section",
           "validate_trace_dump"]
