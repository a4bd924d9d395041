"""trace_view — summarize a causal-tracing dump and export the Perfetto
timeline: the counterpart of the reference's ``tools/trace_view.py``.

Input is either a trace dump file (the ``traces`` section perf_dump
emits, or a bare ``TraceCollector.to_dict()`` JSON) or
``--run-scenario``, which runs the canonical seeded production day on a
FakeClock with the collector installed.

    python -m ceph_tpu_torch.tools.trace_view dump.json
    python -m ceph_tpu_torch.tools.trace_view --run-scenario --seed 42
    python -m ceph_tpu_torch.tools.trace_view --run-scenario \
        --chrome day.trace.json      # then open it in ui.perfetto.dev
    python -m ceph_tpu_torch.tools.trace_view --run-scenario --check
        # schema-valid, segment sums exact, byte-identical across two
        # runs of one seed

``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError`` without
a card): the scenario runs on the device executor on that device, or on
the host executor with ``host`` (the reference's scenario).  The file
mode runs nothing and needs no device.

Exit codes: 0 ok · 1 schema validation failed · 2 usage ·
3 --check gate failed.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import _demo


def run_traced_scenario(seed: int, requests: int,
                        arbiter: bool = True,
                        device: str = "cuda") -> dict:
    """One seeded FakeClock production day under the collector, on
    ``device``'s executor; returns the trace dump (byte-identical per
    seed)."""
    from ..scenario import default_scenario, run_scenario
    from ..serve.loadgen import throughput_service_model
    from ..telemetry import tracing
    from ..utils.retry import FakeClock

    kw = _demo.run_kwargs(device)

    clock = FakeClock()
    coll = tracing.TraceCollector(clock=clock, seed=seed)
    prev = tracing.install(coll)
    try:
        spec = default_scenario(seed=seed, n_requests=requests,
                                damaged_objects=3, storm_events=4)
        run = run_scenario(spec, clock=clock,
                           service_model=throughput_service_model(),
                           enable_arbiter=arbiter, **kw)
    finally:
        tracing.install(prev)
    if not run.report.ok():
        raise SystemExit(f"trace_view: scenario gates failed "
                         f"(bug, not a tracing problem): "
                         f"{run.report.gates}")
    return coll.to_dict()


def load_dump(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            dump = json.load(f)
    except OSError as e:
        raise SystemExit(f"trace_view: cannot read {path}: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"trace_view: {path} is not JSON: {e}")
    if "trace_schema_version" in dump:
        return dump
    if "traces" in dump and isinstance(dump["traces"], dict):
        return dump["traces"]          # a unified perf dump
    raise SystemExit(f"trace_view: {path} carries no trace dump "
                     f"(expected trace_schema_version or a perf dump "
                     f"with a `traces` section)")


def render_summary(dump: dict, top: int) -> None:
    from ..telemetry import analyzer
    from ..telemetry.tracing import SEGMENTS

    report = analyzer.analyze(dump)
    print(f"traces: {report['requests']} complete, "
          f"{report['incomplete']} incomplete, "
          f"{report['dropped']} dropped  |  "
          f"background: {report['background_intervals']} intervals  "
          f"qos: {report['qos_decisions']} decisions  "
          f"retries: {report['retry_intervals']}")
    table = report["tail_attribution"]
    for op in sorted(table):
        entry = table[op]
        print(f"\n[{op}] {entry['requests']} request(s) — "
              f"segment share of tail time")
        header = f"  {'segment':<16}" + "".join(
            f"{q:>10}" for q, _ in analyzer.QUANTILES)
        print(header)
        for seg in SEGMENTS:
            row = f"  {seg:<16}"
            for q, _ in analyzer.QUANTILES:
                row += f"{entry[q]['segments'][seg]['share']:>10.4f}"
            print(row)
        doms = " ".join(f"{q}={entry[q]['dominant']}"
                        f"@{entry[q]['latency_ms']:.3f}ms"
                        for q, _ in analyzer.QUANTILES)
        print(f"  dominant: {doms}")
    rows = sorted(report["rows"], key=lambda r: (-r["end_to_end_ns"],
                                                 r["trace_id"]))
    if rows and top:
        print(f"\nslowest {min(top, len(rows))} trace(s):")
        for r in rows[:top]:
            segs = ", ".join(
                f"{s}={r['segments'][s] / 1e6:.3f}ms"
                for s in SEGMENTS if r["segments"][s])
            print(f"  {r['trace_id']} {r['op']:<7}"
                  f"{r['end_to_end_ns'] / 1e6:9.3f}ms  "
                  f"[{segs}]  program={r['program']}")


def check(dump: dict, seed: int, requests: int,
          ran_scenario: bool, device: str = "cuda",
          arbiter: bool = True) -> int:
    """The gate: schema-valid, every segment decomposition sums
    exactly, and (when we produced the dump ourselves) a second run
    of the same seed is byte-identical."""
    from ..telemetry import analyzer
    from ..telemetry.schema import validate_trace_dump

    errors = validate_trace_dump(dump)
    if errors:
        for e in errors:
            print(f"schema: {e}", file=sys.stderr)
        return 1
    rows = analyzer.decompose_all(dump)
    if not rows:
        print("check: no complete client traces", file=sys.stderr)
        return 3
    for r in rows:
        if sum(r["segments"].values()) != r["end_to_end_ns"]:
            print(f"check: segments do not sum for {r['trace_id']}",
                  file=sys.stderr)
            return 3
    if ran_scenario:
        again = run_traced_scenario(seed, requests, arbiter, device)
        if json.dumps(dump, sort_keys=True) != \
                json.dumps(again, sort_keys=True):
            print("check: trace dump is not byte-identical across "
                  "reruns of one seed", file=sys.stderr)
            return 3
    print(f"check: ok ({len(rows)} traces, segment sums exact"
          + (", replay byte-identical)" if ran_scenario else ")"))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", nargs="?", help="trace dump JSON (or a "
                    "perf dump with a `traces` section)")
    ap.add_argument("--run-scenario", action="store_true",
                    help="run the canonical seeded FakeClock "
                         "production day under the collector instead "
                         "of reading a file")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="--run-scenario's executor: host, or the "
                         "device executor on cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--no-arbiter", action="store_true",
                    help="run the scenario with mClock arbitration "
                         "off (the contention control)")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest traces to print (0 = none)")
    ap.add_argument("--chrome", metavar="OUT",
                    help="write the Chrome trace-event timeline "
                         "(open in https://ui.perfetto.dev)")
    ap.add_argument("--json", metavar="OUT", dest="json_out",
                    help="write the raw trace dump JSON")
    ap.add_argument("--check", action="store_true",
                    help="gate mode: schema + exact segment sums + "
                         "(with --run-scenario) byte-identical replay")
    args = ap.parse_args(argv)

    if args.run_scenario:
        dump = run_traced_scenario(args.seed, args.requests,
                                   arbiter=not args.no_arbiter,
                                   device=args.device)
    elif args.dump:
        dump = load_dump(args.dump)
    else:
        ap.error("give a dump file or --run-scenario")

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(dump, f, sort_keys=True)
            f.write("\n")
    if args.chrome:
        from ..telemetry import analyzer
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump(analyzer.chrome_trace(dump), f)
            f.write("\n")
        print(f"chrome trace: {args.chrome} (open in "
              f"https://ui.perfetto.dev)")
    if args.check:
        return check(dump, args.seed, args.requests,
                     args.run_scenario, args.device,
                     not args.no_arbiter)
    render_summary(dump, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
