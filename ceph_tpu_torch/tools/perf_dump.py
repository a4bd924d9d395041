"""perf_dump — the admin-socket `perf dump` CLI for the port's telemetry
plane: the counterpart of the reference's ``tools/perf_dump.py``.

Runs a seeded repair / recovery scenario through the instrumented
pipeline (scrub → batched repair → recovery orchestrator under
MapChurn) on ``--device`` (default the card), then emits the unified
observability dump — the ``{registry: {counter: value}}`` perf-dump JSON
shape plus span trees — and/or Prometheus text exposition.

    python -m ceph_tpu_torch.tools.perf_dump --scenario repair --validate
    python -m ceph_tpu_torch.tools.perf_dump --scenario recovery-churn \
        --fake-clock --validate
    python -m ceph_tpu_torch.tools.perf_dump --check-overhead 3
    python -m ceph_tpu_torch.tools.perf_dump --scenario traced-day \
        --fake-clock --traces --validate
    python -m ceph_tpu_torch.tools.perf_dump --profile --validate
    python -m ceph_tpu_torch.tools.perf_dump --scenario unrecoverable \
        --fake-clock --flight-recorder --validate

``--profile`` sweeps every ``kind == "device"`` entry of the registry
(``analysis/entrypoints.py``) through ``telemetry.profile_entrypoints``
on ``--device``; an unfiltered sweep that leaves one of them without a
row gives rc 1.  ``--flight-recorder`` adds the flight recorder's ring
and post-mortem dumps; ``--traces`` the causal-tracing collector's dump
(``--scenario traced-day`` implies it).

Differences from the reference, by design:

- ``--device host|cuda|cpu`` (default ``cuda``; ``NoDeviceError``
  without a card): ``host`` is a CPU instance pinned to the numpy
  region ops with host repairs and the host executor, ``cpu`` the
  device path on CPU tensors.  The traced day runs on the device
  executor unless ``--device host``.
- No compile monitor: the reference's ``install_compile_monitor``
  counts jax compiles, and the port has none.  A real-clock dump
  carries the ``kernel_setups`` counter in its place (kernel libraries
  loaded, kernel data uploaded; 0 when nothing was set up).
- ``--check-overhead`` keeps the reference's interleaved on/off series
  and its min-of-5 verdict, on the degraded row at ``--device`` (the
  card by default), and reports both series: on a card's host a pair's
  on/off ratio spreads ~9 % with no overhead at all, so the verdict on
  a 3 % bound there is mostly noise.

Exit codes: 0 ok · 1 schema validation / profile coverage failed ·
3 overhead above the threshold · 2 usage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import telemetry
from . import _demo


def _build_objects(seed: int, objects: int, device: str,
                   profile=None):
    from ..codes.stripe import HashInfo, StripeInfo
    from ..codes.stripe import encode as stripe_encode

    profile = profile or {"technique": "reed_sol_van",
                          "k": "4", "m": "2"}
    ec = _demo.instance("jerasure", profile, device)
    n = ec.get_chunk_count()
    k = ec.get_data_chunk_count()
    cs = ec.get_chunk_size(1 << 14)
    sinfo = StripeInfo(k, k * cs)
    rng = np.random.default_rng(seed)
    shards_list, hinfos = [], []
    for _ in range(objects):
        obj = rng.integers(0, 256, k * cs, dtype=np.uint8).tobytes()
        shards = stripe_encode(sinfo, ec, obj)
        h = HashInfo(n)
        h.append(0, shards)
        shards_list.append(shards)
        hinfos.append(h)
    return ec, sinfo, n, shards_list, hinfos


def _faulted_stores(seed: int, n: int, shards_list, chunk_size: int):
    from ..chaos import BitFlip, ShardErasure, TransientErrors, inject
    stores = []
    for i, shards in enumerate(shards_list):
        injectors = [ShardErasure(shards=[i % n])]
        if i % 3 == 0:
            injectors.append(BitFlip(shards=[(i + 1) % n], flips=1))
        if i % 4 == 0:
            injectors.append(TransientErrors(shards=[(i + 2) % n],
                                             count=1))
        store, _ = inject(shards, injectors, seed=seed + i,
                          chunk_size=chunk_size)
        stores.append(store)
    return stores


def _fused(device: str):
    """``device=`` of the repair and recovery calls: the host arm's
    grouped host repair, else the fused path on the code's device."""
    return False if device == "host" else None


def run_repair_scenario(seed: int, objects: int, clock=None,
                        device: str = "cuda") -> None:
    """Seeded deep_scrub → repair_batched pass (the acceptance
    scenario's first half): erasures + a bit-flip + a transient read
    error, so the PatternCache, retry, chaos and dispatch series all
    take real values."""
    from ..scrub import repair_batched

    ec, sinfo, n, shards_list, hinfos = _build_objects(seed, objects,
                                                       device)
    stores = _faulted_stores(seed, n, shards_list, sinfo.chunk_size)
    rep = repair_batched(sinfo, ec, stores, hinfos, clock=clock,
                         device=_fused(device))
    healed = all(stores[i].snapshot() == dict(shards_list[i])
                 for i in range(len(stores)))
    if not (healed and all(r.crc_verified for r in rep.reports)):
        raise SystemExit("perf_dump: repair scenario failed to heal "
                         "(bug, not a telemetry problem)")


def run_recovery_scenario(seed: int, objects: int, clock=None,
                          device: str = "cuda") -> None:
    """Seeded recovery-churn pass (the acceptance scenario's second
    half): the epoch-aware orchestrator heals under MapChurn, so the
    fence/replan/regroup and journal counters take real values."""
    from ..chaos import MapChurn, ShardErasure, inject
    from ..crush import (CrushBuilder, step_chooseleaf_indep, step_emit,
                         step_take)
    from ..crush.osdmap import OSDMap, PGPool
    from ..recovery import healed, recover_to_completion

    ec, sinfo, n, shards_list, hinfos = _build_objects(seed, objects,
                                                       device)
    stores = []
    for i, shards in enumerate(shards_list):
        store, _ = inject(shards, [ShardErasure(shards=[i % n])],
                          seed=seed + i, chunk_size=sinfo.chunk_size)
        stores.append(store)
    b = CrushBuilder()
    root = b.build_two_level(n + 3, 2)
    b.add_rule(0, [step_take(root),
                   step_chooseleaf_indep(n, b.type_id("host")),
                   step_emit()])
    osdmap = OSDMap(crush=b.map, device=_demo.map_device(device))
    osdmap.pools[1] = PGPool(pool_id=1, pg_num=16, size=n, erasure=True)
    churn = MapChurn(seed=seed, max_down=1, fire_every=2,
                     stages=("dispatch",))
    kw = {"churn": churn, "device": _fused(device)}
    if clock is not None:
        kw["clock"] = clock
    rep = recover_to_completion(sinfo, ec, osdmap, 1, 9, stores,
                                hinfos, **kw)
    if not (rep.converged and healed(stores, shards_list)):
        raise SystemExit("perf_dump: recovery scenario failed to "
                         "converge (bug, not a telemetry problem)")


def run_unrecoverable_scenario(seed: int, objects: int,
                               clock=None, device: str = "cuda") -> int:
    """Seeded past-budget repair: object 0 loses m+1 shards, so
    repair_batched constructs an UnrecoverableError — whose
    construction hook freezes the flight-recorder post-mortem this
    scenario exists to demonstrate.  The healthy objects still heal.
    Returns the number of flight dumps the run produced."""
    from ..chaos import ShardErasure, inject
    from ..scrub import repair_batched
    from ..utils.errors import UnrecoverableError

    ec, sinfo, n, shards_list, hinfos = _build_objects(seed, objects,
                                                       device)
    m = n - ec.get_data_chunk_count()
    stores = []
    for i, shards in enumerate(shards_list):
        lost = (list(range(m + 1)) if i == 0 else [i % n])
        store, _ = inject(shards, [ShardErasure(shards=lost)],
                          seed=seed + i, chunk_size=sinfo.chunk_size)
        stores.append(store)
    try:
        repair_batched(sinfo, ec, stores, hinfos, clock=clock,
                       device=_fused(device))
    except UnrecoverableError:
        pass
    else:
        raise SystemExit("perf_dump: past-budget scenario repaired?! "
                         "(bug, not a telemetry problem)")
    dumps = telemetry.global_flight_recorder().dump_count
    if dumps < 1:
        raise SystemExit("perf_dump: UnrecoverableError produced no "
                         "flight-recorder dump")
    return dumps


def run_traced_day(seed: int, requests: int, clock=None,
                   device: str = "cuda") -> None:
    """The causal-tracing scenario: the canonical seeded production day
    (scenario/spec.py::default_scenario) on ``device``'s executor with
    the trace collector active — client traces, QoS
    decisions, background charge intervals and recovery-round traces
    all land in the collector main() installed.  With --fake-clock the
    whole dump is byte-identical across runs."""
    from ..scenario import default_scenario, run_scenario
    from ..serve.loadgen import throughput_service_model

    spec = default_scenario(seed=seed, n_requests=max(16, requests),
                            damaged_objects=3, storm_events=4)
    kw = _demo.run_kwargs(device)
    if clock is not None:
        kw["clock"] = clock
        kw["service_model"] = throughput_service_model()
    run = run_scenario(spec, **kw)
    if not run.report.ok():
        raise SystemExit("perf_dump: traced-day scenario failed its "
                         "gates (bug, not a tracing problem): "
                         f"{run.report.gates}")


def run_profile_sweep(fake_clock: bool, repeats: int,
                      filters, device: str = "cuda") -> int:
    """Sweep the registry's device entries through the profiler
    (telemetry/profiler.py::profile_entrypoints) on ``device``.  Under
    --fake-clock the measured side runs on a deterministic tick clock
    (on the card the times are CUDA events all the same).  rc 1 when an
    unfiltered sweep leaves any ``kind == "device"`` entry without an
    attribution row."""
    from ..analysis.entrypoints import registry
    from ..telemetry.profiler import _Tick

    prof = telemetry.global_profiler()
    if fake_clock:
        prof = telemetry.ProgramProfiler(clock=_Tick())
        telemetry.set_global_profiler(prof)
    rows, failed = telemetry.profile_entrypoints(
        filters=tuple(filters or ()), measure=True, repeats=repeats,
        profiler=prof, device=_demo.torch_device(device))
    if not filters:
        have = {r["name"] for r in rows}
        failed = failed + [f"{ep.name}: no attribution row"
                           for ep in registry()
                           if ep.kind == "device" and ep.name not in have
                           and not any(f.startswith(ep.name + ":")
                                       for f in failed)]
    if failed:
        for f in failed:
            print(f"profile: {f}", file=sys.stderr)
        if not filters:
            print(f"profile: {len(failed)} device entr(ies) have no "
                  f"attribution row", file=sys.stderr)
            return 1
    if not rows:
        print("profile: sweep produced no rows", file=sys.stderr)
        return 1
    return 0


def check_overhead(threshold_pct: float, reps: int = 5,
                   traced: bool = False, device: str = "cuda") -> dict:
    """Instrumentation overhead on the degraded bench row
    (rs_k8_m3_degraded_e1 shape) at ``device``: run the row ``reps``
    times with telemetry recording ON and OFF, interleaved, and compare
    the min elapsed of each (min-of-N is robust to scheduler noise
    where mean is not).  Both series are reported.

    ``traced``: the enabled series additionally runs with a trace
    collector installed — the same bound must hold for tracing-enabled
    runs."""
    from ..bench.erasure_code_benchmark import ErasureCodeBench
    from ..telemetry import tracing

    argv = ["--plugin", "jerasure",
            "--parameter", "technique=reed_sol_van",
            "--parameter", "k=8", "--parameter", "m=3",
            "--size", str(1 << 18), "--workload", "degraded",
            "--device", device, "--batch", "2",
            "--iterations", "3", "-e", "1"]

    def one_run() -> float:
        bench = ErasureCodeBench()
        bench.setup(list(argv))
        return bench.run()["seconds"]

    one_run()  # warm every cache before either series
    times = {True: [], False: []}
    for _ in range(reps):
        for on in (True, False):
            telemetry.set_enabled(on)
            prev = (tracing.install(tracing.TraceCollector(seed=7))
                    if on and traced else None)
            try:
                t0 = time.perf_counter()
                one_run()
                times[on].append(time.perf_counter() - t0)
            finally:
                if on and traced:
                    tracing.install(prev)
    telemetry.set_enabled(True)
    t_on, t_off = min(times[True]), min(times[False])
    overhead = max(0.0, (t_on - t_off) / t_off * 100.0)
    return {"enabled_s": t_on, "disabled_s": t_off,
            "enabled_series_s": times[True],
            "disabled_series_s": times[False],
            "device": device,
            "traced": traced,
            "overhead_pct": round(overhead, 3),
            "threshold_pct": threshold_pct,
            "ok": overhead <= threshold_pct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="repair",
                    choices=["repair", "recovery-churn", "both",
                             "unrecoverable", "traced-day", "none"],
                    help="seeded workload to run before dumping "
                         "(unrecoverable: a past-budget repair whose "
                         "UnrecoverableError freezes a flight-"
                         "recorder post-mortem; traced-day: the "
                         "composed production day under the causal-"
                         "tracing collector, implies --traces; none: "
                         "dump whatever the process already recorded)")
    ap.add_argument("--device", default="cuda", choices=_demo.DEVICES,
                    help="host: numpy region ops and host repairs; "
                         "cuda: the card (default); cpu: the device "
                         "path on CPU tensors")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--requests", type=int, default=48,
                    help="traced-day: client requests in the stream")
    ap.add_argument("--format", default="json",
                    choices=["json", "prom", "both"])
    ap.add_argument("--indent", type=int, default=None)
    ap.add_argument("--validate", action="store_true",
                    help="validate the dump against the telemetry "
                         "JSON schema (rc 1 on failure)")
    ap.add_argument("--fake-clock", action="store_true",
                    help="drive spans/metrics/scenario with one "
                         "FakeClock — the dump becomes byte-identical "
                         "across runs (the determinism demo)")
    ap.add_argument("--check-overhead", type=float, default=None,
                    metavar="PCT",
                    help="measure instrumentation overhead on the "
                         "degraded bench row at --device; rc 3 if "
                         "above PCT")
    ap.add_argument("--with-traces", action="store_true",
                    help="run the --check-overhead enabled series "
                         "with a trace collector installed (the "
                         "tracing-enabled overhead gate)")
    ap.add_argument("--traces", action="store_true",
                    help="install a causal-tracing collector for the "
                         "scenario and include its dump as the "
                         "`traces` section (trace_schema_version 1; "
                         "implied by --scenario traced-day)")
    ap.add_argument("--profile", action="store_true",
                    help="sweep every device entry point of the "
                         "registry through the cost-attribution "
                         "profiler and include the `profile` section "
                         "(rc 1 if an unfiltered sweep leaves a device "
                         "entry row-less)")
    ap.add_argument("--profile-filter", action="append", default=[],
                    metavar="SUBSTR",
                    help="restrict --profile to entries whose name "
                         "contains SUBSTR (repeatable; disables the "
                         "coverage gate)")
    ap.add_argument("--profile-repeats", type=int, default=2,
                    help="measured dispatches per entry in --profile")
    ap.add_argument("--flight-recorder", action="store_true",
                    dest="flight",
                    help="include the flight recorder's ring + post-"
                         "mortem dumps as the `flight_recorder` "
                         "section")
    args = ap.parse_args(argv)

    if args.check_overhead is not None:
        res = check_overhead(args.check_overhead,
                             traced=args.with_traces,
                             device=args.device)
        print(json.dumps(res))
        return 0 if res["ok"] else 3

    if args.scenario == "traced-day":
        args.traces = True
    clock = None
    if args.fake_clock:
        from ..utils.retry import FakeClock
        clock = FakeClock()
        telemetry.set_global_tracer(
            telemetry.SpanTracer(clock=clock))
        telemetry.set_global_metrics(
            telemetry.MetricsRegistry(clock=clock))
        telemetry.set_global_flight_recorder(
            telemetry.FlightRecorder(clock=clock))
    telemetry.install_flight_recorder()
    telemetry.reset_all()
    if clock is None:
        # where the reference installs its compile monitor: the port's
        # counterpart, kernel setups, is counted always; registering
        # the series puts it in the dump even when nothing was set up
        telemetry.global_metrics().counter(telemetry.KERNEL_SETUPS, 0)
    prev_collector = None
    if args.traces:
        from ..telemetry import tracing
        prev_collector = tracing.install(tracing.TraceCollector(
            clock=clock, seed=args.seed))
    dev = args.device
    if args.scenario in ("repair", "both"):
        run_repair_scenario(args.seed, args.objects, clock=clock,
                            device=dev)
    if args.scenario in ("recovery-churn", "both"):
        run_recovery_scenario(args.seed, args.objects, clock=clock,
                              device=dev)
    if args.scenario == "unrecoverable":
        run_unrecoverable_scenario(args.seed, args.objects,
                                   clock=clock, device=dev)
    if args.scenario == "traced-day":
        run_traced_day(args.seed, args.requests, clock=clock,
                       device=dev)
    if args.profile:
        rc = run_profile_sweep(args.fake_clock, args.profile_repeats,
                               args.profile_filter, device=dev)
        if rc:
            return rc

    dump = telemetry.dump_all(profile=args.profile,
                              flight=args.flight,
                              traces=args.traces)
    if args.traces:
        from ..telemetry import tracing
        tracing.install(prev_collector)
    if args.validate:
        errors = telemetry.validate_dump(dump)
        if errors:
            for e in errors:
                print(f"schema: {e}", file=sys.stderr)
            return 1
    if args.format in ("json", "both"):
        print(json.dumps(dump, sort_keys=True, indent=args.indent))
    if args.format in ("prom", "both"):
        sys.stdout.write(telemetry.global_metrics().to_prometheus())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
