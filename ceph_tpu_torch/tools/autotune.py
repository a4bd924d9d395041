"""autotune — the config search, persisted; the port's counterpart of
the repo root's ``tools/autotune.py``.

    python -m ceph_tpu_torch.tools.autotune --analytic --out t.json --validate
    python -m ceph_tpu_torch.tools.autotune --plugin jerasure \\
        -P technique=reed_sol_r6_op -P k=8 --size 1048576 --batch 64

Sweeps the bounded declarative config space
(``ceph_tpu_torch/tune/space.py``) — the mxu/XOR/dense cutovers, the
CSE horizon, the serve rung ladder, the stripe pool, the mesh fan-out,
per-matrix engine pins — with the two measurement modes of the program
profiler, and persists the winners in a versioned, schema-validated
best-config table (``tune/table.py``) the consultation seams read.

1. **Baseline first** — the timed mode first drives the engine's cached
   callables for the chosen plugin (``-w profile`` on the card), so the
   profiler's attribution rows hold measured hot rows before any
   tuning; the analytic mode prints the model's "before" side.
2. **Sweep** — ``--analytic`` prices every candidate under the roofline
   model with no device touched; the default timed mode runs every tier
   the card can dispatch, the min of ``--repeats`` device times each,
   asserting byte identity across every candidate tier.
3. **Persist** — winners land in ``--out`` (atomic write).  Point
   ``CEPH_TPU_TUNE_TABLE=<path>`` (or the bench CLI's ``--tune-table``)
   at the file and a later process consults it.  Stale entries (another
   platform, device count, torch or CUDA version, card, or schema) are
   ignored with a ``tune_config_stale`` counter; missing entries fall
   back to the hand-picked constants byte-identically.
4. **Close with before/after rows** — one utilization row per tuned
   key, before and after, from the profiler's own attribution join.

Exit codes: 0 ok · 1 sweep/validation failure · 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_OUT = "TUNE_TABLE.json"


def _parse_parameters(params):
    profile = {}
    for p in params:
        if "=" not in p:
            raise SystemExit(2)
        name, value = p.split("=", 1)
        profile[name] = value
    return profile


def _print_rows(title, rows, out):
    print(f"-- {title}", file=out)
    for r in rows:
        b, a = r.get("before", {}), r.get("after", {})
        bu, au = b.get("utilization_pct"), a.get("utilization_pct")
        print(f"   {r['name']:<36} "
              f"{b.get('engine') or b.get('config')} -> "
              f"{a.get('engine') or a.get('config')}  "
              f"util {bu if bu is not None else '-'}% -> "
              f"{au if au is not None else '-'}%  "
              f"(+{r.get('improvement_pct')}%)", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="autotune", description=__doc__.splitlines()[0])
    ap.add_argument("--analytic", action="store_true",
                    help="host-only analytic mode: the roofline cost "
                         "model, no device touched")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="FILE",
                    help=f"best-config table path (default {DEFAULT_OUT} "
                         f"in the working directory)")
    ap.add_argument("--validate", action="store_true",
                    help="re-load + schema-validate the written table; "
                         "analytic mode additionally re-runs the sweep "
                         "and pins byte-identical output")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="print the full sweep report as one JSON line")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed mode: min-of-N dispatches per candidate")
    ap.add_argument("--plugin", default="jerasure",
                    help="timed mode: plugin to tune")
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    help="timed mode: profile parameter name=value")
    ap.add_argument("--size", type=int, default=1 << 18,
                    help="timed mode: object size per stripe")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--top", type=int, default=8,
                    help="baseline hot-program rows to print")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="timed mode: the card (default) or the CPU's "
                         "torch tier")
    args = ap.parse_args(argv)

    from ..tune import sweep as tsweep
    from ..tune.table import BestConfigTable, validate_table

    err = sys.stderr
    if args.analytic:
        report = tsweep.analytic_sweep(seed=args.seed)
        baseline = [r for r in report.attribution
                    if r.get("phase") == "before"][:args.top]
    else:
        try:
            from ..bench.erasure_code_benchmark import ErasureCodeBench
            from ..telemetry.profiler import global_profiler

            # baseline: drive the engine's cached callables for the
            # chosen plugin so attribution_rows() has measured hot rows
            # BEFORE any tuning (the instrument's before side)
            bench = ErasureCodeBench()
            bench.setup(["--plugin", args.plugin, "--size",
                         str(args.size), "--batch", str(args.batch),
                         "--workload", "profile", "--iterations", "2",
                         "-e", "1", "--seed", str(args.seed),
                         "--device", args.device]
                        + [x for p in args.parameter
                           for x in ("--parameter", p)])
            bench.run()
            baseline = global_profiler().attribution_rows()[:args.top]
        except Exception as e:  # noqa: BLE001 — report, point at --analytic
            print(f"autotune: device unreachable "
                  f"({type(e).__name__}: {e}); use --analytic for "
                  f"the host-only sweep", file=err)
            return 1
        report = tsweep.timed_sweep(
            plugin=args.plugin,
            profile=_parse_parameters(args.parameter) or None,
            size=args.size, batch=args.batch, repeats=args.repeats,
            seed=args.seed, device=args.device)

    out = sys.stderr if args.json_out else sys.stdout
    print(f"autotune: mode={report.mode} platform={report.platform} "
          f"device_count={report.device_count} "
          f"candidates swept deterministically (seed {report.seed})",
          file=out)
    if baseline:
        print("-- baseline (attribution_rows, hottest first)",
              file=out)
        for r in baseline:
            print(f"   {r.get('series', r['name']):<64} "
                  f"util {r.get('utilization_pct')}% "
                  f"p50 {r.get('p50_ms')} ms", file=out)
    _print_rows("before/after (the tuner's own utilization rows)",
                report.rows, out)
    print(f"-- tuned keys: {len(report.table)}", file=out)
    for k in sorted(report.table.entries):
        print(f"   {k}: {report.table.entries[k]['config']}", file=out)

    errors = validate_table(report.table.to_dict())
    if errors:
        print(f"autotune: emitted table INVALID: {errors}", file=err)
        return 1
    try:
        report.table.save(args.out)
    except OSError as e:
        print(f"autotune: cannot write table to {args.out!r}: {e}",
              file=err)
        return 1
    print(f"autotune: best-config table -> {args.out} "
          f"(install via CEPH_TPU_TUNE_TABLE={os.path.abspath(args.out)})",
          file=out)

    if args.validate:
        reloaded = BestConfigTable.load(args.out)
        if reloaded.to_json() != report.table.to_json():
            print("autotune: reloaded table differs from emitted",
                  file=err)
            return 1
        if args.analytic:
            again = tsweep.analytic_sweep(seed=args.seed)
            if json.dumps(again.to_dict(), sort_keys=True) != \
                    json.dumps(report.to_dict(), sort_keys=True):
                print("autotune: analytic sweep not deterministic",
                      file=err)
                return 1
        print("autotune: validation ok (schema + round-trip"
              + (" + determinism" if args.analytic else "") + ")",
              file=out)

    if args.json_out:
        print(json.dumps(report.to_dict(), sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
