"""The port's lint CLI: the AST, concurrency and determinism tiers over
``ceph_tpu_torch/``, and the registry audit.

Usage:
    python -m ceph_tpu_torch.tools.lint [paths...]      # AST tier
    python -m ceph_tpu_torch.tools.lint --json ceph_tpu_torch/
    python -m ceph_tpu_torch.tools.lint --list-rules
    python -m ceph_tpu_torch.tools.lint --show-suppressed ceph_tpu_torch/ops
    python -m ceph_tpu_torch.tools.lint --check-suppressions
    python -m ceph_tpu_torch.tools.lint --conc            # locks and races
    python -m ceph_tpu_torch.tools.lint --det             # replay safety
    python -m ceph_tpu_torch.tools.lint --trace [--device cpu]
    python -m ceph_tpu_torch.tools.lint --trace --entry ops.apply_matrix_best
    python -m ceph_tpu_torch.tools.lint --list-entrypoints

The default path is the package itself.  Exit status: 0 when there is no
unsuppressed finding (and, with ``--check-suppressions``, no stale
pragma), 1 otherwise, 2 for an unknown ``--entry``.  The flags, the JSON
schema and the exit codes are those of the reference's lint CLI; the
pragma syntax is the same (``# tpu-lint: disable=<rule> -- reason``).

The three static tiers are pure ``ast``: they never import the scanned
code.  ``--trace`` is the port's counterpart of the reference's jaxpr
audit: it runs every entry of ``analysis/entrypoints.py`` through
``analysis/audit.py`` (kernel setups cold and warm, every tier byte for
byte, no host sync on a warm repeat) and fails on a registry gap.  It
runs the device entries on the card unless ``--device cpu`` is given;
``--no-sentinel`` drops the setup checks (the reference's recompile
sentinel).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..analysis import LintConfig, lint_paths, render_human, render_json
from ..analysis.report import render_rules

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_paths():
    return [PACKAGE_DIR]


def _run_trace(args) -> int:
    # imported here: the audit imports torch and the whole package; the
    # static tiers must not
    from ..analysis.audit import audit_registry
    from ..analysis.entrypoints import registry, registry_gaps
    from ..analysis.report import render_trace_human, render_trace_json
    from ..utils.errors import NoDeviceError

    entries = list(registry())
    if args.entry:
        wanted = set(args.entry)
        unknown = wanted - {e.name for e in entries}
        if unknown:
            print(f"unknown entry point(s): {sorted(unknown)} "
                  f"(--list-entrypoints shows the registry)",
                  file=sys.stderr)
            return 2
        entries = [e for e in entries if e.name in wanted]
    try:
        audits = audit_registry(entries, device=args.device)
    except NoDeviceError as e:
        print(f"tpu-audit: NoDeviceError: {e}", file=sys.stderr)
        return 1
    if args.no_sentinel:
        for a in audits:
            a.findings[:] = [f for f in a.findings
                             if not f.startswith("audit-setup")]
    # completeness is a registry-wide property; a filtered run must not
    # fail on entries it was asked to skip
    gaps = [] if args.entry else registry_gaps()
    if args.json:
        print(render_trace_json(audits, gaps))
    else:
        print(render_trace_human(audits, gaps))
    return 0 if all(a.ok for a in audits) and not gaps else 1


def _run_tier(args, tier: str) -> int:
    if tier == "conc":
        from ..analysis.concurrency import lint_conc_paths as lint
    else:
        from ..analysis.determinism import lint_det_paths as lint
    report = lint(args.paths or _default_paths(),
                  check_suppressions=args.check_suppressions)
    if args.json:
        print(render_json(report, tier=tier))
    else:
        print(render_human(report, show_suppressed=args.show_suppressed,
                           show_stale=args.check_suppressions,
                           label=f"tpu-{tier}"))
    ok = report.ok and not (args.check_suppressions and report.stale)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.tools.lint",
        description="AST static analysis (dtype, concurrency, replay "
                    "safety) and the registry audit of the port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: ceph_tpu_torch/)")
    ap.add_argument("--json", action="store_true",
                    help="JSON output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every AST rule and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="ID", help="run only these rule ids")
    ap.add_argument("--check-suppressions", action="store_true",
                    help="flag stale disable= pragmas that no longer "
                         "suppress any finding")
    ap.add_argument("--trace", action="store_true",
                    help="run the registry audit (analysis/audit.py) "
                         "over every entry point")
    ap.add_argument("--conc", action="store_true",
                    help="run the concurrency tier (lock discovery, "
                         "guard inference, conc-* rules, lockmodel "
                         "registry cross-check)")
    ap.add_argument("--det", action="store_true",
                    help="run the determinism tier (det-* replay-"
                         "safety rules, replaymodel domain/seam "
                         "registry cross-check)")
    ap.add_argument("--entry", action="append", default=None,
                    metavar="NAME",
                    help="with --trace: audit only these entry points")
    ap.add_argument("--no-sentinel", action="store_true",
                    help="with --trace: drop the kernel-setup checks "
                         "(audit-setup)")
    ap.add_argument("--list-entrypoints", action="store_true",
                    help="print the entry-point registry and exit")
    ap.add_argument("--device", default=None,
                    help="with --trace: where device entries run "
                         "(default: the card; 'cpu' on a host without "
                         "one)")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(render_rules())
        return 0
    if args.list_entrypoints:
        from ..analysis.entrypoints import registry
        for e in registry():
            print(f"{e.name}  [{e.family}/{e.kind}] "
                  f"setup_budget={e.setup_budget}")
        return 0
    if args.trace:
        return _run_trace(args)
    if args.conc:
        return _run_tier(args, "conc")
    if args.det:
        return _run_tier(args, "det")

    config = LintConfig(
        enabled_rules=frozenset(args.rule) if args.rule else None)
    report = lint_paths(args.paths or _default_paths(), config)
    if args.json:
        print(render_json(report))
    else:
        print(render_human(report, show_suppressed=args.show_suppressed,
                           show_stale=args.check_suppressions))
    ok = report.ok and not (args.check_suppressions and report.stale)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
