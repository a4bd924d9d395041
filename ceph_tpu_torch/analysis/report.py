"""Report rendering: human-readable (one finding per line, grep-able
``path:line:col: [rule] message``) and JSON (stable schema for CI
tooling)."""

from __future__ import annotations

import json
from typing import List

from .rules import ALL_RULES
from .scanner import LintReport

# bumped to 2 when the conc tier landed: every JSON payload now
# carries ``lint_schema_version`` + ``tier`` so CI consumers can tell
# the four machine-readable reports (ast | trace | conc | det) apart
LINT_SCHEMA_VERSION = 2


def render_human(report: LintReport, show_suppressed: bool = False,
                 show_stale: bool = False,
                 label: str = "tpu-lint") -> str:
    lines: List[str] = []
    for fr in report.files:
        for f in fr.findings:
            lines.append(f.render())
        if show_stale:
            for f in fr.stale:
                lines.append(f.render())
        if show_suppressed:
            for f in fr.suppressed:
                reason = f" ({f.suppress_reason})" if f.suppress_reason \
                    else ""
                lines.append(f"{f.render()} [suppressed{reason}]")
    n_files = len(report.files)
    n = len(report.findings)
    ns = len(report.suppressed)
    stale = f", {len(report.stale)} stale" if show_stale else ""
    lines.append(
        f"{label}: {n} finding{'s' if n != 1 else ''} "
        f"({ns} suppressed{stale}) in {n_files} file"
        f"{'s' if n_files != 1 else ''}")
    return "\n".join(lines)


def render_json(report: LintReport, tier: str = "ast") -> str:
    payload = {
        "lint_schema_version": LINT_SCHEMA_VERSION,
        "tier": tier,
        "files": len(report.files),
        "findings": [f.as_dict() for f in report.findings],
        "suppressed": [f.as_dict() for f in report.suppressed],
        "stale": [f.as_dict() for f in report.stale],
        "ok": report.ok,
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def render_rules() -> str:
    from .concurrency import CONC_RULES
    from .determinism import DET_RULES

    lines = []
    for rule in ALL_RULES:
        lines.append(f"{rule.id} [{rule.category}]")
        lines.append(f"    {rule.description}")
    for rule in CONC_RULES:
        lines.append(f"{rule.id} [{rule.category}] (--conc)")
        lines.append(f"    {rule.description}")
    for rule in DET_RULES:
        lines.append(f"{rule.id} [{rule.category}] (--det)")
        lines.append(f"    {rule.description}")
    return "\n".join(lines)


# -- trace tier: the port's registry audit (analysis/audit.py) ---------

def render_trace_human(audits, gaps=()) -> str:
    """Human report for a list of ``audit.EntryAudit``: one status line
    per entry point, each finding under it, then the registry gaps."""
    lines: List[str] = []
    for a in audits:
        status = "ok" if a.ok else "FAIL"
        lines.append(f"  {status:4s} {a.name} [{a.kind}] device={a.device}"
                     f" cold={a.cold_setups} warm={a.warm_setups}"
                     f" sync={a.sync}")
        for f in a.findings:
            lines.append(f"    {f}")
    for g in gaps:
        lines.append(f"  registry gap: {g}")
    n = sum(len(a.findings) for a in audits)
    lines.append(
        f"tpu-audit: {len(audits)} entry points audited, "
        f"{n} finding{'s' if n != 1 else ''}, "
        f"{len(gaps)} registry gap{'s' if len(gaps) != 1 else ''}")
    return "\n".join(lines)


def render_trace_json(audits, gaps=()) -> str:
    payload = {
        "lint_schema_version": LINT_SCHEMA_VERSION,
        "tier": "trace",
        "entries": [
            {
                "name": a.name,
                "kind": a.kind,
                "device": a.device,
                "ok": a.ok,
                "cold_setups": a.cold_setups,
                "warm_setups": a.warm_setups,
                "setup_budget": a.setup_budget,
                "tiers": list(a.tiers),
                "sync": a.sync,
                "findings": list(a.findings),
            }
            for a in audits
        ],
        "gaps": list(gaps),
        "ok": all(a.ok for a in audits) and not gaps,
    }
    return json.dumps(payload, indent=2, sort_keys=True)
