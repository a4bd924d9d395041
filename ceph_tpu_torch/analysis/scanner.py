"""File discovery + per-file lint driving.

``lint_paths`` walks the given files/directories (``*.py`` only,
skipping ``__pycache__``), parses each file once, runs every enabled
rule, and splits findings into live vs suppressed using the file's
``# tpu-lint:`` pragmas.  A file that does not parse yields a single
``parse-error`` finding (never suppressible — broken source cannot
vouch for itself).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

from .config import LintConfig
from .jitregions import RegionAnalyzer
from .rules import ALL_RULES, Finding, LintContext, Rule
from .suppress import collect_pragmas


@dataclasses.dataclass
class FileReport:
    path: str
    findings: List[Finding]            # unsuppressed
    suppressed: List[Finding]
    parse_error: Optional[str] = None
    # `# tpu-lint: disable=` pragmas (AST-tier rules only) that no
    # longer suppress anything — reported by `--check-suppressions`
    stale: List[Finding] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LintReport:
    files: List[FileReport]

    @property
    def findings(self) -> List[Finding]:
        return [f for fr in self.files for f in fr.findings]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for fr in self.files for f in fr.suppressed]

    @property
    def stale(self) -> List[Finding]:
        return [f for fr in self.files for f in fr.stale]

    @property
    def ok(self) -> bool:
        return not self.findings


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def _rel_path(path: str) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:
        rel = path
    return path if rel.startswith("..") else rel


def lint_file(path: str, config: Optional[LintConfig] = None,
              rules: Optional[Sequence[Rule]] = None) -> FileReport:
    config = config or LintConfig()
    rules = list(rules) if rules is not None else list(ALL_RULES)
    rel = _rel_path(path)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
    except OSError as e:
        return FileReport(rel, [Finding("parse-error", rel, 0, 0, 0,
                                        f"cannot read: {e}")], [])
    return lint_source(source, rel, config, rules)


def lint_source(source: str, rel_path: str,
                config: Optional[LintConfig] = None,
                rules: Optional[Sequence[Rule]] = None) -> FileReport:
    config = config or LintConfig()
    rules = list(rules) if rules is not None else list(ALL_RULES)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return FileReport(
            rel_path,
            [Finding("parse-error", rel_path, e.lineno or 0, 0,
                     e.lineno or 0, f"syntax error: {e.msg}")],
            [])
    pragmas = collect_pragmas(source)
    if pragmas.scope_override is not None:
        gf_scoped = pragmas.scope_override == "gf"
    else:
        gf_scoped = config.in_gf_scope(rel_path)
    regions = RegionAnalyzer(tree, pragmas.jit_function_lines)
    ctx = LintContext(rel_path, rel_path, tree, source, gf_scoped,
                      regions)
    live: List[Finding] = []
    suppressed: List[Finding] = []
    seen = set()
    for rule in rules:
        if not config.rule_enabled(rule.id):
            continue
        for finding in rule.check(ctx):
            key = (finding.rule, finding.line, finding.col,
                   finding.message)
            if key in seen:
                continue
            seen.add(key)
            sup = pragmas.suppression_for(finding.rule, finding.line,
                                          finding.end_line)
            if sup is not None:
                finding.suppressed = True
                finding.suppress_reason = sup.reason
                suppressed.append(finding)
            else:
                live.append(finding)
    live.sort(key=lambda f: (f.line, f.col, f.rule))
    suppressed.sort(key=lambda f: (f.line, f.col, f.rule))
    return FileReport(rel_path, live, suppressed,
                      stale=_stale_findings(rel_path, pragmas, config))


def _stale_findings(rel_path: str, pragmas, config: LintConfig
                    ) -> List[Finding]:
    """``disable=`` pragmas whose AST-tier rules matched nothing this
    scan.  Trace-tier (``audit-*``) pragmas belong to the reference's
    jaxpr auditor (the port's registry audit reads none), concurrency-tier
    (``conc-*``) pragmas the lock analyzer's
    (concurrency.lint_conc_paths), and determinism-tier (``det-*``)
    pragmas the replay analyzer's (determinism.lint_det_paths); all
    skipped here.  Only meaningful on full-rule runs: a
    ``--rule``-filtered scan never marks the other rules' pragmas
    stale."""
    if config.enabled_rules is not None:
        return []
    out: List[Finding] = []
    for s in pragmas.suppressions:
        for rule in sorted(s.stale_rules()):
            if (rule.startswith("audit-") or rule.startswith("conc-")
                    or rule.startswith("det-")
                    or rule in config.disabled_rules):
                continue
            line = s.line or 1
            reason = f" -- {s.reason}" if s.reason else ""
            out.append(Finding(
                "stale-suppression", rel_path, line, 0, line,
                f"suppression for '{rule}' no longer matches any "
                f"finding{reason}"))
    return out


def lint_paths(paths: Sequence[str],
               config: Optional[LintConfig] = None,
               rules: Optional[Sequence[Rule]] = None) -> LintReport:
    config = config or LintConfig()
    reports = [lint_file(p, config, rules)
               for p in iter_python_files(paths)]
    return LintReport(reports)
