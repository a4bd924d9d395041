"""``# tpu-lint:`` pragma handling.

Pragmas are comments, extracted with :mod:`tokenize` (so a pragma-shaped
string literal never suppresses anything):

- ``# tpu-lint: disable=rule-a,rule-b -- reason``
  On a code line: suppresses those rules for any finding whose span
  covers that line.  On a standalone comment line: applies to the next
  code line (decorator lines count, so a pragma above ``@jit`` covers
  the whole decorated function header).
- ``# tpu-lint: disable-file=rule-a,rule-b -- reason``
  Suppresses the rules for the entire file.  ``disable-file=all``
  suppresses everything.
- ``# tpu-lint: scope=gf`` / ``scope=host`` — force the file in/out of
  the GF dtype scope (config.py).
- ``# tpu-lint: jit-function`` — the next ``def`` is treated as a jit
  region even though the jit wrapping happens elsewhere (factory
  functions whose closure is jitted by a caller, e.g. crush/bulk.py's
  compile_rule).

The ``-- reason`` tail is required practice for disables (docs/LINT.md)
and kept on the record so reports can show why a finding is accepted.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Optional, Set

PRAGMA_RE = re.compile(r"#\s*tpu-lint:\s*(?P<body>.+?)\s*$")
DISABLE_RE = re.compile(
    r"(?P<kind>disable(?:-file)?)\s*=\s*(?P<rules>[\w,\-]+)"
    r"(?:\s*--\s*(?P<reason>.*))?")


@dataclasses.dataclass
class Suppression:
    rules: Set[str]           # rule ids, or {"all"}
    line: int                 # line the suppression applies to (0 = file)
    reason: str = ""
    used: bool = False
    # which listed rules actually suppressed a finding — the
    # per-rule grain behind `--check-suppressions` (a pragma listing
    # two rules where only one still fires is half-stale)
    used_rules: Set[str] = dataclasses.field(default_factory=set)

    def matches(self, rule_id: str, start: int, end: int) -> bool:
        if rule_id not in self.rules and "all" not in self.rules:
            return False
        if self.line == 0:
            return True
        return start <= self.line <= end

    def record_use(self, rule_id: str) -> None:
        self.used = True
        self.used_rules.add(rule_id if rule_id in self.rules else "all")

    def stale_rules(self) -> Set[str]:
        """Listed rules that never suppressed anything (for ``all``:
        the whole pragma iff nothing matched)."""
        if "all" in self.rules:
            return set() if self.used_rules else {"all"}
        return self.rules - self.used_rules


@dataclasses.dataclass
class PragmaInfo:
    suppressions: List[Suppression]
    scope_override: Optional[str] = None    # "gf" | "host" | None
    jit_function_lines: Set[int] = dataclasses.field(default_factory=set)

    def suppression_for(self, rule_id: str, start: int,
                        end: int) -> Optional[Suppression]:
        for s in self.suppressions:
            if s.matches(rule_id, start, end):
                s.record_use(rule_id)
                return s
        return None


def collect_pragmas(source: str) -> PragmaInfo:
    info = PragmaInfo(suppressions=[])
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return info
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = PRAGMA_RE.search(tok.string)
        if not m:
            continue
        body = m.group("body")
        row, col = tok.start
        standalone = lines[row - 1][:col].strip() == ""
        if body.startswith("scope="):
            info.scope_override = body.split("=", 1)[1].strip()
            continue
        if body.strip() == "jit-function":
            info.jit_function_lines.add(
                _next_code_line(lines, row) if standalone else row)
            continue
        d = DISABLE_RE.match(body)
        if not d:
            continue
        rules = {r.strip() for r in d.group("rules").split(",") if r.strip()}
        reason = (d.group("reason") or "").strip()
        if d.group("kind") == "disable-file":
            info.suppressions.append(Suppression(rules, 0, reason))
        else:
            line = row if not standalone else _next_code_line(lines, row)
            info.suppressions.append(Suppression(rules, line, reason))
    return info


def _next_code_line(lines: List[str], comment_row: int) -> int:
    for i in range(comment_row, len(lines)):
        stripped = lines[i].strip()
        if stripped and not stripped.startswith("#"):
            return i + 1
    return comment_row
