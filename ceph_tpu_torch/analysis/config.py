"""Lint configuration: rule selection and the GF dtype scope.

The GF scope is path-based: any file whose directory chain contains one
of ``gf_scope_dirs`` holds GF(2^8)/GF(2^w) symbol code, where integer
dtypes are a byte-format contract (PARITY.md), not a style choice.
``gf_scope_whitelist`` names the deliberate float ladders (the straw2
crush_ln fixed-point generator) that sit outside the contract even when
a scope dir ever contains them.  A file can also opt in/out explicitly
with ``# tpu-lint: scope=gf`` / ``# tpu-lint: scope=host`` (used by the
lint fixtures, which cannot live inside the package tree).
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LintConfig:
    # directory names whose files carry GF symbol data end to end
    gf_scope_dirs: Tuple[str, ...] = ("gf", "ops", "codes", "matrices")
    # path suffixes exempt from the GF dtype rules even if scoped
    gf_scope_whitelist: Tuple[str, ...] = ("crush/ln.py",)
    # None = every registered rule; else only these rule ids
    enabled_rules: Optional[FrozenSet[str]] = None
    disabled_rules: FrozenSet[str] = frozenset()

    def rule_enabled(self, rule_id: str) -> bool:
        if rule_id in self.disabled_rules:
            return False
        if self.enabled_rules is not None:
            return rule_id in self.enabled_rules
        return True

    def in_gf_scope(self, rel_path: str) -> bool:
        norm = rel_path.replace("\\", "/")
        for suffix in self.gf_scope_whitelist:
            if norm.endswith(suffix):
                return False
        parts = norm.split("/")[:-1]
        return any(p in self.gf_scope_dirs for p in parts)
