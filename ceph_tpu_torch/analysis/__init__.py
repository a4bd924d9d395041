"""ceph_tpu_torch.analysis — the port's static analysis and its tables.

Three static tiers, pure stdlib ``ast`` (they never import the scanned
code), ported from the reference's ``analysis`` package with the same
rules, findings and pragma syntax (``# tpu-lint: disable=<rule> --
reason``, ``# tpu-lint: scope=gf|host``):

- the AST tier (``config``, ``suppress``, ``jitregions``, ``rules``,
  ``scanner``, ``report``): integer dtypes on the GF symbol paths
  (``gf/``, ``ops/``, ``codes/``, ``matrices/``), Python arithmetic on
  GF table values, and the rules of jitted regions.  ``jitregions``
  finds jax regions only; the port has none, so the region rules
  (host sync, static args, closures, purity, tracer branches) find
  nothing in it and act on the fixtures alone;
- the concurrency tier (``concurrency``): lock discovery, guard sets,
  lock order, blocking calls under a lock, cross-checked against the
  lock-order registry ``lockmodel.py`` (whose ranks the runtime
  validator ``utils/locks.py`` also reads);
- the determinism tier (``determinism``): wall clock, RNG, environment
  and set order in replay domains, cross-checked against
  ``replaymodel.py`` (the domains, clock seams and fallbacks of
  ``utils/detcheck.py``, and environment seams).

Beside them, the entry-point registry (``entrypoints.py``) and its audit
(``audit.py``), the port's counterpart of the reference's jaxpr audit,
which run the code (imported on use: they need torch and the package).
``python -m ceph_tpu_torch.tools.lint`` runs all of them.
"""

from .config import LintConfig
from .rules import ALL_RULES, Finding, Rule
from .scanner import FileReport, LintReport, lint_file, lint_paths
from .report import render_human, render_json
from .concurrency import (CONC_RULE_IDS, CONC_RULES, lint_conc_paths,
                          scan_paths, static_lock_graph)
from .determinism import DET_RULE_IDS, DET_RULES, lint_det_paths
from .replaymodel import (CLOCK_FALLBACKS, DOMAINS, ENV_SEAMS,
                          domain_kind, fallback_ids, is_replay)

__all__ = [
    "ALL_RULES",
    "CLOCK_FALLBACKS",
    "CONC_RULES",
    "CONC_RULE_IDS",
    "DET_RULES",
    "DET_RULE_IDS",
    "DOMAINS",
    "ENV_SEAMS",
    "FileReport",
    "Finding",
    "LintConfig",
    "LintReport",
    "Rule",
    "domain_kind",
    "fallback_ids",
    "is_replay",
    "lint_conc_paths",
    "lint_det_paths",
    "lint_file",
    "lint_paths",
    "render_human",
    "render_json",
    "scan_paths",
    "static_lock_graph",
]
