"""det tier — static replay-safety analysis.

A pure-AST pass (never imports the scanned code) proving the property
every byte-identity gate in this repo rests on: replay-critical code
consults nothing a seeded, clock-injected rerun cannot reproduce.
Driven by the declarative :mod:`.replaymodel` registry, which
classifies modules ``replay`` vs ``wallclock`` (unlisted modules
default to replay — exemption is a declaration, never an accident)
and names the sanctioned seams: the ``SystemClock`` gateways, the
registered ``utils.detcheck.default_clock`` fallback sites, and the
call-time config seams.

Rules (pragma-suppressible like every other tier, docs/LINT.md):

==================  ==================================================
det-wallclock       ``time.time/monotonic/perf_counter/sleep`` or
                    ``datetime.now`` called in a replay domain outside
                    a registered clock seam
det-unseeded-rng    ``random`` module globals, legacy ``np.random.*``,
                    no-seed ``default_rng()``/``Random()``, ``uuid4``,
                    ``os.urandom``, ``secrets``, builtin ``hash()``
                    (PYTHONHASHSEED-salted for str) in a replay domain
det-set-order       iterating a ``set``/``frozenset`` into an ordered
                    consumer (for, list/tuple, dict/list
                    comprehension, join) without ``sorted()``
det-env-read        ``os.environ`` consulted at call time in a replay
                    domain outside a registered config seam
det-clock-leak      a direct system-clock fallback not routed through
                    ``utils.detcheck.default_clock``, an unregistered
                    or drifting seam id, or a stale replaymodel entry
==================  ==================================================

The runtime half lives in utils/detcheck.py (``CEPH_TPU_DETCHECK=1``):
it wraps exactly the registered fallback seams so a wall-clock
consultation while an injected clock is installed is counted and
flight-recorded; tools/replay_bisect.py then binary-searches a pair of
runs to the first divergent checkpoint.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import replaymodel
from .concurrency import IMPORT_PACKAGES, _dotted, module_name_for
from .rules import Finding
from .scanner import FileReport, LintReport, _rel_path, iter_python_files
from .suppress import collect_pragmas

DET_PREFIX = "det-"


class DetRule:
    """Descriptor-only rule record (the checks are registry-driven
    module scans, not per-file visitors with a ``check(ctx)``)."""

    def __init__(self, id: str, category: str, description: str) -> None:
        self.id = id
        self.category = category
        self.description = description


DET_RULES: Tuple[DetRule, ...] = (
    DetRule("det-wallclock", "replay",
            "wall-clock read (time.time/monotonic/perf_counter/sleep, "
            "datetime.now) in a replay domain outside a registered "
            "clock seam — take an injected clock instead"),
    DetRule("det-unseeded-rng", "replay",
            "nondeterministic randomness in a replay domain: random "
            "module globals, legacy np.random.*, default_rng()/"
            "Random() without a seed, uuid4/uuid1, os.urandom, "
            "secrets, or builtin hash() (PYTHONHASHSEED-salted)"),
    DetRule("det-set-order", "replay",
            "set/frozenset iterated into an ordered consumer without "
            "sorted() — hash order varies across processes"),
    DetRule("det-env-read", "replay",
            "os.environ consulted at call time in a replay domain "
            "outside a registered config seam (replaymodel.ENV_SEAMS)"),
    DetRule("det-clock-leak", "replay",
            "default wall-clock fallback not routed through "
            "utils.detcheck.default_clock with a registered seam id "
            "(or a seam id drifting from replaymodel.CLOCK_FALLBACKS)"),
)

DET_RULE_IDS = frozenset(r.id for r in DET_RULES)

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.thread_time", "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

_RANDOM_GLOBALS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "triangular",
    "vonmisesvariate", "paretovariate", "weibullvariate",
    "getrandbits", "randbytes", "seed",
}

_NP_RANDOM_LEGACY = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "seed", "uniform",
    "normal", "standard_normal", "beta", "gamma", "poisson",
    "exponential", "binomial", "bytes", "get_state", "set_state",
}

_SET_SINKS = {"list", "tuple", "enumerate", "iter"}

# a comprehension consumed whole by one of these is order-insensitive
# (sum is deliberately absent — float addition is order-sensitive —
# and so is dict, which preserves insertion order into serialization)
_ORDER_INSENSITIVE = {"sorted", "set", "frozenset", "min", "max",
                      "any", "all", "len"}

_DEFAULT_CLOCK = "utils.detcheck.default_clock"
_SYSTEM_CLOCK = "utils.retry.SystemClock"


@dataclasses.dataclass
class _FallbackSite:
    rel: str
    module: str
    line: int
    seam: Optional[str]       # the string-literal first argument, if any


# ----------------------------------------------------------------------
# per-module scan


class _DetScan(ast.NodeVisitor):
    """One module's pass: import-alias resolution + context-stacked
    rule checks against the replaymodel registry."""

    def __init__(self, rel: str, emit) -> None:
        self.rel = rel
        self.module = module_name_for(rel)
        self._emit_finding = emit
        self.kind = replaymodel.domain_kind(self.module)
        self.clock_seams = replaymodel.clock_seam_quals(self.module)
        self.env_seams = replaymodel.env_seam_quals(self.module)
        self.import_mods: Dict[str, str] = {}
        self.import_syms: Dict[str, Tuple[str, str]] = {}
        self.cls_stack: List[str] = []
        self.func_stack: List[str] = []
        self.set_scopes: List[Set[str]] = []
        self.fallback_sites: List[_FallbackSite] = []
        self._order_exempt: Set[int] = set()

    # -- plumbing ------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self._emit_finding(self.rel, rule, node.lineno, node.col_offset,
                           getattr(node, "end_lineno", node.lineno)
                           or node.lineno, message)

    def _norm_module(self, dotted: str) -> str:
        for pkg in IMPORT_PACKAGES:
            if dotted.startswith(pkg + "."):
                return dotted[len(pkg) + 1:]
        if dotted in IMPORT_PACKAGES:
            return "__init__"
        return dotted

    def _rel_import_base(self, level: int) -> List[str]:
        parts = self.module.split(".") if self.module else []
        keep = len(parts) - level
        return parts[:keep] if keep > 0 else []

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            target = a.name if a.asname else a.name.split(".")[0]
            self.import_mods[alias] = self._norm_module(target)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level:
            base = self._rel_import_base(node.level)
            mod = ".".join(base + ([node.module] if node.module else []))
        else:
            mod = self._norm_module(node.module or "")
        for a in node.names:
            alias = a.asname or a.name
            self.import_syms[alias] = (mod, a.name)

    def _resolve(self, func: ast.AST) -> Optional[str]:
        """Fully-qualified origin ("time.monotonic",
        "numpy.random.rand", "utils.retry.SystemClock") for a call
        target, resolved through this module's import aliases."""
        dotted = _dotted(func)
        if dotted is None:
            return None
        parts = dotted.split(".")
        head = parts[0]
        if head in self.import_mods:
            return ".".join([self.import_mods[head]] + parts[1:])
        if head in self.import_syms:
            mod, sym = self.import_syms[head]
            base = f"{mod}.{sym}" if mod else sym
            return ".".join([base] + parts[1:])
        return None

    def _candidates(self) -> Set[str]:
        """Qual candidates for seam matching at the current nesting:
        every enclosing function name, class name, and Class.method
        combination (so closures inside a seam stay inside it)."""
        c: Set[str] = set(self.func_stack) | set(self.cls_stack)
        for cls in self.cls_stack:
            for f in self.func_stack:
                c.add(f"{cls}.{f}")
        return c

    # -- scope walking -------------------------------------------------

    def run(self, tree: ast.Module) -> None:
        self.set_scopes.append(self._collect_set_names(tree.body))
        self.visit(tree)
        self.set_scopes.pop()

    def _collect_set_names(self, body: Sequence[ast.stmt]) -> Set[str]:
        """Names bound to a set expression anywhere in this scope
        (shallow: nested function/class scopes excluded)."""
        names: Set[str] = set()
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.AST):
                for t in n.targets:
                    if isinstance(t, ast.Name) and \
                            self._is_set_literal(n.value):
                        names.add(t.id)
            elif isinstance(n, ast.AnnAssign) and n.value is not None \
                    and isinstance(n.target, ast.Name) \
                    and self._is_set_literal(n.value):
                names.add(n.target.id)
            stack.extend(ast.iter_child_nodes(n))
        return names

    def _is_set_literal(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("set", "frozenset"):
            return True
        return False

    def _is_set_expr(self, node: ast.AST) -> bool:
        if self._is_set_literal(node):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in scope for scope in self.set_scopes)
        return False

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_func(self, node) -> None:
        self.func_stack.append(node.name)
        self.set_scopes.append(self._collect_set_names(node.body))
        self.generic_visit(node)
        self.set_scopes.pop()
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- det-set-order ------------------------------------------------

    def _flag_set_iter(self, expr: ast.AST, how: str) -> None:
        if self.kind == "replay" and self._is_set_expr(expr):
            self._emit("det-set-order", expr,
                       f"set iterated {how} without sorted() — "
                       f"iteration order varies with PYTHONHASHSEED; "
                       f"wrap in sorted(...)")

    def visit_For(self, node: ast.For) -> None:
        self._flag_set_iter(node.iter, "by a for loop")
        self.generic_visit(node)

    def _visit_ordered_comp(self, node) -> None:
        if id(node) not in self._order_exempt:
            for gen in node.generators:
                self._flag_set_iter(gen.iter, "by a comprehension")
        self.generic_visit(node)

    visit_ListComp = _visit_ordered_comp
    visit_DictComp = _visit_ordered_comp
    visit_GeneratorExp = _visit_ordered_comp
    # SetComp deliberately absent: a set built from a set leaks no order

    # -- det-env-read helpers ------------------------------------------

    def _is_environ(self, node: ast.AST) -> bool:
        dotted = _dotted(node)
        if dotted is None:
            return False
        parts = dotted.split(".")
        head = parts[0]
        if head in self.import_mods:
            full = ".".join([self.import_mods[head]] + parts[1:])
        elif head in self.import_syms:
            mod, sym = self.import_syms[head]
            full = ".".join([f"{mod}.{sym}"] + parts[1:])
        else:
            return False
        return full == "os.environ"

    def _env_read_allowed(self) -> bool:
        # module-level reads are import-time configuration; call-time
        # reads must sit inside a registered config seam
        return not self.func_stack or \
            bool(self._candidates() & self.env_seams)

    def _flag_env(self, node: ast.AST, what: str) -> None:
        if self.kind == "replay" and not self._env_read_allowed():
            self._emit("det-env-read", node,
                       f"{what} consulted at call time in a replay "
                       f"domain — read it at a registered config seam "
                       f"(replaymodel.ENV_SEAMS) or at import time")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self._is_environ(node.value):
            self._flag_env(node, "os.environ[...]")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                and any(self._is_environ(c) for c in node.comparators):
            self._flag_env(node, "os.environ membership")
        self.generic_visit(node)

    # -- calls: wallclock / rng / env / clock-leak / set sinks ---------

    def visit_Call(self, node: ast.Call) -> None:
        # sorted(x for x in someset) is the FIX for det-set-order, not
        # an instance of it: exempt comprehensions consumed whole by
        # an order-insensitive builtin before descending
        if isinstance(node.func, ast.Name) \
                and node.func.id in _ORDER_INSENSITIVE:
            for a in node.args:
                if isinstance(a, (ast.GeneratorExp, ast.ListComp,
                                  ast.SetComp, ast.DictComp)):
                    self._order_exempt.add(id(a))

        full = self._resolve(node.func)

        # default_clock sites are collected in every domain; the model
        # validates the literal both ways against CLOCK_FALLBACKS
        if full == _DEFAULT_CLOCK:
            seam: Optional[str] = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                seam = node.args[0].value
            self.fallback_sites.append(
                _FallbackSite(self.rel, self.module, node.lineno, seam))
            if seam is None:
                self._emit("det-clock-leak", node,
                           "default_clock seam id must be a string "
                           "literal so the static pass can cross-check "
                           "it against replaymodel.CLOCK_FALLBACKS")
            else:
                fb = replaymodel.fallback(seam)
                if fb is None:
                    self._emit("det-clock-leak", node,
                               f"seam id '{seam}' is not registered — "
                               f"add a ClockFallback to "
                               f"analysis/replaymodel.py")
                elif fb.module != self.module:
                    self._emit("det-clock-leak", node,
                               f"seam id '{seam}' is declared for "
                               f"module '{fb.module}' but this site "
                               f"lives in '{self.module}'")

        if self.kind != "replay":
            self.generic_visit(node)
            return

        cands = self._candidates()

        # det-wallclock
        if full in _WALLCLOCK_CALLS and not (cands & self.clock_seams):
            self._emit("det-wallclock", node,
                       f"{full}() in a replay domain — take an "
                       f"injected Clock (utils.retry) instead; real "
                       f"wall time breaks seeded replay")

        # det-clock-leak: a direct system-clock construction is the
        # old unwitnessed fallback pattern; route through default_clock
        sysclock = full == _SYSTEM_CLOCK or (
            isinstance(node.func, ast.Name)
            and node.func.id in self.clock_seams)
        if sysclock and not (cands & self.clock_seams):
            self._emit("det-clock-leak", node,
                       "direct system-clock fallback — route through "
                       "utils.detcheck.default_clock('<seam-id>', "
                       "<ClockFactory>) so CEPH_TPU_DETCHECK can "
                       "witness it")

        # det-unseeded-rng
        self._check_rng(node, full)

        # det-env-read (call forms)
        if full is not None and (full == "os.getenv"
                                 or full.startswith("os.environ.")):
            self._flag_env(node, full.replace("os.environ.get",
                                              "os.environ.get(...)"))

        # det-set-order sinks that materialize an ordered sequence
        if isinstance(node.func, ast.Name) \
                and node.func.id in _SET_SINKS and node.args:
            self._flag_set_iter(node.args[0],
                                f"into {node.func.id}(...)")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" and len(node.args) == 1:
            self._flag_set_iter(node.args[0], "into str.join")

        self.generic_visit(node)

    def _check_rng(self, node: ast.Call, full: Optional[str]) -> None:
        if isinstance(node.func, ast.Name) and node.func.id == "hash" \
                and "hash" not in self.import_syms:
            self._emit("det-unseeded-rng", node,
                       "builtin hash() is PYTHONHASHSEED-salted for "
                       "str/bytes — use zlib.crc32 or hashlib for "
                       "anything that reaches replayed output")
            return
        if full is None:
            return
        parts = full.split(".")
        head, tail = parts[0], parts[-1]
        no_args = not node.args and not node.keywords
        if full == "os.urandom" or head == "secrets":
            self._emit("det-unseeded-rng", node,
                       f"{full}() draws OS entropy — derive from the "
                       f"scenario seed instead")
        elif full in ("uuid.uuid4", "uuid.uuid1"):
            self._emit("det-unseeded-rng", node,
                       f"{full}() is nondeterministic — derive ids "
                       f"from the seeded stream")
        elif head == "random" and len(parts) == 2:
            if tail in _RANDOM_GLOBALS:
                self._emit("det-unseeded-rng", node,
                           f"random.{tail}() uses the process-global "
                           f"RNG — thread a seeded random.Random "
                           f"through instead")
            elif tail == "Random" and no_args:
                self._emit("det-unseeded-rng", node,
                           "Random() without a seed — pass a seed "
                           "derived from the scenario seed")
            elif tail == "SystemRandom":
                self._emit("det-unseeded-rng", node,
                           "SystemRandom draws OS entropy and can "
                           "never replay")
        elif full.startswith("numpy.random."):
            if tail == "default_rng":
                if no_args:
                    self._emit("det-unseeded-rng", node,
                               "default_rng() without a seed — pass "
                               "one derived from the scenario seed")
            elif tail == "RandomState" and no_args:
                self._emit("det-unseeded-rng", node,
                           "RandomState() without a seed")
            elif tail in _NP_RANDOM_LEGACY:
                self._emit("det-unseeded-rng", node,
                           f"legacy np.random.{tail}() uses the "
                           f"process-global RNG — use a seeded "
                           f"np.random.default_rng(seed) Generator")


# ----------------------------------------------------------------------
# whole-program model


class DetModel:
    def __init__(self) -> None:
        self.findings: Dict[str, List[Finding]] = {}
        self.scans: List[_DetScan] = []

    def add_source(self, source: str, rel: str,
                   path: Optional[str] = None) -> Optional[str]:
        """Parse + scan one file; returns a parse error or None."""
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            return f"syntax error: {e.msg} (line {e.lineno})"
        scan = _DetScan(rel, self._emit)
        scan.run(tree)
        self.scans.append(scan)
        return None

    def _emit(self, rel: str, rule: str, line: int, col: int,
              end_line: int, message: str) -> None:
        self.findings.setdefault(rel, []).append(
            Finding(rule, rel, line, col, end_line, message))

    def analyze(self) -> None:
        """Cross-file pass: a registered ClockFallback whose module
        was scanned but has no surviving default_clock site is stale
        (mirrors the stale-lockmodel-entry check)."""
        rel_by_module = {s.module: s.rel for s in self.scans}
        seen = {site.seam for s in self.scans
                for site in s.fallback_sites if site.seam}
        for fb in replaymodel.CLOCK_FALLBACKS:
            if fb.module in rel_by_module and fb.id not in seen:
                self._emit(rel_by_module[fb.module], "det-clock-leak",
                           1, 0, 1,
                           f"stale replaymodel entry: ClockFallback "
                           f"'{fb.id}' is registered but no "
                           f"default_clock('{fb.id}', ...) site "
                           f"exists in this module")


# ----------------------------------------------------------------------
# drivers


def scan_det_paths(paths: Sequence[str]) -> Tuple[DetModel,
                                                  Dict[str, str],
                                                  Dict[str, str]]:
    """(model, sources-by-rel, parse-errors-by-rel) for ``paths``."""
    model = DetModel()
    sources: Dict[str, str] = {}
    errors: Dict[str, str] = {}
    for path in iter_python_files(paths):
        rel = _rel_path(path)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            errors[rel] = f"cannot read: {e}"
            continue
        sources[rel] = source
        err = model.add_source(source, rel, path)
        if err:
            errors[rel] = err
    model.analyze()
    return model, sources, errors


def lint_det_paths(paths: Sequence[str],
                   check_suppressions: bool = False) -> LintReport:
    """Run the det tier; returns the same LintReport shape as the AST
    tier so report.render_human/render_json apply unchanged."""
    model, sources, errors = scan_det_paths(paths)
    files: List[FileReport] = []
    all_rels = sorted(set(sources) | set(errors))
    for rel in all_rels:
        if rel in errors:
            files.append(FileReport(
                rel, [Finding("parse-error", rel, 0, 0, 0, errors[rel])],
                []))
            continue
        pragmas = collect_pragmas(sources[rel])
        live: List[Finding] = []
        suppressed: List[Finding] = []
        for f in model.findings.get(rel, []):
            sup = pragmas.suppression_for(f.rule, f.line, f.end_line)
            if sup is not None:
                f.suppressed = True
                f.suppress_reason = sup.reason
                suppressed.append(f)
            else:
                live.append(f)
        live.sort(key=lambda f: (f.line, f.col, f.rule))
        suppressed.sort(key=lambda f: (f.line, f.col, f.rule))
        stale: List[Finding] = []
        if check_suppressions:
            for s in pragmas.suppressions:
                for rule in sorted(s.stale_rules()):
                    if not rule.startswith(DET_PREFIX):
                        continue  # other tiers judge their own pragmas
                    line = s.line or 1
                    reason = f" -- {s.reason}" if s.reason else ""
                    stale.append(Finding(
                        "stale-suppression", rel, line, 0, line,
                        f"suppression for '{rule}' no longer matches "
                        f"any det finding{reason}"))
        files.append(FileReport(rel, live, suppressed, stale=stale))
    return LintReport(files)


__all__ = ["DET_PREFIX", "DET_RULES", "DET_RULE_IDS", "DetModel",
           "DetRule", "lint_det_paths", "scan_det_paths"]
