"""conc tier — static lock/shared-state race analysis.

A pure-AST pass (never imports the scanned code) over the host-side
control plane:

1. **Discovery** — every ``threading.Lock/RLock/Condition`` (or
   ``utils.locks.make_lock/make_rlock``) creation site becomes a
   :class:`LockDef` with a dotted id computed from its location
   (``serve.queue.AdmissionQueue._lock``, ``tune.table._lock``).
2. **Guard inference** — for each class / module namespace, the
   attributes written under ``with <its lock>:`` form the lock's
   *guard set*.
3. **Rules** (pragma-suppressible like every other tier, docs/LINT.md):

   ==========================  ======================================
   conc-unguarded-write        an attribute with a guard set is also
                               mutated with no lock held
   conc-blocking-under-lock    a blocking call (sleep, device
                               dispatch/block_until_ready, file or
                               socket I/O, subprocess, futures wait)
                               made while any lock is held
   conc-lock-cycle             the global lock->lock acquisition
                               graph has a cycle, a self-reacquire of
                               a non-reentrant lock, or an edge that
                               inverts the declared lockmodel ranks
   conc-registry-gap           a lock missing from the lockmodel
                               registry, a declared-id drift, a raw
                               ``threading.*`` creation invisible to
                               the runtime validator, or a stale
                               registry entry
   ==========================  ======================================

Lock->lock edges come from lexical ``with`` nesting *plus* a
transitive call-graph fixpoint: calls are resolved through self,
module functions, import aliases, ``global_x().method()`` getter
chains and a unique-method-name fallback, so ``submit()`` holding the
admission lock and calling ``tel.counter`` (which takes the registry
lock) produces the edge even though the two ``with`` statements live
in different files.

The runtime half lives in utils/locks.py (``CEPH_TPU_LOCKCHECK=1``);
:func:`static_lock_graph` exports the edge set tier-1 cross-checks
the runtime report against.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .rules import Finding
from .scanner import FileReport, LintReport, _rel_path, iter_python_files
from .suppress import collect_pragmas

CONC_PREFIX = "conc-"
# the package whose dotted module names the ids are relative to, and
# the packages whose imports name its modules
PACKAGE = "ceph_tpu_torch"
IMPORT_PACKAGES = (PACKAGE,)


class ConcRule:
    """Descriptor-only rule record (the checks are whole-program, not
    per-file visitors, so there is no ``check(ctx)`` method)."""

    def __init__(self, id: str, category: str, description: str) -> None:
        self.id = id
        self.category = category
        self.description = description


CONC_RULES: Tuple[ConcRule, ...] = (
    ConcRule("conc-unguarded-write", "races",
             "an attribute written under `with <lock>:` elsewhere "
             "(its inferred guard) is mutated here with no lock held"),
    ConcRule("conc-blocking-under-lock", "latency",
             "blocking call (sleep, device dispatch, "
             "block_until_ready, file/socket I/O, subprocess, "
             "futures wait) while a lock is held"),
    ConcRule("conc-lock-cycle", "deadlock",
             "lock->lock acquisition edge closing a cycle, "
             "re-acquiring a held non-reentrant lock, or inverting "
             "the declared lockmodel rank order"),
    ConcRule("conc-registry-gap", "coverage",
             "lock not declared in analysis/lockmodel.py (or declared "
             "id drifted from the creation site, or created without "
             "utils.locks.make_lock so the runtime validator cannot "
             "see it, or a registry entry with no surviving lock)"),
)

CONC_RULE_IDS = frozenset(r.id for r in CONC_RULES)

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
_FACTORY_KINDS = {"make_lock": "lock", "make_rlock": "rlock"}

# methods where first-assignment is initialization, not mutation
_INIT_METHODS = {"__init__", "__post_init__", "__new__"}

# container-mutation method tails: `self.X.append(...)` mutates X
_MUTATOR_TAILS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "clear", "update", "setdefault",
}

# blocking-call classification (docs/LINT.md lists these verbatim)
_BLOCKING_TAILS = {
    "sleep": "sleep",
    "block_until_ready": "device sync",
    "device_put": "device transfer",
    "device_get": "device transfer",
    "wait": "wait",
    "result": "future result",
}
_BLOCKING_HEADS = {
    "socket": "socket I/O",
    "subprocess": "subprocess",
    "shutil": "file I/O",
}
_BLOCKING_OS_TAILS = {
    "replace", "rename", "remove", "fsync", "makedirs", "rmdir",
    "unlink",
}

# unique-method-name call resolution skips names every container or
# stdlib object answers to — resolving `d.get(...)` to some scanned
# class would fabricate edges
_HEURISTIC_BLACKLIST = {
    "get", "put", "set", "add", "pop", "append", "appendleft",
    "popleft", "clear", "update", "remove", "extend", "join", "copy",
    "close", "read", "write", "flush", "acquire", "release", "start",
    "items", "keys", "values", "sort", "split", "strip", "lower",
    "upper", "encode", "decode", "format", "count", "index", "insert",
    "reverse", "setdefault", "dump", "dumps", "load", "loads",
    "mkdir", "exists", "touch", "result", "wait", "cancel", "done",
    "discard", "render", "reset", "name", "next",
}


# ----------------------------------------------------------------------
# data model


@dataclasses.dataclass
class LockDef:
    id: str
    kind: str                 # "lock" | "rlock" | "condition"
    module: str
    owner: Optional[str]      # owning class, None for module locks
    attr: str
    path: str                 # rel path of the defining file
    line: int
    declared: Optional[str]   # make_lock("<literal>") argument, if any
    via_factory: bool


@dataclasses.dataclass
class LockEdge:
    src: str
    dst: str
    path: str
    line: int
    via: str                  # human chain, e.g. "submit -> tel.counter"


@dataclasses.dataclass
class _CallSite:
    held: Tuple[str, ...]
    spec: Tuple               # resolution spec, see _resolve_call
    line: int
    desc: str


@dataclasses.dataclass
class _ReadSite:
    scope: Tuple[str, Optional[str]]
    name: str
    held: Tuple[str, ...]
    line: int


@dataclasses.dataclass
class _WriteSite:
    scope: Tuple[str, Optional[str]]   # (module, class-or-None)
    name: str
    held: Tuple[str, ...]
    line: int
    col: int
    end_line: int
    func: str                 # qualname of the writing function
    how: str                  # "assign" | "augassign" | "subscript" | call tail


@dataclasses.dataclass
class _FuncInfo:
    key: Tuple[str, str]      # (module, qualname)
    cls: Optional[str]
    path: str
    direct_locks: Set[str] = dataclasses.field(default_factory=set)
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    calls: List[_CallSite] = dataclasses.field(default_factory=list)
    writes: List[_WriteSite] = dataclasses.field(default_factory=list)
    reads: List[_ReadSite] = dataclasses.field(default_factory=list)
    blocking: List[Tuple[int, int, int, str, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    local_funcs: Dict[str, str] = dataclasses.field(default_factory=dict)


def module_name_for(rel_path: str) -> str:
    """Dotted module name relative to the ceph_tpu_torch package root;
    files outside the package use their stem (fixtures, tools)."""
    parts = rel_path.replace(os.sep, "/").split("/")
    stem_parts = parts[:-1] + [parts[-1][:-3] if parts[-1].endswith(".py")
                               else parts[-1]]
    if PACKAGE in stem_parts:
        i = len(stem_parts) - 1 - stem_parts[::-1].index(PACKAGE)
        sub = stem_parts[i + 1:]
        if sub and sub[-1] == "__init__":
            sub = sub[:-1]
        if sub:
            return ".".join(sub)
        return "__init__"
    return stem_parts[-1]


def _dotted(node: ast.AST) -> Optional[str]:
    """a.b.c for pure Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_tail(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_lock_ctor(call: ast.Call) -> Optional[Tuple[str, Optional[str], bool]]:
    """(kind, declared_id, via_factory) when ``call`` creates a lock."""
    tail = _call_tail(call.func)
    if tail in _LOCK_CTORS:
        dotted = _dotted(call.func)
        if dotted and (dotted.startswith("threading.")
                       or dotted in _LOCK_CTORS):
            return _LOCK_CTORS[tail], None, False
        return None
    if tail in _FACTORY_KINDS:
        declared: Optional[str] = None
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            declared = call.args[0].value
        return _FACTORY_KINDS[tail], declared, True
    return None


# ----------------------------------------------------------------------
# per-module scan


class _ModuleScan:
    def __init__(self, path: str, rel: str, tree: ast.Module,
                 package_modules: Optional[Set[str]] = None) -> None:
        self.path = path
        self.rel = rel
        self.module = module_name_for(rel)
        self.tree = tree
        self.locks: List[LockDef] = []
        self.lock_by_scope: Dict[Tuple[Optional[str], str], LockDef] = {}
        self.funcs: Dict[str, _FuncInfo] = {}     # qualname -> info
        self.classes: Dict[str, Set[str]] = {}    # class -> method names
        self.module_globals: Set[str] = set()
        self.import_mods: Dict[str, str] = {}     # alias -> dotted module
        self.import_syms: Dict[str, Tuple[str, str]] = {}  # alias->(mod,sym)
        self._scan()

    # -- discovery -----------------------------------------------------

    def _norm_module(self, dotted: str) -> str:
        for pkg in IMPORT_PACKAGES:
            if dotted.startswith(pkg + "."):
                return dotted[len(pkg) + 1:]
        if dotted in IMPORT_PACKAGES:
            return "__init__"
        return dotted

    def _rel_import_base(self, level: int) -> List[str]:
        parts = self.module.split(".") if self.module else []
        # level 1 = current package: drop the module leaf
        keep = len(parts) - level
        return parts[:keep] if keep > 0 else []

    def _scan_imports(self, node: ast.AST) -> None:
        for stmt in ast.walk(node):
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    alias = a.asname or a.name.split(".")[0]
                    target = a.name if a.asname else a.name.split(".")[0]
                    self.import_mods[alias] = self._norm_module(target)
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level:
                    base = self._rel_import_base(stmt.level)
                    mod = ".".join(base + ([stmt.module]
                                           if stmt.module else []))
                else:
                    mod = self._norm_module(stmt.module or "")
                for a in stmt.names:
                    alias = a.asname or a.name
                    self.import_syms[alias] = (mod, a.name)

    def _add_lock(self, owner: Optional[str], attr: str, call: ast.Call,
                  info: Tuple[str, Optional[str], bool]) -> None:
        kind, declared, via_factory = info
        owner_part = f"{owner}." if owner else ""
        lock_id = f"{self.module}.{owner_part}{attr}"
        d = LockDef(lock_id, kind, self.module, owner, attr, self.rel,
                    call.lineno, declared, via_factory)
        self.locks.append(d)
        self.lock_by_scope[(owner, attr)] = d

    def _scan(self) -> None:
        self._scan_imports(self.tree)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                self.module_globals.add(name)
                if isinstance(stmt.value, ast.Call):
                    info = _is_lock_ctor(stmt.value)
                    if info:
                        self._add_lock(None, name, stmt.value, info)
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                self.module_globals.add(stmt.target.id)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register_func(stmt, None, stmt.name)
            elif isinstance(stmt, ast.ClassDef):
                self._scan_class(stmt)

    def _scan_class(self, cls: ast.ClassDef) -> None:
        methods: Set[str] = set()
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Call):
                info = _is_lock_ctor(stmt.value)
                if info:
                    self._add_lock(cls.name, stmt.targets[0].id,
                                   stmt.value, info)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods.add(stmt.name)
                self._register_func(stmt, cls.name,
                                    f"{cls.name}.{stmt.name}")
        self.classes[cls.name] = methods
        # instance locks: self._x = <ctor> anywhere in the class body
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Attribute) \
                        and isinstance(sub.targets[0].value, ast.Name) \
                        and sub.targets[0].value.id == "self" \
                        and isinstance(sub.value, ast.Call):
                    info = _is_lock_ctor(sub.value)
                    if info and (cls.name, sub.targets[0].attr) \
                            not in self.lock_by_scope:
                        self._add_lock(cls.name, sub.targets[0].attr,
                                       sub.value, info)

    def _register_func(self, node, cls: Optional[str],
                       qualname: str) -> None:
        self.funcs[qualname] = _FuncInfo((self.module, qualname), cls,
                                         self.rel)
        self._pending = getattr(self, "_pending", [])
        self._pending.append((node, qualname))

    # -- body analysis (second phase: locks are all known) -------------

    def analyze_bodies(self) -> None:
        for node, qualname in getattr(self, "_pending", []):
            info = self.funcs[qualname]
            self._walk_stmts(node.body, info, qualname, ())

    def _resolve_lock_expr(self, expr: ast.AST,
                           info: _FuncInfo) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if base in ("self", "cls") and info.cls:
                d = self.lock_by_scope.get((info.cls, attr))
                return d.id if d else None
            if base in self.classes:
                d = self.lock_by_scope.get((base, attr))
                return d.id if d else None
            return None
        if isinstance(expr, ast.Name):
            d = self.lock_by_scope.get((None, expr.id))
            return d.id if d else None
        return None

    def _global_write_name(self, target: ast.AST,
                           declared_globals: Set[str]) -> Optional[str]:
        if isinstance(target, ast.Name) and target.id in declared_globals:
            return target.id
        return None

    def _record_write(self, info: _FuncInfo, qualname: str,
                      scope: Tuple[str, Optional[str]], name: str,
                      node: ast.AST, held: Tuple[str, ...],
                      how: str) -> None:
        info.writes.append(_WriteSite(
            scope, name, held, node.lineno, node.col_offset,
            getattr(node, "end_lineno", node.lineno) or node.lineno,
            qualname, how))

    def _walk_stmts(self, stmts, info: _FuncInfo, qualname: str,
                    held: Tuple[str, ...],
                    declared_globals: Optional[Set[str]] = None) -> None:
        if declared_globals is None:
            declared_globals = set()
        for stmt in stmts:
            self._walk_stmt(stmt, info, qualname, held, declared_globals)

    def _walk_stmt(self, stmt, info: _FuncInfo, qualname: str,
                   held: Tuple[str, ...],
                   declared_globals: Set[str]) -> None:
        if isinstance(stmt, ast.Global):
            declared_globals.update(stmt.names)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs run later, not under the current locks
            inner_q = f"{qualname}.<locals>.{stmt.name}"
            self.funcs[inner_q] = _FuncInfo((self.module, inner_q),
                                            info.cls, self.rel)
            info.local_funcs[stmt.name] = inner_q
            self._walk_stmts(stmt.body, self.funcs[inner_q], inner_q, ())
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                self._scan_calls(item.context_expr, info, qualname,
                                 new_held)
                lock_id = self._resolve_lock_expr(item.context_expr,
                                                  info)
                if lock_id is not None:
                    info.direct_locks.add(lock_id)
                    info.acquires.append((lock_id,
                                          item.context_expr.lineno,
                                          new_held))
                    new_held = new_held + (lock_id,)
            self._walk_stmts(stmt.body, info, qualname, new_held,
                             declared_globals)
            return

        # writes (before generic call scanning so mutator calls get
        # classified once)
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            how = "augassign" if isinstance(stmt, ast.AugAssign) \
                else "assign"
            for t in targets:
                self._classify_write_target(t, info, qualname, held,
                                            declared_globals, how)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                       ast.Call):
            call = stmt.value
            tail = _call_tail(call.func)
            if tail in _MUTATOR_TAILS and \
                    isinstance(call.func, ast.Attribute):
                self._classify_write_target(call.func.value, info,
                                            qualname, held,
                                            declared_globals, tail,
                                            container=True)

        # generic: every call in this statement's expressions
        self._scan_calls(stmt, info, qualname, held, skip_with=True)

        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                self._walk_stmts(sub, info, qualname, held,
                                 declared_globals)
        for h in getattr(stmt, "handlers", []) or []:
            self._walk_stmts(h.body, info, qualname, held,
                             declared_globals)

    def _classify_write_target(self, t, info: _FuncInfo, qualname: str,
                               held: Tuple[str, ...],
                               declared_globals: Set[str], how: str,
                               container: bool = False) -> None:
        # unwrap subscript: self.X[k] = v mutates X
        if isinstance(t, ast.Subscript):
            how = "subscript"
            t = t.value
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self" \
                and info.cls:
            if (info.cls, t.attr) in self.lock_by_scope:
                return  # the lock itself
            self._record_write(info, qualname, (self.module, info.cls),
                               t.attr, t, held, how)
        elif isinstance(t, ast.Name):
            name = t.id
            is_global = name in declared_globals or \
                (container or how == "subscript") and \
                name in self.module_globals
            if is_global and (None, name) not in self.lock_by_scope:
                self._record_write(info, qualname, (self.module, None),
                                   name, t, held, how)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._classify_write_target(el, info, qualname, held,
                                            declared_globals, how)

    # -- call + blocking scan ------------------------------------------

    def _scan_calls(self, node: ast.AST, info: _FuncInfo, qualname: str,
                    held: Tuple[str, ...],
                    skip_with: bool = False) -> None:
        for sub in ast.walk(node) if not skip_with \
                else self._walk_shallow(node):
            if isinstance(sub, ast.Call):
                self._record_call(sub, info, qualname, held)
            elif held and isinstance(sub, ast.Attribute) \
                    and isinstance(sub.ctx, ast.Load) \
                    and isinstance(sub.value, ast.Name) \
                    and sub.value.id == "self" and info.cls \
                    and (info.cls, sub.attr) not in self.lock_by_scope:
                info.reads.append(_ReadSite(
                    (self.module, info.cls), sub.attr, held,
                    sub.lineno))
            elif held and isinstance(sub, ast.Name) \
                    and isinstance(sub.ctx, ast.Load) \
                    and sub.id in self.module_globals \
                    and (None, sub.id) not in self.lock_by_scope:
                info.reads.append(_ReadSite(
                    (self.module, None), sub.id, held, sub.lineno))

    def _walk_shallow(self, stmt: ast.AST) -> Iterable[ast.AST]:
        """The statement's own expressions only — nested statement
        bodies (with their own held state) are walked separately."""
        stack: List[ast.AST] = []
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.AST):
                stack.append(value)
            elif isinstance(value, list):
                stack.extend(v for v in value if isinstance(v, ast.AST))
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(n))

    def _record_call(self, call: ast.Call, info: _FuncInfo,
                     qualname: str, held: Tuple[str, ...]) -> None:
        func = call.func
        desc = _dotted(func) or _call_tail(func) or "<call>"
        blk = self._blocking_reason(call)
        if blk:
            # recorded even when no lock is lexically held: a private
            # helper that blocks is a finding when every one of its
            # call sites holds a lock (entry-held, resolved by
            # ConcModel._check_blocking)
            info.blocking.append((call.lineno, call.col_offset,
                                  getattr(call, "end_lineno",
                                          call.lineno)
                                  or call.lineno,
                                  f"{desc} ({blk})", held))
        spec = self._call_spec(func)
        if spec is not None:
            info.calls.append(_CallSite(held, spec, call.lineno, desc))

    def _blocking_reason(self, call: ast.Call) -> Optional[str]:
        func = call.func
        tail = _call_tail(func)
        dotted = _dotted(func)
        if isinstance(func, ast.Name) and func.id == "open":
            return "file I/O"
        if tail in _BLOCKING_TAILS:
            return _BLOCKING_TAILS[tail]
        if tail == "join" and not call.args and not call.keywords:
            return "thread join"
        if dotted:
            head = dotted.split(".")[0]
            if head in _BLOCKING_HEADS:
                return _BLOCKING_HEADS[head]
            if head == "os" and tail in _BLOCKING_OS_TAILS:
                return "file I/O"
        return None

    def _call_spec(self, func: ast.AST) -> Optional[Tuple]:
        """An unresolved callee spec; resolved globally by ConcModel."""
        if isinstance(func, ast.Name):
            return ("name", func.id)
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        base = func.value
        if isinstance(base, ast.Name):
            if base.id in ("self", "cls"):
                return ("self", meth)
            return ("attr", base.id, meth)
        if isinstance(base, ast.Call):
            inner = self._call_spec(base.func)
            if inner is not None:
                return ("getter", inner, meth)
        return ("method", meth)


# ----------------------------------------------------------------------
# whole-program model


class ConcModel:
    def __init__(self, registry_ranks: Optional[Dict[str, int]] = None,
                 registry_specs=None) -> None:
        if registry_ranks is None or registry_specs is None:
            from . import lockmodel
            if registry_ranks is None:
                registry_ranks = lockmodel.all_ranks()
            if registry_specs is None:
                registry_specs = list(lockmodel.LOCKS)
        self.ranks = dict(registry_ranks)
        self.registry_specs = list(registry_specs)
        self.scans: List[_ModuleScan] = []
        self.locks: Dict[str, LockDef] = {}
        self.edges: List[LockEdge] = []
        self.findings: Dict[str, List[Finding]] = {}
        self._funcs: Dict[Tuple[str, str], _FuncInfo] = {}
        self._scan_by_module: Dict[str, _ModuleScan] = {}

    # -- assembly ------------------------------------------------------

    def add_source(self, source: str, rel: str,
                   path: Optional[str] = None) -> Optional[str]:
        """Parse + scan one file; returns a parse error or None."""
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            return f"syntax error: {e.msg} (line {e.lineno})"
        scan = _ModuleScan(path or rel, rel, tree)
        self.scans.append(scan)
        return None

    def _emit(self, rel: str, rule: str, line: int, col: int,
              end_line: int, message: str) -> None:
        self.findings.setdefault(rel, []).append(
            Finding(rule, rel, line, col, end_line, message))

    def analyze(self) -> None:
        for scan in self.scans:
            scan.analyze_bodies()
            self._scan_by_module[scan.module] = scan
            for d in scan.locks:
                self.locks[d.id] = d
            for q, fi in scan.funcs.items():
                self._funcs[(scan.module, q)] = fi
        self._check_registry()
        self._compute_edges()
        self._check_unguarded_writes()
        self._check_blocking()
        self._check_cycles()

    # -- conc-registry-gap ---------------------------------------------

    def _check_registry(self) -> None:
        for d in self.locks.values():
            if d.id not in self.ranks:
                self._emit(d.path, "conc-registry-gap", d.line, 0,
                           d.line,
                           f"lock '{d.id}' is not declared in "
                           f"analysis/lockmodel.py — add a LockSpec "
                           f"with its rank")
            if not d.via_factory:
                self._emit(d.path, "conc-registry-gap", d.line, 0,
                           d.line,
                           f"lock '{d.id}' created with raw "
                           f"threading.{d.kind.capitalize() if d.kind != 'rlock' else 'RLock'}()"
                           f" — use utils.locks.make_lock/make_rlock "
                           f"so CEPH_TPU_LOCKCHECK can instrument it")
            elif d.declared is None:
                self._emit(d.path, "conc-registry-gap", d.line, 0,
                           d.line,
                           f"lock '{d.id}': make_lock argument must "
                           f"be a string literal (the declared id)")
            elif d.declared != d.id:
                self._emit(d.path, "conc-registry-gap", d.line, 0,
                           d.line,
                           f"declared id '{d.declared}' does not "
                           f"match the creation site '{d.id}'")
        scanned_modules = set(self._scan_by_module)
        for spec in self.registry_specs:
            if spec.module in scanned_modules and \
                    spec.id not in self.locks:
                scan = self._scan_by_module[spec.module]
                self._emit(scan.rel, "conc-registry-gap", 1, 0, 1,
                           f"stale lockmodel entry: '{spec.id}' is "
                           f"registered but no lock with that id "
                           f"exists in this module")

    # -- conc-unguarded-write ------------------------------------------

    def _scope_locks(self, scope: Tuple[str, Optional[str]]) -> Set[str]:
        module, cls = scope
        scan = self._scan_by_module.get(module)
        if scan is None:
            return set()
        out = set()
        for d in scan.locks:
            if cls is not None and d.owner == cls:
                out.add(d.id)
            elif cls is None and d.owner is None:
                out.add(d.id)
        return out

    def _effective_held(self, fi: _FuncInfo,
                        held: Tuple[str, ...]) -> Set[str]:
        """Held locks at a site, plus locks held at EVERY resolved
        call site of this function when it is a private helper (the
        ``_stat``-called-only-under-``_mu`` pattern)."""
        out = set(held)
        leaf = fi.key[1].split(".")[-1]
        if leaf.startswith("_") and not leaf.startswith("__"):
            out |= self._entry_held.get(fi.key, set())
        return out

    def _check_unguarded_writes(self) -> None:
        by_var: Dict[Tuple[Tuple[str, Optional[str]], str],
                     List[Tuple[_WriteSite, _FuncInfo]]] = {}
        reads_by_var: Dict[Tuple[Tuple[str, Optional[str]], str],
                           List[Tuple[_ReadSite, _FuncInfo]]] = {}
        for fi in self._funcs.values():
            for w in fi.writes:
                by_var.setdefault((w.scope, w.name), []).append((w, fi))
            for r in fi.reads:
                reads_by_var.setdefault((r.scope, r.name), []).append(
                    (r, fi))
        for (scope, name), sites in by_var.items():
            guards = self._scope_locks(scope)
            if not guards:
                continue
            gw = [w for w, fi in sites
                  if self._effective_held(fi, w.held) & guards]
            gr = [r for r, fi in reads_by_var.get((scope, name), [])
                  if self._effective_held(fi, r.held) & guards]
            if not gw and not gr:
                continue
            guard_ids = sorted(
                set(g for s in gw + gr for g in s.held if g in guards)
                or guards)
            example = min(s.line for s in gw + gr)
            evidence = "written" if gw else "read"
            owner = scope[1] or "module"
            for w, fi in sites:
                if self._effective_held(fi, w.held) & guards:
                    continue
                if scope[1] is not None and \
                        w.func.split(".")[-1] in _INIT_METHODS:
                    continue
                self._emit(
                    fi.path, "conc-unguarded-write", w.line, w.col,
                    w.end_line,
                    f"{owner} attribute '{name}' is {evidence} under "
                    f"{'/'.join(guard_ids)} elsewhere (e.g. line "
                    f"{example}) but mutated here ({w.how}) with no "
                    f"lock held")

    # -- conc-blocking-under-lock --------------------------------------

    def _check_blocking(self) -> None:
        for fi in self._funcs.values():
            for line, col, end_line, desc, held in fi.blocking:
                eff = held or tuple(sorted(
                    self._effective_held(fi, held)))
                if not eff:
                    continue
                via = "" if held else " (held at every call site)"
                self._emit(fi.path, "conc-blocking-under-lock", line,
                           col, end_line,
                           f"blocking call {desc} while holding "
                           f"{'/'.join(eff)}{via}")

    # -- edges + conc-lock-cycle ---------------------------------------

    def _resolve_call(self, caller: _FuncInfo,
                      spec: Tuple) -> Optional[_FuncInfo]:
        module = caller.key[0]
        scan = self._scan_by_module.get(module)
        kind = spec[0]
        if kind == "self":
            meth = spec[1]
            if caller.cls:
                fi = self._funcs.get((module, f"{caller.cls}.{meth}"))
                if fi:
                    return fi
            return self._unique_method(meth)
        if kind == "name":
            name = spec[1]
            if name in caller.local_funcs:
                return self._funcs.get((module, caller.local_funcs[name]))
            fi = self._funcs.get((module, name))
            if fi:
                return fi
            if scan and name in scan.classes:
                return self._funcs.get((module, f"{name}.__init__"))
            if scan and name in scan.import_syms:
                smod, sym = scan.import_syms[name]
                fi = self._funcs.get((smod, sym))
                if fi:
                    return fi
                tscan = self._scan_by_module.get(smod)
                if tscan and sym in tscan.classes:
                    return self._funcs.get((smod, f"{sym}.__init__"))
            return None
        if kind == "attr":
            base, meth = spec[1], spec[2]
            if scan and base in scan.classes:
                return self._funcs.get((module, f"{base}.{meth}"))
            target_mod = None
            if scan and base in scan.import_mods:
                target_mod = scan.import_mods[base]
            elif scan and base in scan.import_syms:
                smod, sym = scan.import_syms[base]
                cand = f"{smod}.{sym}" if smod else sym
                if cand in self._scan_by_module:
                    target_mod = cand
                else:
                    tscan = self._scan_by_module.get(smod)
                    if tscan and sym in tscan.classes:
                        return self._funcs.get((smod, f"{sym}.{meth}"))
            if target_mod is not None:
                return self._funcs.get((target_mod, meth))
            return self._unique_method(meth)
        if kind == "getter":
            inner = self._resolve_call(caller, spec[1])
            meth = spec[2]
            if inner is not None:
                tmod = inner.key[0]
                tscan = self._scan_by_module.get(tmod)
                if tscan:
                    cands = [c for c, ms in tscan.classes.items()
                             if meth in ms]
                    if len(cands) == 1:
                        return self._funcs.get(
                            (tmod, f"{cands[0]}.{meth}"))
            return self._unique_method(meth)
        if kind == "method":
            return self._unique_method(spec[1])
        return None

    def _unique_method(self, meth: str) -> Optional[_FuncInfo]:
        if meth in _HEURISTIC_BLACKLIST:
            return None
        cands = []
        for scan in self.scans:
            for cls, methods in scan.classes.items():
                if meth in methods:
                    cands.append((scan.module, f"{cls}.{meth}"))
        if len(cands) == 1:
            return self._funcs.get(cands[0])
        return None

    def _compute_edges(self) -> None:
        # resolve call sites once
        resolved: Dict[int, List[Tuple[_CallSite, _FuncInfo]]] = {}
        callees: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for key, fi in self._funcs.items():
            lst = []
            for cs in fi.calls:
                target = self._resolve_call(fi, cs.spec)
                if target is not None and target.key != key:
                    lst.append((cs, target))
                    callees.setdefault(key, set()).add(target.key)
            resolved[id(fi)] = lst
        # transitive lock sets (fixpoint over the call graph)
        trans: Dict[Tuple[str, str], Set[str]] = {
            k: set(fi.direct_locks) for k, fi in self._funcs.items()}
        changed = True
        while changed:
            changed = False
            for key in self._funcs:
                acc = trans[key]
                before = len(acc)
                for callee in callees.get(key, ()):
                    acc |= trans.get(callee, set())
                if len(acc) != before:
                    changed = True
        self._trans = trans
        # entry-held: locks held at EVERY resolved call site of a
        # function (fixpoint so helper->helper chains propagate);
        # consumed by the unguarded-write check for private helpers
        self._entry_held: Dict[Tuple[str, str], Set[str]] = {}
        for _ in range(4):
            nxt: Dict[Tuple[str, str], Optional[Set[str]]] = {}
            for key, fi in self._funcs.items():
                # a caller's own entry-held only propagates when it is
                # itself private (public surfaces can be entered
                # lock-free by anyone)
                leaf = key[1].split(".")[-1]
                inherited = self._entry_held.get(key, set()) \
                    if leaf.startswith("_") and not leaf.startswith("__") \
                    else set()
                for cs, target in resolved[id(fi)]:
                    eff = set(cs.held) | inherited
                    cur = nxt.get(target.key)
                    nxt[target.key] = eff if cur is None else cur & eff
            new = {k: v for k, v in nxt.items() if v}
            if new == self._entry_held:
                break
            self._entry_held = new
        # edges: lexical nesting + held-across-call
        seen: Set[Tuple[str, str]] = set()

        def emit_edge(src: str, dst: str, path: str, line: int,
                      via: str) -> None:
            self.edges.append(LockEdge(src, dst, path, line, via))
            seen.add((src, dst))

        for key, fi in self._funcs.items():
            for lock_id, line, held in fi.acquires:
                for h in held:
                    if (h, lock_id) not in seen:
                        emit_edge(h, lock_id, fi.path, line,
                                  f"{key[1]} (with-nesting)")
            for cs, target in resolved[id(fi)]:
                if not cs.held:
                    continue
                for dst in sorted(trans.get(target.key, set())):
                    for h in cs.held:
                        if (h, dst) not in seen:
                            emit_edge(h, dst, fi.path, cs.line,
                                      f"{key[1]} -> {cs.desc}")

    def _check_cycles(self) -> None:
        # self-reacquire of a non-reentrant lock
        graph: Dict[str, Set[str]] = {}
        for e in self.edges:
            if e.src == e.dst:
                d = self.locks.get(e.src)
                if d is None or d.kind != "rlock":
                    self._emit(e.path, "conc-lock-cycle", e.line, 0,
                               e.line,
                               f"'{e.src}' re-acquired while already "
                               f"held (via {e.via}) — self-deadlock "
                               f"for a non-reentrant lock")
                continue
            graph.setdefault(e.src, set()).add(e.dst)
        # declared-rank inversions
        for e in self.edges:
            if e.src == e.dst:
                continue
            rs, rd = self.ranks.get(e.src), self.ranks.get(e.dst)
            if rs is not None and rd is not None and rd <= rs:
                self._emit(e.path, "conc-lock-cycle", e.line, 0, e.line,
                           f"edge '{e.src}' (rank {rs}) -> '{e.dst}' "
                           f"(rank {rd}) inverts the declared lock "
                           f"order (via {e.via})")
        # strongly connected components over distinct locks
        sccs = _tarjan(graph)
        cyclic = {n for comp in sccs if len(comp) > 1 for n in comp}
        if not cyclic:
            return
        done: Set[Tuple[str, str]] = set()
        for e in self.edges:
            if e.src in cyclic and e.dst in cyclic and e.src != e.dst \
                    and (e.src, e.dst) not in done:
                done.add((e.src, e.dst))
                comp = next(sorted(c) for c in sccs if e.src in c)
                self._emit(e.path, "conc-lock-cycle", e.line, 0, e.line,
                           f"edge '{e.src}' -> '{e.dst}' (via {e.via}) "
                           f"is part of a lock-graph cycle: "
                           f"{' <-> '.join(comp)}")


def _tarjan(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (the graph is tiny; recursion would be
    fine too, but iterative avoids any depth concern)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = set(graph) | {d for ds in graph.values() for d in ds}

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)
    return sccs


# ----------------------------------------------------------------------
# drivers


def scan_paths(paths: Sequence[str],
               registry_ranks: Optional[Dict[str, int]] = None,
               registry_specs=None) -> Tuple[ConcModel,
                                             Dict[str, str],
                                             Dict[str, str]]:
    """(model, sources-by-rel, parse-errors-by-rel) for ``paths``."""
    model = ConcModel(registry_ranks, registry_specs)
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


def lint_conc_paths(paths: Sequence[str],
                    registry_ranks: Optional[Dict[str, int]] = None,
                    registry_specs=None,
                    check_suppressions: bool = False) -> LintReport:
    """Run the conc tier; returns the same LintReport shape as the
    AST tier so report.render_human/render_json apply unchanged."""
    model, sources, errors = scan_paths(paths, registry_ranks,
                                        registry_specs)
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
                    if not rule.startswith(CONC_PREFIX):
                        continue  # other tiers judge their own pragmas
                    line = s.line or 1
                    reason = f" -- {s.reason}" if s.reason else ""
                    stale.append(Finding(
                        "stale-suppression", rel, line, 0, line,
                        f"suppression for '{rule}' no longer matches "
                        f"any conc finding{reason}"))
        files.append(FileReport(rel, live, suppressed, stale=stale))
    return LintReport(files)


def static_lock_graph(paths: Sequence[str]) -> Dict[str, object]:
    """The static model the runtime validator is cross-checked
    against: declared locks and the full lock->lock edge set."""
    model, _, _ = scan_paths(paths)
    return {
        "locks": {d.id: d.kind for d in model.locks.values()},
        "edges": sorted({(e.src, e.dst) for e in model.edges}),
        "ranks": dict(model.ranks),
    }


__all__ = ["CONC_RULES", "CONC_RULE_IDS", "ConcModel", "ConcRule",
           "LockDef", "LockEdge", "lint_conc_paths", "module_name_for",
           "scan_paths", "static_lock_graph"]
