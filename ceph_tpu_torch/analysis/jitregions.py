"""Jit-region inference: which functions trace on device, and which of
their names hold traced values.

A *region* is a function whose body executes under jax tracing — where
host syncs stall the pipeline, impure calls bake into the program, and
Python control flow on traced values either crashes (TracerBoolError)
or silently recompiles.  Regions are found from:

- decorators: ``@jax.jit``, ``@jit``, ``@pjit``,
  ``@functools.partial(jax.jit, ...)``;
- call sites: a local function (or lambda) passed into ``jax.jit`` /
  ``pjit`` / ``shard_map`` / ``pl.pallas_call`` — including through
  nested transforms like ``jax.jit(jax.vmap(fn, ...))``;
- the ``# tpu-lint: jit-function`` pragma, for factory closures whose
  jit wrapping happens in a different module;
- propagation: a function *called from* a region body with traced
  arguments is itself device code (per-call-site taint, so a helper
  taking only static config stays host-checkable);
- nesting: defs inside a region trace with it (lax.scan/while bodies).

Taint is a per-function fixpoint over assignments.  Shape/dtype reads
(``x.shape``, ``x.dtype``, ``x.ndim``, ``len(x)``, ``jnp.shape(x)``)
and ``is``/``is not`` tests launder taint — they are static under
tracing, so branching on them is legitimate trace-time control flow.
Params named by ``static_argnums``/``static_argnames`` start untainted.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# attribute reads that are static under tracing
STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
# calls that return static (non-traced) values
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr"}
STATIC_ATTR_CALLS = {("jnp", "shape"), ("np", "shape"), ("jnp", "ndim"),
                     ("jax", "eval_shape")}

JIT_NAMES = {"jit", "pjit"}
SHARD_NAMES = {"shard_map"}
PALLAS_NAMES = {"pallas_call"}


def _tail_name(node: ast.AST) -> Optional[str]:
    """'jax.jit' -> 'jit'; 'jit' -> 'jit'; anything else -> None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_pair(node: ast.AST) -> Optional[Tuple[str, str]]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)):
        return (node.value.id, node.attr)
    return None


def _param_names(fn: FunctionNode) -> List[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _static_param_names(fn: FunctionNode, argnums, argnames) -> Set[str]:
    params = _param_names(fn)
    out: Set[str] = set(argnames or ())
    for i in argnums or ():
        if isinstance(i, int) and 0 <= i < len(params):
            out.add(params[i])
    return out


def _const_int_seq(node: Optional[ast.AST]):
    """Evaluate a static_argnums value: int or tuple/list of ints."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, int)):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


def _const_str_seq(node: Optional[ast.AST]):
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


@dataclasses.dataclass
class DeviceFn:
    node: FunctionNode
    kind: str                 # jit | pallas | shard_map | marker | called | nested
    name: str
    static_params: Set[str]
    tainted_params: Set[str]
    taint: Set[str] = dataclasses.field(default_factory=set)
    # names of enclosing-scope variables assigned more than once there
    # (consumed by the jit-closure rule)
    mutable_captures: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class JitSiteInfo:
    """A jit wrapping whose static positions are known — drives the
    static-args call-site check."""
    fn_name: str
    static_positions: Tuple[int, ...]
    static_names: Tuple[str, ...]


def walk_region(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a region body without descending into nested function
    bodies (nested defs are their own regions)."""
    root = node
    stack: List[ast.AST] = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if (n is not root
                    and isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef, ast.Lambda))):
                continue
            stack.append(child)
        # note: the guard above keeps children of a nested def out while
        # still yielding the def node itself (its decorators/signature
        # belong to the enclosing region's trace)


class _ScopeIndex(ast.NodeVisitor):
    """name -> FunctionDef per lexical scope, with parent links."""

    def __init__(self) -> None:
        self.defs: Dict[int, Dict[str, FunctionNode]] = {}
        self.parent_scope: Dict[int, Optional[ast.AST]] = {}
        self.enclosing: Dict[int, ast.AST] = {}   # fn node -> scope node
        self._stack: List[ast.AST] = []

    def index(self, tree: ast.Module):
        self.defs[id(tree)] = {}
        self.parent_scope[id(tree)] = None
        self._stack = [tree]
        self.generic_visit(tree)

    def _visit_fn(self, node):
        scope = self._stack[-1]
        if not isinstance(node, ast.Lambda):
            self.defs[id(scope)][node.name] = node
        self.enclosing[id(node)] = scope
        self.defs.setdefault(id(node), {})
        self.parent_scope[id(node)] = scope
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn
    visit_Lambda = _visit_fn

    def resolve(self, scope: ast.AST, name: str) -> Optional[FunctionNode]:
        node: Optional[ast.AST] = scope
        while node is not None:
            fn = self.defs.get(id(node), {}).get(name)
            if fn is not None:
                return fn
            node = self.parent_scope.get(id(node))
        return None


class RegionAnalyzer:
    """Find device regions + per-region taint for one module."""

    def __init__(self, tree: ast.Module,
                 jit_function_lines: Optional[Set[int]] = None) -> None:
        self.tree = tree
        self.jit_function_lines = jit_function_lines or set()
        self.scopes = _ScopeIndex()
        self.scopes.index(tree)
        self.regions: Dict[int, DeviceFn] = {}
        self.jit_sites: List[JitSiteInfo] = []
        self._analyze()

    # ------------------------------------------------------------------
    def _analyze(self) -> None:
        self._find_decorated()
        self._find_call_wrapped()
        self._find_marked()
        self._propagate()

    def _add(self, node: FunctionNode, kind: str,
             static_params: Set[str],
             tainted_params: Optional[Set[str]] = None) -> DeviceFn:
        existing = self.regions.get(id(node))
        if existing is not None:
            existing.static_params |= static_params
            if tainted_params:
                existing.tainted_params |= tainted_params
            return existing
        if tainted_params is None:
            tainted_params = set(_param_names(node)) - static_params
        name = getattr(node, "name", "<lambda>")
        dfn = DeviceFn(node, kind, name, static_params,
                       set(tainted_params))
        self.regions[id(node)] = dfn
        return dfn

    def _jit_static_info(self, call: ast.Call):
        argnums = argnames = None
        for kw in call.keywords:
            if kw.arg == "static_argnums":
                argnums = _const_int_seq(kw.value)
            elif kw.arg == "static_argnames":
                argnames = _const_str_seq(kw.value)
        return argnums, argnames

    def _find_decorated(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                kind = None
                argnums = argnames = None
                tail = _tail_name(dec)
                if tail in JIT_NAMES:
                    kind = "jit"
                elif tail in SHARD_NAMES:
                    kind = "shard_map"
                elif isinstance(dec, ast.Call):
                    ctail = _tail_name(dec.func)
                    if ctail in JIT_NAMES:
                        kind = "jit"
                        argnums, argnames = self._jit_static_info(dec)
                    elif ctail in SHARD_NAMES:
                        kind = "shard_map"
                    elif ctail == "partial" and dec.args:
                        itail = _tail_name(dec.args[0])
                        if itail in JIT_NAMES:
                            kind = "jit"
                            argnums, argnames = self._jit_static_info(dec)
                        elif itail in SHARD_NAMES:
                            kind = "shard_map"
                if kind is None:
                    continue
                static = _static_param_names(node, argnums, argnames)
                self._add(node, kind, static)
                if kind == "jit":
                    params = _param_names(node)
                    pos = tuple(i for i in (argnums or ())
                                if isinstance(i, int))
                    nm = tuple(argnames or ())
                    pos = pos + tuple(params.index(n) for n in nm
                                      if n in params)
                    if pos:
                        self.jit_sites.append(
                            JitSiteInfo(node.name, tuple(sorted(set(pos))),
                                        nm))
                break

    def _wrapped_targets(self, call: ast.Call) -> List[FunctionNode]:
        """Resolve fn references inside jit(...) / pallas_call(...),
        looking through nested transform calls (vmap etc.)."""
        out: List[FunctionNode] = []
        scope = self._scope_of(call)

        def visit(arg: ast.AST, depth: int) -> None:
            if depth > 4:
                return
            if isinstance(arg, ast.Lambda):
                out.append(arg)
            elif isinstance(arg, ast.Name):
                fn = self.scopes.resolve(scope, arg.id)
                if fn is not None:
                    out.append(fn)
            elif isinstance(arg, ast.Call):
                for a in arg.args:
                    visit(a, depth + 1)

        for a in call.args[:1]:
            visit(a, 0)
        return out

    def _scope_of(self, node: ast.AST) -> ast.AST:
        # nearest enclosing function def, else module
        return self._node_scope.get(id(node), self.tree)

    def _build_node_scopes(self) -> None:
        self._node_scope: Dict[int, ast.AST] = {}

        def assign(owner: ast.AST, n: ast.AST) -> None:
            self._node_scope[id(n)] = owner
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    assign(child, child)
                else:
                    assign(owner, child)

        assign(self.tree, self.tree)

    def _find_call_wrapped(self) -> None:
        self._build_node_scopes()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail_name(node.func)
            if tail in JIT_NAMES or tail in SHARD_NAMES:
                kind = "jit" if tail in JIT_NAMES else "shard_map"
                argnums, argnames = self._jit_static_info(node)
                for fn in self._wrapped_targets(node):
                    static = _static_param_names(fn, argnums, argnames)
                    self._add(fn, kind, static)
            elif tail in PALLAS_NAMES:
                for fn in self._wrapped_targets(node):
                    self._add(fn, "pallas", set(),
                              set(_param_names(fn)))

    def _find_marked(self) -> None:
        if not self.jit_function_lines:
            return
        for node in ast.walk(self.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.lineno in self.jit_function_lines):
                self._add(node, "marker", set())

    # ------------------------------------------------------------------
    def _propagate(self) -> None:
        """Taint fixpoints + interprocedural / nested-def closure."""
        work = list(self.regions.values())
        rounds = 0
        while work and rounds < 40:
            rounds += 1
            dfn = work.pop()
            dfn.taint = compute_taint(dfn.node, dfn.tainted_params
                                      | dfn.taint)
            scope = dfn.node
            # nested defs trace with the region: every param traced
            # (lax.scan/while_loop/cond bodies, local helpers)
            for child in ast.walk(dfn.node):
                if child is dfn.node or not isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                    continue
                if self.scopes.parent_scope.get(id(child)) is not dfn.node:
                    continue
                sub = self.regions.get(id(child))
                params = set(_param_names(child))
                if sub is None:
                    sub = self._add(child, "nested", set(), params)
                    work.append(sub)
            # calls with traced args mark the callee as device code
            for n in walk_region(dfn.node):
                if not isinstance(n, ast.Call):
                    continue
                if not isinstance(n.func, ast.Name):
                    continue
                target = self.scopes.resolve(scope, n.func.id)
                if target is None or id(target) == id(dfn.node):
                    continue
                tainted_args = self._callsite_taint(n, target, dfn.taint)
                if not tainted_args:
                    continue
                sub = self.regions.get(id(target))
                if sub is None:
                    sub = self._add(target, "called", set(), tainted_args)
                    work.append(sub)
                elif not tainted_args <= sub.tainted_params:
                    sub.tainted_params |= tainted_args
                    work.append(sub)

    def _callsite_taint(self, call: ast.Call, target: FunctionNode,
                        taint: Set[str]) -> Set[str]:
        params = _param_names(target)
        out: Set[str] = set()
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                break
            if i < len(params) and expr_tainted(a, taint):
                out.add(params[i])
        for kw in call.keywords:
            if kw.arg and kw.arg in params and expr_tainted(kw.value,
                                                            taint):
                out.add(kw.arg)
        return out


# ----------------------------------------------------------------------
def expr_tainted(node: ast.AST, taint: Set[str]) -> bool:
    """Does this expression (possibly) hold a traced value?"""
    if isinstance(node, ast.Name):
        return node.id in taint
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return False
        return expr_tainted(node.value, taint)
    if isinstance(node, ast.Subscript):
        return (expr_tainted(node.value, taint)
                or expr_tainted(node.slice, taint))
    if isinstance(node, ast.Call):
        tail = _tail_name(node.func)
        if (isinstance(node.func, ast.Name) and tail in STATIC_CALLS):
            return False
        if _attr_pair(node.func) in STATIC_ATTR_CALLS:
            return False
        if expr_tainted(node.func, taint):
            return True
        return (any(expr_tainted(a, taint) for a in node.args)
                or any(expr_tainted(k.value, taint)
                       for k in node.keywords))
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return (expr_tainted(node.left, taint)
                or any(expr_tainted(c, taint) for c in node.comparators))
    if isinstance(node, ast.BoolOp):
        return any(expr_tainted(v, taint) for v in node.values)
    if isinstance(node, ast.BinOp):
        return (expr_tainted(node.left, taint)
                or expr_tainted(node.right, taint))
    if isinstance(node, ast.UnaryOp):
        return expr_tainted(node.operand, taint)
    if isinstance(node, ast.IfExp):
        return (expr_tainted(node.test, taint)
                or expr_tainted(node.body, taint)
                or expr_tainted(node.orelse, taint))
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(expr_tainted(e, taint) for e in node.elts)
    if isinstance(node, ast.Dict):
        return (any(e is not None and expr_tainted(e, taint)
                    for e in node.keys)
                or any(expr_tainted(v, taint) for v in node.values))
    if isinstance(node, ast.Starred):
        return expr_tainted(node.value, taint)
    if isinstance(node, ast.NamedExpr):
        return expr_tainted(node.value, taint)
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return (expr_tainted(node.elt, taint)
                or any(expr_tainted(g.iter, taint)
                       for g in node.generators))
    if isinstance(node, ast.DictComp):
        return (expr_tainted(node.key, taint)
                or expr_tainted(node.value, taint)
                or any(expr_tainted(g.iter, taint)
                       for g in node.generators))
    if isinstance(node, ast.Slice):
        return any(expr_tainted(e, taint)
                   for e in (node.lower, node.upper, node.step)
                   if e is not None)
    return False


def _target_names(node: ast.AST) -> Iterator[str]:
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _target_names(e)
    elif isinstance(node, ast.Starred):
        yield from _target_names(node.value)


def compute_taint(fn: FunctionNode, seed: Set[str]) -> Set[str]:
    """Fixpoint taint over the function body (nested defs excluded —
    they get their own region entries)."""
    taint = set(seed)
    for _ in range(10):
        changed = False
        for node in walk_region(fn):
            new: List[str] = []
            if isinstance(node, ast.Assign):
                if expr_tainted(node.value, taint):
                    for t in node.targets:
                        new.extend(_target_names(t))
            elif isinstance(node, ast.AugAssign):
                if expr_tainted(node.value, taint):
                    new.extend(_target_names(node.target))
            elif isinstance(node, ast.AnnAssign):
                if node.value is not None and expr_tainted(node.value,
                                                           taint):
                    new.extend(_target_names(node.target))
            elif isinstance(node, ast.NamedExpr):
                if expr_tainted(node.value, taint):
                    new.extend(_target_names(node.target))
            elif isinstance(node, ast.For):
                if expr_tainted(node.iter, taint):
                    new.extend(_target_names(node.target))
            elif isinstance(node, ast.withitem):
                if node.optional_vars is not None and expr_tainted(
                        node.context_expr, taint):
                    new.extend(_target_names(node.optional_vars))
            for name in new:
                if name not in taint:
                    taint.add(name)
                    changed = True
        if not changed:
            break
    return taint
