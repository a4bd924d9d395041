"""The rule battery.

Five invariant families, seven rule ids:

==================  ===================================================
rule id             invariant
==================  ===================================================
gf-float            GF symbol paths stay integer (no float literals,
                    float astype/dtype, or true division)
gf-python-op        no Python ``*``/``%``/``**`` on GF table values
host-sync           no np.*/.item()/int()/float() on traced values
                    inside a jit region
tracer-branch       no Python if/while on traced values in a region
static-args         hashable static_argnums payloads only
jit-closure         jitted closures must not capture mutable state
impure-jit          no RNG/clock/I-O/global mutation inside a region
==================  ===================================================

Every rule emits :class:`Finding` records; the scanner matches them
against ``# tpu-lint: disable=`` pragmas.  Rules receive a
:class:`LintContext` giving them the AST, the device regions with
taint, and the GF scope decision for the file.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .jitregions import (DeviceFn, RegionAnalyzer, _attr_pair, _tail_name,
                         expr_tainted, walk_region)

FLOAT_DTYPE_NAMES = {
    "float", "float16", "float32", "float64", "bfloat16", "double",
    "half", "single", "float_", "longdouble",
}

NP_ALIASES = {"np", "numpy"}
JNP_ALIASES = {"jnp"}
JAX_ALIASES = {"jax"}

# np calls that force a device->host transfer when fed a traced value
HOST_SYNC_NP = {
    "asarray", "array", "ascontiguousarray", "copy", "save", "frombuffer",
}
# log-domain wraparound (% 255) and GF(2) reduction (% 2) are table
# idioms, not integer-math mistakes
GF_MOD_OK = {255, 2}

PURITY_BAD_MODULES = {"time", "random", "os", "io", "sys"}
PURITY_BAD_CALLS = {"open", "print", "input"}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    end_line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}")


@dataclasses.dataclass
class LintContext:
    path: str
    rel_path: str
    tree: ast.Module
    source: str
    gf_scoped: bool
    regions: RegionAnalyzer


class Rule:
    """Base class: subclasses set ``id``/``description`` and implement
    :meth:`check` yielding findings."""

    id: str = ""
    category: str = ""
    description: str = ""

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: LintContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.rel_path, node.lineno,
                       node.col_offset,
                       getattr(node, "end_lineno", node.lineno) or
                       node.lineno, message)


# ----------------------------------------------------------------------
def _is_float_dtype_expr(node: ast.AST) -> bool:
    """np.float32 / jnp.bfloat16 / 'float32' / float / complex..."""
    if isinstance(node, ast.Name):
        return node.id in FLOAT_DTYPE_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in FLOAT_DTYPE_NAMES
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return any(node.value.startswith(p)
                   for p in ("float", "bfloat", "f2", "f4", "f8"))
    return False


class GFFloatRule(Rule):
    id = "gf-float"
    category = "dtype"
    description = ("GF(2^w) symbol code must stay integer: float "
                   "literals, float astype()/dtype=, and true division "
                   "silently promote parity bytes (use // for integer "
                   "division, gf_div for field division)")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.gf_scoped:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.Div):
                yield self.finding(
                    ctx, node,
                    "true division on a GF path promotes to float; use "
                    "// (integer) or gf_div (field inverse)")
            elif isinstance(node, ast.Constant) and isinstance(
                    node.value, float):
                yield self.finding(
                    ctx, node,
                    f"float literal {node.value!r} in GF symbol code")
            elif isinstance(node, ast.Call):
                yield from self._check_call(ctx, node)

    def _check_call(self, ctx: LintContext,
                    node: ast.Call) -> Iterator[Finding]:
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr == "astype"
                and node.args and _is_float_dtype_expr(node.args[0])):
            yield self.finding(
                ctx, node, "astype(<float>) discards GF symbol exactness")
        if isinstance(func, ast.Name) and func.id == "float":
            yield self.finding(
                ctx, node, "float() conversion in GF symbol code")
        for kw in node.keywords:
            if kw.arg in ("dtype", "preferred_element_type") \
                    and _is_float_dtype_expr(kw.value):
                yield self.finding(
                    ctx, kw.value,
                    f"{kw.arg}=<float> in GF symbol code")
        # jnp.asarray(x, jnp.bfloat16)-style positional dtype
        pair = _attr_pair(func)
        if (pair and pair[0] in (NP_ALIASES | JNP_ALIASES)
                and pair[1] in ("asarray", "array", "zeros", "ones",
                                "full", "arange", "empty")
                and len(node.args) >= 2
                and _is_float_dtype_expr(node.args[-1])):
            yield self.finding(
                ctx, node.args[-1],
                f"{pair[0]}.{pair[1]} with float dtype in GF symbol code")


# ----------------------------------------------------------------------
def _contains_gf_table_ref(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in (
                "mul_table", "inv_table", "exp", "log"):
            return True
        if (isinstance(n, ast.Call)
                and _tail_name(n.func) in ("gf8", "gf_mul", "gf_pow",
                                           "gf_inv", "gf_div")):
            return True
    return False


class GFPythonOpRule(Rule):
    id = "gf-python-op"
    category = "gf-arith"
    description = ("Python *, %, ** on values from the gf8 tables "
                   "computes integer math where GF(2^8) field math is "
                   "required — use gf_mul/gf_pow or the table lookups "
                   "(% 255 log-domain wrap and % 2 GF(2) reduction are "
                   "exempt)")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        if not ctx.gf_scoped:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Mult, ast.Mod, ast.Pow)):
                if isinstance(node.op, ast.Mod) and isinstance(
                        node.right, ast.Constant) \
                        and node.right.value in GF_MOD_OK:
                    continue
                if (_contains_gf_table_ref(node.left)
                        or _contains_gf_table_ref(node.right)):
                    op = {"Mult": "*", "Mod": "%",
                          "Pow": "**"}[type(node.op).__name__]
                    yield self.finding(
                        ctx, node,
                        f"Python {op} on a GF table value — integer "
                        "math on field symbols; use gf_mul/gf_pow or "
                        "table lookups")
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id == "pow"
                  and any(_contains_gf_table_ref(a) for a in node.args)):
                yield self.finding(
                    ctx, node,
                    "pow() on a GF table value; use gf_pow")


# ----------------------------------------------------------------------
class HostSyncRule(Rule):
    id = "host-sync"
    category = "host-sync"
    description = ("np.asarray/np.array/.item()/int()/float()/"
                   "jax.device_get on a traced value inside a jit "
                   "region forces a device->host sync per call, "
                   "serializing the pipeline")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for dfn in ctx.regions.regions.values():
            taint = dfn.taint
            for node in walk_region(dfn.node):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                tail = _tail_name(func)
                args_tainted = (
                    any(expr_tainted(a, taint) for a in node.args)
                    or any(expr_tainted(k.value, taint)
                           for k in node.keywords))
                pair = _attr_pair(func)
                if pair and pair[0] in NP_ALIASES and args_tainted:
                    kind = ("forces a device->host transfer"
                            if pair[1] in HOST_SYNC_NP else
                            "runs on host, syncing the traced operand")
                    yield self.finding(
                        ctx, node,
                        f"np.{pair[1]} on a traced value inside jit "
                        f"region '{dfn.name}' {kind}; use jnp.{pair[1]} "
                        "or hoist to the host side")
                elif tail == "device_get" and node.args:
                    yield self.finding(
                        ctx, node,
                        f"jax.device_get inside jit region "
                        f"'{dfn.name}' is a host sync")
                elif (isinstance(func, ast.Attribute)
                      and func.attr == "item"
                      and expr_tainted(func.value, taint)):
                    yield self.finding(
                        ctx, node,
                        f".item() on a traced value inside jit region "
                        f"'{dfn.name}' blocks on device compute")
                elif (isinstance(func, ast.Name)
                      and func.id in ("int", "float", "bool")
                      and args_tainted):
                    yield self.finding(
                        ctx, node,
                        f"{func.id}() on a traced value inside jit "
                        f"region '{dfn.name}' concretizes the tracer "
                        "(host sync or TracerError)")


# ----------------------------------------------------------------------
class TracerBranchRule(Rule):
    id = "tracer-branch"
    category = "recompile"
    description = ("Python if/while on a traced value inside a jit "
                   "region either raises TracerBoolConversionError or "
                   "(via shape-dependent values) hides a recompile per "
                   "distinct value — use jnp.where/lax.cond/lax.select")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for dfn in ctx.regions.regions.values():
            for node in walk_region(dfn.node):
                if isinstance(node, (ast.If, ast.While)) \
                        and expr_tainted(node.test, dfn.taint):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    yield self.finding(
                        ctx, node,
                        f"Python `{kw}` on a traced value inside jit "
                        f"region '{dfn.name}'; use jnp.where or "
                        "lax.cond")


# ----------------------------------------------------------------------
class StaticArgsRule(Rule):
    id = "static-args"
    category = "recompile"
    description = ("static_argnums payloads must be hashable (tuples, "
                   "ints, strings): a list/dict/set static arg raises "
                   "at call time, and an unhashable-but-converted one "
                   "recompiles per call — pass matrix_to_static-style "
                   "tuples")

    UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                  ast.DictComp, ast.SetComp)

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        sites = {s.fn_name: s for s in ctx.regions.jit_sites}
        # mutable defaults on static params at the definition
        for dfn in ctx.regions.regions.values():
            node = dfn.node
            if isinstance(node, ast.Lambda) or not dfn.static_params:
                continue
            params = node.args.posonlyargs + node.args.args
            defaults = node.args.defaults
            for p, d in zip(params[len(params) - len(defaults):],
                            defaults):
                if p.arg in dfn.static_params and isinstance(
                        d, self.UNHASHABLE):
                    yield self.finding(
                        ctx, d,
                        f"static param '{p.arg}' of '{dfn.name}' has an "
                        "unhashable default")
        # call sites passing unhashable literals in static positions
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in sites):
                continue
            site = sites[node.func.id]
            for pos in site.static_positions:
                if pos < len(node.args) and isinstance(
                        node.args[pos], self.UNHASHABLE + (ast.Call,)):
                    arg = node.args[pos]
                    if isinstance(arg, ast.Call):
                        t = _tail_name(arg.func)
                        if t not in ("list", "dict", "set", "asarray",
                                     "array"):
                            continue
                        what = f"{t}(...) result"
                    else:
                        what = type(arg).__name__.lower()
                    yield self.finding(
                        ctx, arg,
                        f"unhashable {what} passed in static position "
                        f"{pos} of jitted '{site.fn_name}' — every call "
                        "recompiles (or raises); pass a tuple")
            for kw in node.keywords:
                if kw.arg in site.static_names and isinstance(
                        kw.value, self.UNHASHABLE):
                    yield self.finding(
                        ctx, kw.value,
                        f"unhashable literal for static arg "
                        f"'{kw.arg}' of jitted '{site.fn_name}'")


# ----------------------------------------------------------------------
class JitClosureRule(Rule):
    id = "jit-closure"
    category = "recompile"
    description = ("a jit-decorated closure capturing a variable the "
                   "enclosing scope keeps mutating bakes the "
                   "trace-time value into the compiled program — later "
                   "mutations are silently ignored (or retrace per "
                   "identity); pass the value as an argument")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        scopes = ctx.regions.scopes
        for dfn in ctx.regions.regions.values():
            if dfn.kind not in ("jit", "shard_map", "pallas"):
                continue
            encl = scopes.parent_scope.get(id(dfn.node))
            if encl is None or isinstance(encl, ast.Module):
                continue
            free = self._free_names(dfn.node)
            if not free:
                continue
            mutated = self._mutated_after(encl, dfn.node, free)
            # span from the first decorator so a pragma above @jit
            # covers the whole header
            start = min([d.lineno for d in getattr(
                dfn.node, "decorator_list", [])] + [dfn.node.lineno])
            for name, line in sorted(mutated.items()):
                yield Finding(
                    self.id, ctx.rel_path, start,
                    dfn.node.col_offset,
                    getattr(dfn.node, "end_lineno", dfn.node.lineno),
                    f"jitted closure '{dfn.name}' captures '{name}', "
                    f"which the enclosing scope mutates (line {line}) "
                    "after the closure is defined — the trace keeps "
                    "the old value; pass it as an argument")

    @staticmethod
    def _free_names(fn) -> Set[str]:
        bound: Set[str] = set()
        a = fn.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs
                  + ([a.vararg] if a.vararg else [])
                  + ([a.kwarg] if a.kwarg else [])):
            bound.add(p.arg)
        loaded: Set[str] = set()
        for node in walk_region(fn):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loaded.add(node.id)
                else:
                    bound.add(node.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                if node is not fn:
                    bound.add(node.name)
        import builtins
        return {n for n in loaded - bound if not hasattr(builtins, n)}

    @staticmethod
    def _mutated_after(encl, fn, free: Set[str]) -> Dict[str, int]:
        """free vars the enclosing fn reassigns/augments *after* the
        closure definition line (a single binding before the def is the
        normal capture pattern)."""
        out: Dict[str, int] = {}
        def_line = fn.lineno
        for node in walk_region(encl):
            names: List[str] = []
            if isinstance(node, ast.AugAssign):
                if isinstance(node.target, ast.Name):
                    names = [node.target.id]
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
            if getattr(node, "lineno", 0) <= def_line:
                continue
            for n in names:
                if n in free and n not in out:
                    out[n] = node.lineno
        return out


# ----------------------------------------------------------------------
class ImpureJitRule(Rule):
    id = "impure-jit"
    category = "purity"
    description = ("RNG, clocks, I/O and global mutation inside a jit "
                   "region run once at trace time and bake their value "
                   "into the compiled program — use jax.random with an "
                   "explicit key, time outside the region, and carry "
                   "state functionally")

    def check(self, ctx: LintContext) -> Iterator[Finding]:
        for dfn in ctx.regions.regions.values():
            for node in walk_region(dfn.node):
                if isinstance(node, ast.Global):
                    yield self.finding(
                        ctx, node,
                        f"`global` mutation inside jit region "
                        f"'{dfn.name}' is trace-time only")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                chain = self._dotted(func)
                if chain[:2] == ("np", "random") or \
                        chain[:2] == ("numpy", "random"):
                    yield self.finding(
                        ctx, node,
                        f"np.random inside jit region '{dfn.name}' "
                        "draws once at trace time; use jax.random with "
                        "an explicit key")
                elif chain[:1] == ("random",) and len(chain) > 1:
                    yield self.finding(
                        ctx, node,
                        f"random.{chain[1]} inside jit region "
                        f"'{dfn.name}' is trace-time only")
                elif chain[:1] == ("time",) and len(chain) > 1:
                    yield self.finding(
                        ctx, node,
                        f"time.{chain[1]} inside jit region "
                        f"'{dfn.name}' reads the clock at trace time, "
                        "not per call")
                elif chain[:2] in (("os", "environ"), ("os", "getenv")) \
                        or chain[:2] == ("os", "urandom"):
                    yield self.finding(
                        ctx, node,
                        f"os.{chain[1]} inside jit region '{dfn.name}' "
                        "is trace-time I/O")
                elif (isinstance(func, ast.Name)
                      and func.id in PURITY_BAD_CALLS):
                    yield self.finding(
                        ctx, node,
                        f"{func.id}() inside jit region '{dfn.name}' "
                        "runs at trace time only (use jax.debug.print "
                        "for per-call output)")

    @staticmethod
    def _dotted(node: ast.AST) -> Tuple[str, ...]:
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return tuple(reversed(parts))


ALL_RULES: Tuple[Rule, ...] = (
    GFFloatRule(),
    GFPythonOpRule(),
    HostSyncRule(),
    TracerBranchRule(),
    StaticArgsRule(),
    JitClosureRule(),
    ImpureJitRule(),
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
