"""HL005: torch-traced code must stay tracer-safe.

The reference's rule with torch's tracing entry points in place of
JAX's: the same findings (python control flow on traced values,
``.item()``, concretizing casts, data-dependent shapes, one-argument
``where``), made inside the functions torch traces.

``kernels/`` and ``core/batched.py`` hold the torch twins of the numpy
closed forms and the kernels' plain versions.  Code that runs eagerly
today but concretizes a traced value (``if x > 0`` on a tensor,
``.item()``, ``float(x)``) or produces a data-dependent shape
(``torch.nonzero``, ``masked_select``, one-argument ``torch.where``)
breaks a graph or fails only when the enclosing ``torch.compile`` /
``vmap`` / ``jit.trace`` finally lands.  This rule flags those
constructs *inside traced functions*.

What counts as traced (static heuristic, documented over-approximation):

* functions decorated with ``@torch.compile`` (bare, called, or through
  ``functools.partial``), ``@torch.func.vmap`` / ``@torch.vmap``,
  ``@torch.jit.trace`` / ``@torch.jit.script``,
* functions passed (directly, via a name, or via a ``functools.partial``
  binding) to ``torch.compile``, ``torch.func.vmap`` / ``torch.vmap``,
  ``torch.jit.trace`` / ``torch.jit.script``,
  ``torch.fx.symbolic_trace``, ``torch.export.export`` or
  ``torch.cuda.make_graphed_callables``,
* and every function nested inside one of those (closures trace too).

An entry is recognised by its full name, through ``import torch [as t]``
and ``from torch[.x] import y [as z]``.  ``torch.utils.checkpoint`` runs
its function eagerly, so it is not an entry.

Traced *values* are the function's positional parameters plus any local
assigned from one.  Keyword-only parameters are static (python values at
trace time), as are ``is None`` tests and ``isinstance`` checks.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from ..base import FileContext, Finding, dotted_name, names_in, register
from .hl002_seeded_rng import full_name, torch_names

TRACE_ENTRY_FUNCS = frozenset({
    "torch.compile", "torch.vmap", "torch.func.vmap", "torch.jit.trace",
    "torch.jit.script", "torch.fx.symbolic_trace", "torch.export.export",
    "torch.cuda.make_graphed_callables",
})
TRACING_DECORATORS = frozenset({
    "torch.compile", "torch.vmap", "torch.func.vmap", "torch.jit.trace",
    "torch.jit.script",
})
DATA_DEP_SHAPE_FUNCS = frozenset({
    "nonzero", "flatnonzero", "argwhere", "unique", "extract", "compress",
    "masked_select", "unique_consecutive",
})
CONCRETIZING_CASTS = frozenset({"float", "int", "bool", "complex"})


def _last_component(node: ast.AST) -> Optional[str]:
    d = dotted_name(node)
    return d.split(".")[-1] if d else None


def _is_tracing_decorator(dec: ast.AST, names: Dict[str, str]) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    if full_name(target, names) in TRACING_DECORATORS:
        return True
    # @partial(torch.compile, ...) / @functools.partial(torch.compile, ...)
    if _last_component(target) == "partial" and isinstance(dec, ast.Call) \
            and dec.args:
        return full_name(dec.args[0], names) in TRACING_DECORATORS
    return False


def _collect_traced_roots(tree: ast.Module) -> Set[str]:
    """Every function the file traces, by name."""
    names = torch_names(tree)
    funcs: Dict[str, ast.FunctionDef] = {
        n.name: n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    traced: Set[str] = {name for name, fn in funcs.items()
                        if any(_is_tracing_decorator(dec, names)
                               for dec in fn.decorator_list)}

    # alias = f  /  alias = partial(f, ...) — resolve one level
    alias_of: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            val = node.value
            if isinstance(val, ast.Name) and val.id in funcs:
                alias_of[node.targets[0].id] = val.id
            elif isinstance(val, ast.Call) \
                    and _last_component(val.func) == "partial" \
                    and val.args and isinstance(val.args[0], ast.Name) \
                    and val.args[0].id in funcs:
                alias_of[node.targets[0].id] = val.args[0].id

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if full_name(node.func, names) not in TRACE_ENTRY_FUNCS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            target = None
            if isinstance(arg, ast.Name):
                target = alias_of.get(arg.id, arg.id)
            elif isinstance(arg, ast.Call) \
                    and _last_component(arg.func) == "partial" \
                    and arg.args and isinstance(arg.args[0], ast.Name):
                target = arg.args[0].id
            if target in funcs:
                traced.add(target)
    return traced


def _traced_names(fn: ast.FunctionDef, inherited: Set[str]) -> Set[str]:
    """Positional params + locals derived from them (fixpoint pass)."""
    args = fn.args
    names = {a.arg for a in (args.posonlyargs + args.args)}
    names |= inherited
    if args.vararg:
        names.add(args.vararg.arg)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and (names_in(node.value)
                                                 & names):
                for tgt in node.targets:
                    for sub in ast.walk(tgt):
                        if isinstance(sub, ast.Name) \
                                and sub.id not in names:
                            names.add(sub.id)
                            changed = True
    return names


def _is_static_test(test: ast.AST, traced: Set[str]) -> bool:
    """is None / isinstance / no traced name referenced -> static."""
    if not (names_in(test) & traced):
        return True
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    if isinstance(test, ast.Call) \
            and _last_component(test.func) == "isinstance":
        return True
    return False


@register
class TracerSafetyRule:
    code = "HL005"
    name = "tracer-safety"
    description = ("flag python control flow on traced values, .item(), "
                   "concretizing casts, and data-dependent shapes inside "
                   "torch.compile/vmap/jit bodies in kernels/ and "
                   "core/batched.py")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test:
            return
        if not (ctx.in_dir("kernels")
                or (ctx.in_dir("core") and ctx.name == "batched.py")):
            return
        roots = _collect_traced_roots(ctx.tree)
        funcs = {n.name: n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # (fn, inherited traced names); nested defs trace too
        work: List = [(funcs[name], set()) for name in sorted(roots) if name in funcs]
        emitted: Set = set()        # a fn can be both a root and nested
        while work:
            fn, inherited = work.pop()
            traced = _traced_names(fn, inherited)
            for f in self._check_body(ctx, fn, traced):
                key = (f.line, f.col, f.message)
                if key not in emitted:
                    emitted.add(key)
                    yield f
            for stmt in ast.walk(fn):
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and stmt is not fn:
                    work.append((stmt, traced))

    def _check_body(self, ctx: FileContext, fn: ast.FunctionDef,
                    traced: Set[str]) -> Iterable[Finding]:
        nested = {n for sub in ast.walk(fn)
                  if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and sub is not fn
                  for n in ast.walk(sub)}
        for node in ast.walk(fn):
            if node in nested:        # reported by the nested visit
                continue
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                test = node.test
                if not _is_static_test(test, traced):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression",
                            ast.Assert: "assert"}[type(node)]
                    yield ctx.finding(
                        node, self.code,
                        f"python {kind} on traced value(s) "
                        f"{sorted(names_in(test) & traced)} in traced "
                        f"function '{fn.name}'; use torch.where/torch.cond")
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "item":
                    yield ctx.finding(
                        node, self.code,
                        f".item() concretizes a tracer in traced function "
                        f"'{fn.name}'")
                    continue
                last = _last_component(node.func)
                if last in CONCRETIZING_CASTS \
                        and isinstance(node.func, ast.Name) and node.args \
                        and (names_in(node.args[0]) & traced):
                    yield ctx.finding(
                        node, self.code,
                        f"{last}() cast concretizes traced value(s) in "
                        f"traced function '{fn.name}'; use .to()/torch "
                        f"ops instead")
                elif last in DATA_DEP_SHAPE_FUNCS:
                    yield ctx.finding(
                        node, self.code,
                        f"{last}() produces a data-dependent shape; not "
                        f"traceable inside traced function '{fn.name}'")
                elif last == "where" and len(node.args) == 1:
                    yield ctx.finding(
                        node, self.code,
                        f"one-argument where() produces a data-dependent "
                        f"shape in traced function '{fn.name}'; pass "
                        f"(cond, x, y)")
