"""HL006: closed-form solver functions must not mutate array parameters.

Copy of the JAX package's rule.

``run_job`` caches solves by spec *value* and replays them as O(n)
shifts; the batched planner dedups rows and fans one solve out to every
duplicate.  Both are sound only because solving is a pure function of
its inputs — a solver that sorts, scales, or writes into a caller's
array in place corrupts every later cache hit *and* the caller's spec.

Scope: functions whose names carry the solver prefixes
(:data:`SOLVER_PREFIXES`) in ``core/engine.py`` and ``core/batched.py``.
Flagged constructs, on any name aliasing a parameter:

* subscript stores (``works[i] = x``) and augmented subscript stores,
* augmented assignment to the bare name (``works += x`` is in-place for
  ndarrays),
* in-place methods (``.sort()``, ``.fill()``, ``.put()``, …).

Aliasing is tracked flow-insensitively: ``np.asarray`` / ``atleast_2d``
/ ``reshape`` / ``ravel`` / ``transpose`` / ``squeeze`` / views via
subscripts KEEP the taint (numpy returns no-copy views of an existing
ndarray), while any other rebinding (``x = x.copy()``,
``x = np.array(x)``, arithmetic) clears it.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Set, Tuple

from ..base import FileContext, Finding, register

SOLVER_PREFIXES: Tuple[str, ...] = (
    "_closed_form", "batched_closed", "pull_scan", "_pull",
    "_rel_summary", "dedup_rows", "_stage_result", "_as_2d",
    "_broadcast_overheads", "_finish_stats",
)

# numpy calls that may return a view of (or the very same) input array
ALIASING_CALLS = frozenset({
    "asarray", "asanyarray", "atleast_1d", "atleast_2d", "atleast_3d",
    "ravel", "reshape", "transpose", "squeeze", "view", "broadcast_to",
})

INPLACE_METHODS = frozenset({
    "sort", "fill", "put", "resize", "setflags", "itemset", "partition",
    "setfield", "byteswap",
    # list/dict mutators, should a solver take sequence params
    "append", "extend", "insert", "remove", "clear", "reverse", "pop",
    "update", "setdefault", "popitem",
})


def _subscript_root(node: ast.AST) -> Optional[str]:
    """a[i][j].b[k] -> 'a' (the name whose storage a store would hit)."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _Taint:
    def __init__(self, fn: ast.FunctionDef):
        a = fn.args
        self.names: Set[str] = {
            x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)}
        if a.vararg:
            self.names.add(a.vararg.arg)
        # flow-insensitive alias pass to fixpoint
        changed = True
        cleared: Set[str] = set()
        while changed:
            changed = False
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    if self._aliases(node.value):
                        if tgt.id not in self.names:
                            self.names.add(tgt.id)
                            changed = True
                    elif tgt.id in self.names and tgt.id not in cleared:
                        # rebound to a fresh value (x = x.copy(), x = np.
                        # array(x), arithmetic): taint cleared
                        self.names.discard(tgt.id)
                        cleared.add(tgt.id)
                        changed = True
                elif isinstance(tgt, ast.Tuple) and self._aliases(node.value):
                    for el in tgt.elts:
                        if isinstance(el, ast.Name) \
                                and el.id not in self.names:
                            self.names.add(el.id)
                            changed = True

    def _aliases(self, value: ast.AST) -> bool:
        """Does this expression alias tainted storage?"""
        if isinstance(value, ast.Name):
            return value.id in self.names
        if isinstance(value, (ast.Subscript, ast.Attribute)):
            return _subscript_root(value) in self.names
        if isinstance(value, ast.Call):
            func = value.func
            fname = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if fname in ALIASING_CALLS:
                # np.asarray(works) aliases; works.reshape(...) aliases
                if isinstance(func, ast.Attribute) \
                        and self._aliases(func.value):
                    return True
                return any(self._aliases(arg) for arg in value.args)
        return False


@register
class ArgMutationRule:
    code = "HL006"
    name = "arg-mutation"
    description = ("closed-form solver functions must not mutate array "
                   "parameters (in-place stores poison the value-keyed "
                   "solve caches)")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test or not ctx.in_dir("core"):
            return
        if ctx.name not in {"engine.py", "batched.py"}:
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not fn.name.startswith(SOLVER_PREFIXES):
                continue
            taint = _Taint(fn)
            yield from self._check_fn(ctx, fn, taint)

    def _check_fn(self, ctx: FileContext, fn: ast.FunctionDef,
                  taint: "_Taint") -> Iterable[Finding]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        root = _subscript_root(tgt)
                        if root in taint.names:
                            yield ctx.finding(
                                node, self.code,
                                f"subscript store into parameter-aliased "
                                f"'{root}' in solver '{fn.name}'; copy "
                                f"before writing (solves must be pure)")
            elif isinstance(node, ast.AugAssign):
                tgt = node.target
                root = tgt.id if isinstance(tgt, ast.Name) \
                    else _subscript_root(tgt)
                if root in taint.names:
                    yield ctx.finding(
                        node, self.code,
                        f"in-place augmented assignment to "
                        f"parameter-aliased '{root}' in solver "
                        f"'{fn.name}'; copy before writing")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in INPLACE_METHODS:
                root = _subscript_root(node.func.value)
                if root in taint.names:
                    yield ctx.finding(
                        node, self.code,
                        f"in-place .{node.func.attr}() on "
                        f"parameter-aliased '{root}' in solver "
                        f"'{fn.name}'; use the copying equivalent")
