"""HL004: no ``==`` / ``!=`` between float-typed expressions in solver code.

Copy of the JAX package's rule.

Every differential oracle pins the fast paths at 1e-9, and the
speculation trigger carries an explicit ``_EPS`` guard precisely because
``(start + thr) - start`` can round below ``thr`` at nonzero starts
(a shift-invariance bug the engine once had).  A bare float equality in ``core/``
solver code is either that bug waiting to recur, or an *exact-routing
check* (e.g. "all io_mb identical -> symmetric closed form") that is
deliberately exact because inequality merely falls back to the event
path.  The former must be rewritten with a tolerance; the latter gets a
waiver whose justification documents why exactness is safe.

Float-typedness is decided by a local heuristic (no type inference):

* float literals (``x != 0.0``),
* ``float(...)`` casts,
* names annotated ``: float`` (parameters or assignments) or assigned
  from a float-typed expression, within the enclosing function,
* attribute reads of float-annotated dataclass fields declared in the
  same file, plus the engine's well-known cross-file float spec fields
  (:data:`KNOWN_FLOAT_ATTRS`).

Comparisons against integer literals or untyped names are not flagged —
precision over recall; the randomized oracles catch what this misses.
"""
from __future__ import annotations

import ast
from typing import Iterable, Set

from ..base import FileContext, Finding, register

# float-annotated spec fields compared across module boundaries
# (PullSpec.task_work / io_mb, SimTask.io_mb / cpu_work, fault times)
KNOWN_FLOAT_ATTRS = frozenset({
    "io_mb", "task_work", "cpu_work", "at", "recover_at", "warning",
    "grain", "carry",
})


def _is_float_annotation(ann: ast.AST) -> bool:
    return isinstance(ann, ast.Name) and ann.id == "float"


def _collect_file_float_attrs(tree: ast.Module) -> Set[str]:
    """Names of float-annotated dataclass fields declared in this file."""
    attrs: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and _is_float_annotation(stmt.annotation)):
                attrs.add(stmt.target.id)
    return attrs


class _FloatEnv:
    """Per-function set of names known to be float-typed."""

    def __init__(self, func: ast.AST, file_attrs: Set[str]):
        self.file_attrs = file_attrs
        self.names: Set[str] = set()
        if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = func.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None \
                        and _is_float_annotation(a.annotation):
                    self.names.add(a.arg)
            # one forward pass: names assigned from float-typed exprs
            for node in ast.walk(func):
                if (isinstance(node, ast.AnnAssign)
                        and isinstance(node.target, ast.Name)
                        and _is_float_annotation(node.annotation)):
                    self.names.add(node.target.id)
                elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and self.is_float(node.value):
                    self.names.add(node.targets[0].id)

    def is_float(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, float)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "float":
            return True
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            return node.attr in self.file_attrs \
                or node.attr in KNOWN_FLOAT_ATTRS
        if isinstance(node, ast.BinOp):
            return self.is_float(node.left) or self.is_float(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_float(node.operand)
        return False


@register
class FloatEqRule:
    code = "HL004"
    name = "float-eq"
    description = ("== / != between float-typed expressions in core/ "
                   "solver modules; use a 1e-9 guard or waive documented "
                   "exact-routing checks")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test or not ctx.in_dir("core"):
            return
        file_attrs = _collect_file_float_attrs(ctx.tree)
        funcs = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes = funcs if funcs else []
        seen: Set[int] = set()
        for scope in scopes:
            env = _FloatEnv(scope, file_attrs)
            for node in ast.walk(scope):
                if not isinstance(node, ast.Compare) or id(node) in seen:
                    continue
                seen.add(id(node))
                operands = [node.left] + list(node.comparators)
                for op, left, right in zip(node.ops, operands,
                                           operands[1:]):
                    if not isinstance(op, (ast.Eq, ast.NotEq)):
                        continue
                    if env.is_float(left) or env.is_float(right):
                        sym = "==" if isinstance(op, ast.Eq) else "!="
                        yield ctx.finding(
                            node, self.code,
                            f"float {sym} in solver code; compare with a "
                            f"1e-9 tolerance (the oracles' pin) or waive "
                            f"with the exactness argument")
                        break
