"""HL001: solve-cache / dedup key dataclasses must be frozen and hashable.

Copy of the JAX package's rule; its scope is the port's package
(directories named ``repro_torch``).

``run_job``'s module-level solve LRU, the resident calendar's per-spec
solve reuse, and ``batched.dedup_rows`` all key by *value* on spec
objects.  A spec that is mutable, or carries an unhashable field
(``list`` / ``dict`` / ``set`` / ``np.ndarray``), either raises
``TypeError`` at first cache lookup or — worse — hashes by identity and
silently poisons the cache with stale solves.

Which dataclasses count as specs (the "reachable as a key" closure):

* an explicit allow-list of the engine's known key types
  (:data:`SPEC_ROOTS`: stage specs, mitigation policies, fault events,
  arrival traces, …),
* any dataclass whose name ends in ``Spec`` / ``Trace`` / ``Policy``
  (the repo's naming convention for hashable value specs), and
* transitively, any same-file dataclass named in a field annotation of
  one already in the closure (recursive hashability).

For every spec in the closure the rule requires ``frozen=True`` on the
decorator and flags fields annotated with unhashable container types.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..base import FileContext, Finding, register

SPEC_ROOTS = frozenset({
    # engine stage specs (run_job solve LRU keys)
    "PullSpec", "StaticSpec",
    # mitigation policies (hashable fields of the stage specs)
    "SpeculativeCopies", "WorkStealing", "ReskewHandoff",
    "DuplicatePlacement",
    # fault model (FaultTrace rides run_stage_events / resident splices)
    "NodeCrash", "SpotPreemption", "RetryPolicy", "FaultTrace",
    # arrival traces + serving request model (seeded value specs)
    "PoissonTrace", "DiurnalTrace", "MMPPTrace", "RequestModel",
    # capacity / resident value specs
    "BurstableNode", "ResizeEvent",
})

SPEC_SUFFIXES: Tuple[str, ...] = ("Spec", "Trace", "Policy")

UNHASHABLE_NAMES = frozenset({
    "list", "List", "dict", "Dict", "set", "Set", "bytearray",
    "ndarray", "MutableSequence", "MutableMapping", "MutableSet",
    "DefaultDict", "defaultdict", "OrderedDict", "Counter", "deque",
})


def _dataclass_frozen(cls: ast.ClassDef) -> Optional[bool]:
    """None if not a dataclass; else the frozen= value (False when absent
    or not a literal True)."""
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else (
            target.id if isinstance(target, ast.Name) else None)
        if name != "dataclass":
            continue
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "frozen":
                    return isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True
            return False
        return False
    return None


def _annotation_names(ann: ast.AST) -> Set[str]:
    """Every type name mentioned anywhere in an annotation (handles
    Optional[...], Tuple[...], string forward references)."""
    names: Set[str] = set()
    stack: List[ast.AST] = [ann]
    while stack:
        node = stack.pop()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name):
                names.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                names.add(sub.attr)
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                try:
                    stack.append(ast.parse(sub.value, mode="eval").body)
                except SyntaxError:
                    pass
    return names


@register
class FrozenSpecRule:
    code = "HL001"
    name = "frozen-spec"
    description = ("solve-cache/dedup key dataclasses must be frozen=True "
                   "with recursively hashable field types")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test or not ctx.in_dir("repro_torch"):
            return
        classes: Dict[str, ast.ClassDef] = {}
        frozen: Dict[str, bool] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                fz = _dataclass_frozen(node)
                if fz is not None:
                    classes[node.name] = node
                    frozen[node.name] = fz

        specs: Set[str] = {n for n in classes
                           if n in SPEC_ROOTS or n.endswith(SPEC_SUFFIXES)}
        # same-file closure over field annotations (recursive hashability)
        changed = True
        while changed:
            changed = False
            for name in list(specs):
                for stmt in classes[name].body:
                    if not isinstance(stmt, ast.AnnAssign):
                        continue
                    for ref in _annotation_names(stmt.annotation):
                        if ref in classes and ref not in specs:
                            specs.add(ref)
                            changed = True

        for name in sorted(specs):
            cls = classes[name]
            if not frozen[name]:
                yield ctx.finding(
                    cls, self.code,
                    f"spec dataclass '{name}' is a solve-cache/dedup key "
                    f"type and must be @dataclass(frozen=True)")
            for stmt in cls.body:
                if not isinstance(stmt, ast.AnnAssign):
                    continue
                bad = _annotation_names(stmt.annotation) & UNHASHABLE_NAMES
                if bad:
                    field = stmt.target.id if isinstance(
                        stmt.target, ast.Name) else "<field>"
                    yield ctx.finding(
                        stmt, self.code,
                        f"spec field '{name}.{field}' is annotated with "
                        f"unhashable type(s) {sorted(bad)}; use "
                        f"Tuple/FrozenSet/Mapping-free equivalents so the "
                        f"spec stays hashable")
