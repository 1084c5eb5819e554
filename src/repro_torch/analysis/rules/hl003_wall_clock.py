"""HL003: no wall-clock reads outside ``benchmarks/``.

Copy of the JAX package's rule.

The simulator has exactly one notion of time — the event-calendar clock
threaded through ``run_stage_events`` / ``run_job`` / the resident
calendar.  A ``time.time()`` / ``perf_counter()`` / ``datetime.now()``
call inside ``src/`` either leaks host timing into simulated results
(nondeterministic oracles) or silently measures the wrong clock.
Real-time measurement belongs in ``benchmarks/`` (which is outside
``src/`` and therefore outside this rule's scope by construction).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..base import FileContext, Finding, from_imports, import_aliases, register

TIME_FUNCS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
})
DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})


@register
class WallClockRule:
    code = "HL003"
    name = "wall-clock"
    description = ("forbid time.time/perf_counter/datetime.now outside "
                   "benchmarks/ — simulation results must depend only on "
                   "the simulated clock")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test or ctx.in_dir("benchmarks"):
            return
        tree = ctx.tree
        time_aliases = import_aliases(tree, "time")
        dt_mod_aliases = import_aliases(tree, "datetime")
        dt_cls_names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "datetime":
                for a in node.names:
                    if a.name in {"datetime", "date"}:
                        dt_cls_names.add(a.asname or a.name)

        for local, node in from_imports(tree, "time").items():
            if local in TIME_FUNCS:
                yield ctx.finding(
                    node, self.code,
                    f"wall-clock import ('{local}' from time); simulation "
                    f"code must use the simulated clock — real timing "
                    f"belongs in benchmarks/")

        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            # time.time(), time.perf_counter(), ...
            if (node.attr in TIME_FUNCS and isinstance(base, ast.Name)
                    and base.id in time_aliases):
                yield ctx.finding(
                    node, self.code,
                    f"wall-clock read time.{node.attr}; simulation code "
                    f"must use the simulated clock — real timing belongs "
                    f"in benchmarks/")
                continue
            if node.attr not in DATETIME_FUNCS:
                continue
            # datetime.now() via `from datetime import datetime/date`
            if isinstance(base, ast.Name) and base.id in dt_cls_names:
                yield ctx.finding(
                    node, self.code,
                    f"wall-clock read {base.id}.{node.attr}(); simulation "
                    f"code must not depend on the host date/time")
            # datetime.datetime.now() via `import datetime`
            elif (isinstance(base, ast.Attribute)
                  and base.attr in {"datetime", "date"}
                  and isinstance(base.value, ast.Name)
                  and base.value.id in dt_mod_aliases):
                yield ctx.finding(
                    node, self.code,
                    f"wall-clock read datetime.{base.attr}.{node.attr}(); "
                    f"simulation code must not depend on the host date/time")
