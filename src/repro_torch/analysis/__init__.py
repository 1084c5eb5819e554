"""repro_torch.analysis — hemt-lint for the port, the engine's
contract-enforcing analyzer.

Copy of the JAX package's ``repro/analysis/`` (standard library only):
the same codes, names, waiver syntax, exit codes and JSON shape, with
HL001 scoped to ``repro_torch`` and HL002 and HL005 knowing torch's
random number generators and tracing entry points. Run it::

    PYTHONPATH=src python -m repro_torch.analysis.lint                    # src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint --format=json src/repro_torch

See :mod:`repro_torch.analysis.base` for the rule protocol and waiver syntax,
and the README "Static analysis" section for the rule table.
"""
from .base import (Finding, FileContext, Rule, all_rules, apply_waivers,
                   get_rule, parse_waivers, register)

__all__ = [
    "Finding", "FileContext", "Rule", "register", "all_rules", "get_rule",
    "parse_waivers", "apply_waivers",
    "LintReport", "lint_paths", "lint_source", "main", "self_check",
]

_LINT_NAMES = {"LintReport", "lint_paths", "lint_source", "main",
               "self_check"}


def __getattr__(name):
    # lazy: `python -m repro_torch.analysis.lint` must not find the submodule
    # pre-imported by its own package (runpy RuntimeWarning)
    if name in _LINT_NAMES:
        from . import lint
        return getattr(lint, name)
    raise AttributeError(name)
