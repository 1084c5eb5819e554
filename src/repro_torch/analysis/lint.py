"""hemt-lint runner + CLI (``python -m repro_torch.analysis.lint``).

Copy of the JAX package's ``repro/analysis/lint.py``: the default path
and the self-check are the port's own package, ``src/repro_torch``.

Exit codes: 0 clean, 1 findings (or unused waivers), 2 usage/internal
error — so the CI job and the tier-1 self-check test can gate on it the
same way ``benchmarks/run.py --check`` gates perf.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

from .base import (CODE_RE, FileContext, Finding, all_rules, apply_waivers,
                   parse_waivers)
from . import rules as _rules  # noqa: F401  (imports register the rules)

SKIP_DIRS = {"__pycache__", ".git", ".hypothesis", ".ruff_cache"}


@dataclass
class LintReport:
    """Everything one run produced, in a JSON-able shape."""
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, int, str]] = field(default_factory=list)
    files_checked: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if (self.findings or self.unused_waivers) else 0

    def to_json(self) -> dict:
        return {
            "version": 1,
            "files_checked": self.files_checked,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": len(self.suppressed),
            "unused_waivers": [
                {"path": p, "line": ln, "code": c}
                for p, ln, c in self.unused_waivers],
            "counts": self.counts(),
        }

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out


def iter_python_files(paths: Sequence[str]) -> Iterable[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in SKIP_DIRS for part in f.parts):
                    yield f
        elif p.suffix == ".py":
            yield p


def lint_source(source: str, path: str,
                select: Optional[Sequence[str]] = None) -> LintReport:
    """Lint one in-memory file.  ``path`` drives rule scoping, so tests
    hand fixture snippets virtual paths like ``src/repro_torch/core/x.py``."""
    report = LintReport(files_checked=1)
    try:
        ctx = FileContext.from_source(source, path)
    except SyntaxError as exc:
        report.findings.append(Finding(
            path, exc.lineno or 1, exc.offset or 0, "HL000",
            f"syntax error: {exc.msg}"))
        return report
    raw: List[Finding] = []
    for rule in all_rules():
        if select and rule.code not in select:
            continue
        raw.extend(rule.check(ctx))
    waivers = parse_waivers(source)
    kept, suppressed, unused = apply_waivers(sorted(raw), waivers)
    report.findings = kept
    report.suppressed = suppressed
    # only police waivers for rules that actually ran, so a
    # --select run doesn't report every other rule's waiver as unused
    active = {r.code for r in all_rules()
              if not select or r.code in select}
    report.unused_waivers = [(ctx.path, ln, code) for ln, code in unused
                             if code in active]
    return report


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None) -> LintReport:
    total = LintReport()
    for f in iter_python_files(paths):
        sub = lint_source(f.read_text(encoding="utf-8"), f.as_posix(),
                          select)
        total.findings.extend(sub.findings)
        total.suppressed.extend(sub.suppressed)
        total.unused_waivers.extend(sub.unused_waivers)
        total.files_checked += 1
    total.findings.sort()
    return total


def repo_root() -> Path:
    """src/repro_torch/analysis/lint.py -> the repo checkout root."""
    return Path(__file__).resolve().parents[3]


def self_check() -> LintReport:
    """The tree-is-clean gate: lint the package this linter ships with,
    ``src/repro_torch``, from wherever the process runs."""
    return lint_paths([str(repo_root() / "src" / "repro_torch")])


def _parse_select(spec: str) -> List[str]:
    codes = [c.strip() for c in spec.split(",") if c.strip()]
    bad = [c for c in codes if not CODE_RE.match(c)]
    if bad:
        raise argparse.ArgumentTypeError(
            f"bad rule code(s) {bad}; expected HLxxx")
    return codes


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="hemt-lint: contract-enforcing static analysis for "
                    "the HeMT engine (determinism, hashability, "
                    "tracer-safety).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files/directories to lint (default: src/repro_torch)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--select", type=_parse_select, default=None,
                        metavar="HL001,HL004",
                        help="run only these rule codes")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--output", default=None, metavar="FILE",
                        help="also write the report (in --format) here — "
                             "the CI job uploads this as an artifact")
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:        # argparse exits 2 on usage errors
        return int(exc.code or 0)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.code}  {rule.name:16s} {rule.description}")
        return 0

    report = lint_paths(args.paths, args.select)

    if args.format == "json":
        rendered = json.dumps(report.to_json(), indent=2, sort_keys=True)
    else:
        lines = [f.format() for f in report.findings]
        lines += [f"{p}:{ln}: unused waiver for {code}"
                  for p, ln, code in report.unused_waivers]
        summary = (f"{len(report.findings)} finding(s), "
                   f"{len(report.suppressed)} waived, "
                   f"{len(report.unused_waivers)} unused waiver(s) in "
                   f"{report.files_checked} file(s)")
        rendered = "\n".join(lines + [summary])
    print(rendered)
    if args.output:
        Path(args.output).write_text(rendered + "\n", encoding="utf-8")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
