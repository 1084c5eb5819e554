"""hemt-lint core: findings, file context, waivers, and the rule registry.

Copy of the JAX package's ``repro/analysis/base.py`` (standard library
only), with the rules module named as the port's.

The engine's correctness story rests on conventions no type checker sees:
solve caches key by *value* on frozen hashable specs, differential oracles
pin paths at 1e-9 and therefore need seeded-``Generator``-only randomness,
and the jax twins must stay tracer-safe for the Pallas port.  ``hemt-lint``
makes those conventions machine-checked: each invariant is a :class:`Rule`
with a stable ``HLxxx`` code, precise ``file:line:col`` diagnostics, and
inline waivers.

Waiver syntax (checked by :func:`parse_waivers`)::

    x = t.io_mb != m   # hemt-lint: disable=HL004  exact-routing guard, ...
    # hemt-lint: disable=HL003  justification for the NEXT line
    t0 = time.time()

A waiver comment on its own line covers the following line (for statements
that would overflow the line-length budget); codes are comma-separated.
Waivers that suppress nothing are reported by the runner so they cannot
rot silently.

Adding a rule is three steps: subclass-free — write a class with ``code`` /
``name`` / ``description`` attributes and a ``check(ctx)`` generator,
decorate it with :func:`register`, and import the module from
``repro_torch.analysis.rules``.  The CLI, JSON output, waivers, and the repo
self-check pick it up automatically.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import PurePosixPath
from typing import Dict, Iterable, List, Optional, Protocol, Tuple, runtime_checkable

__all__ = [
    "Finding", "FileContext", "Rule", "register", "all_rules", "get_rule",
    "parse_waivers", "apply_waivers", "CODE_RE",
]

CODE_RE = re.compile(r"^HL\d{3}$")

_WAIVER_RE = re.compile(
    r"#\s*hemt-lint:\s*disable=([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)")


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: where + which rule + why."""
    path: str
    line: int
    col: int
    code: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "col": self.col,
                "code": self.code, "message": self.message}


class FileContext:
    """Everything a rule gets to see about one file: source, parsed tree,
    and the (posix, repo-relative) path it uses for scoping decisions."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = PurePosixPath(path).as_posix()
        self.source = source
        self.tree = tree

    @classmethod
    def from_source(cls, source: str, path: str) -> "FileContext":
        return cls(path, source, ast.parse(source))

    @property
    def parts(self) -> Tuple[str, ...]:
        return PurePosixPath(self.path).parts

    @property
    def name(self) -> str:
        return PurePosixPath(self.path).name

    def in_dir(self, *names: str) -> bool:
        """True when any path component (not the filename) matches."""
        return any(n in self.parts[:-1] for n in names)

    @property
    def is_test(self) -> bool:
        return self.name.startswith("test_") or self.in_dir("tests")

    def finding(self, node: ast.AST, code: str, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), code, message)


@runtime_checkable
class Rule(Protocol):
    """The plugin protocol: stateless, one instance per registry entry.

    ``check`` yields raw findings; waiver filtering happens in the runner
    so rules never need to know the suppression syntax.
    """
    code: str
    name: str
    description: str

    def check(self, ctx: FileContext) -> Iterable[Finding]: ...


_REGISTRY: Dict[str, Rule] = {}


def register(rule_cls):
    """Class decorator: instantiate and index the rule by its code."""
    rule = rule_cls()
    if not CODE_RE.match(rule.code):
        raise ValueError(f"rule code {rule.code!r} must match HLxxx")
    if rule.code in _REGISTRY:
        raise ValueError(f"duplicate rule code {rule.code}")
    _REGISTRY[rule.code] = rule
    return rule_cls


def all_rules() -> List[Rule]:
    return [_REGISTRY[c] for c in sorted(_REGISTRY)]


def get_rule(code: str) -> Rule:
    return _REGISTRY[code]


def parse_waivers(source: str) -> Dict[int, frozenset]:
    """Map line number -> codes waived there.

    A waiver on a comment-only line also covers the next line, so long
    statements can carry their justification above themselves.  Real
    comment tokens only — a waiver spelled inside a string/docstring
    (like the examples in this module's docstring) does not count.
    """
    waivers: Dict[int, set] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _WAIVER_RE.search(tok.string)
        if not m:
            continue
        lineno = tok.start[0]
        codes = {c.strip() for c in m.group(1).split(",")}
        waivers.setdefault(lineno, set()).update(codes)
        text = lines[lineno - 1] if lineno <= len(lines) else ""
        if text.lstrip().startswith("#"):          # standalone comment line
            waivers.setdefault(lineno + 1, set()).update(codes)
    return {ln: frozenset(cs) for ln, cs in waivers.items()}


def apply_waivers(findings: Iterable[Finding], waivers: Dict[int, frozenset],
                  ) -> Tuple[List[Finding], List[Finding],
                             List[Tuple[int, str]]]:
    """Split findings into (kept, suppressed) and report unused waivers
    as ``(line, code)`` pairs — a stale waiver is itself a smell."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used: set = set()
    for f in findings:
        if f.code in waivers.get(f.line, frozenset()):
            suppressed.append(f)
            used.add((f.line, f.code))
        else:
            kept.append(f)
    unused: List[Tuple[int, str]] = []
    for ln, codes in sorted(waivers.items()):
        for code in sorted(codes):
            # a comment-only waiver registers for two lines; count it used
            # if either registration fired
            if (ln, code) in used or (ln - 1, code) in used \
                    or (ln + 1, code) in used:
                continue
            unused.append((ln, code))
    # the two-line registration of standalone comments would double-report
    seen: set = set()
    deduped: List[Tuple[int, str]] = []
    for ln, code in unused:
        if (ln - 1, code) in seen:
            continue
        seen.add((ln, code))
        deduped.append((ln, code))
    return kept, suppressed, deduped


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set:
    """All bare Name identifiers appearing anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def import_aliases(tree: ast.Module, module: str) -> set:
    """Local aliases bound to ``import <module>`` (e.g. numpy -> {np})."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name.split(".")[0])
    return out


def from_imports(tree: ast.Module, module: str) -> Dict[str, ast.ImportFrom]:
    """Names bound by ``from <module> import x [as y]`` -> their node."""
    out: Dict[str, ast.ImportFrom] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = node
    return out
