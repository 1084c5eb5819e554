"""hemt-lint for the port (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU.

A table of ``tests/test_analysis.py``'s fixture snippets goes through both
linters' ``lint_source``, the reference's at a ``src/repro/...`` path and
the port's at the same path under ``src/repro_torch/...``: the same
``(line, col, code)`` findings, suppressions and unused waivers (HL001,
HL002's numpy and stdlib cases, HL003, HL004, HL006, the waivers). Then
the port's own rules where they differ: HL001's scope, HL002 on torch's
global generator, HL005 inside torch's tracing entry points, each firing
and not; the waiver syntax, ``--select``, ``--list-rules``, the JSON
report and the exit codes 0/1/2 of the CLI; and the self-check of
``src/repro_torch``, clean with no waiver.
"""
import json
import textwrap

import pytest

from repro_torch.analysis import (Finding, Rule, all_rules, get_rule, lint_source,
                                  parse_waivers, self_check)
from repro_torch.analysis.lint import lint_paths, main

CORE = "src/repro_torch/core/fixture.py"
BATCHED = "src/repro_torch/core/batched.py"
KERNEL = "src/repro_torch/kernels/fixture.py"
RUNTIME = "src/repro_torch/runtime/fixture.py"
MODELS = "src/repro_torch/models/fixture.py"


@pytest.fixture(scope="module")
def ref():
    """The reference linter (standard library only, like the port's)."""
    from repro.analysis import lint_source as ref_lint_source
    from repro.analysis.lint import main as ref_main
    return ref_lint_source, ref_main


def codes(source, path=CORE, select=None):
    return [f.code for f in lint_source(textwrap.dedent(source), path, select).findings]


def run(source, path=CORE, select=None):
    return lint_source(textwrap.dedent(source), path, select)


def _ref_path(path):
    return path.replace("src/repro_torch/", "src/repro/")


# --------------------------------------------------------------------------
# the twin table: tests/test_analysis.py's snippets through both linters
# --------------------------------------------------------------------------

TWINS = {
    "hl001_unfrozen_root": ("""
        from dataclasses import dataclass

        @dataclass
        class PullSpec:
            n_tasks: int = 0
    """, CORE),
    "hl001_frozen_clean": ("""
        from dataclasses import dataclass
        from typing import Tuple

        @dataclass(frozen=True)
        class PullSpec:
            works: Tuple[float, ...] = ()
    """, CORE),
    "hl001_unhashable_fields": ("""
        from dataclasses import dataclass, field
        from typing import List
        import numpy as np

        @dataclass(frozen=True)
        class StaticSpec:
            works: List[float] = field(default_factory=list)
            grid: np.ndarray = None
    """, CORE),
    "hl001_closure": ("""
        from dataclasses import dataclass
        from typing import Optional

        @dataclass
        class Inner:
            x: int = 0

        @dataclass(frozen=True)
        class ReplayTrace:
            inner: Optional[Inner] = None
    """, CORE),
    "hl001_non_spec": ("""
        from dataclasses import dataclass
        from typing import List

        @dataclass
        class StageReport:
            rows: List[float] = None
    """, CORE),
    "hl001_tests_exempt": ("""
        from dataclasses import dataclass

        @dataclass
        class PullSpec:
            n_tasks: int = 0
    """, "tests/test_x.py"),
    "hl002_legacy_stdlib_unseeded": ("""
        import random
        import numpy as np
        from numpy.random import seed

        def sample(xs):
            np.random.seed(0)
            random.shuffle(xs)
            rng = np.random.default_rng()
            return rng
    """, CORE),
    "hl002_seeded_clean": ("""
        import numpy as np

        def _rng(seed: int) -> np.random.Generator:
            return np.random.default_rng(seed)

        def jitter(seed, n):
            return np.random.default_rng(int(seed)).normal(size=n)
    """, CORE),
    "hl002_runtime": ("""
        import numpy as np
        def f():
            return np.random.rand(3)
    """, RUNTIME),
    "hl002_workloads": ("""
        import numpy as np
        def f():
            return np.random.rand(3)
    """, "src/repro_torch/workloads/fixture.py"),
    "hl002_models_out_of_scope": ("""
        import numpy as np
        def f():
            return np.random.rand(3)
    """, MODELS),
    "hl002_numpy_random_module_import": ("""
        from numpy import random as npr

        def f(seed):
            npr.seed(seed)
            return npr.default_rng(seed)
    """, CORE),
    "hl003_time_datetime": ("""
        import time
        import datetime
        from time import perf_counter
        from datetime import datetime as dt

        def stamp():
            return (time.time(), perf_counter(), dt.now(),
                    datetime.datetime.utcnow())
    """, CORE),
    "hl003_sim_clock_clean": ("""
        def advance(clock: float, dt: float) -> float:
            return clock + dt
    """, CORE),
    "hl003_benchmarks_exempt": ("""
        import time
        def bench():
            return time.time()
    """, "benchmarks/bench_x.py"),
    "hl004_literal_and_annotation": ("""
        def solve(a: float, b, w):
            if a == b:                 # annotated param
                return 1
            return (w != 0.0)          # float literal
    """, CORE),
    "hl004_dataclass_field": ("""
        from dataclasses import dataclass

        @dataclass(frozen=True)
        class TaskSpec:
            weight: float = 0.0

        def route(t, u):
            return t.weight == u.weight
    """, CORE),
    "hl004_known_engine_attr": ("""
        def route(t, m):
            return t.io_mb != m
    """, "src/repro_torch/core/engine.py"),
    "hl004_tolerant_clean": ("""
        EPS = 1e-9

        def close(a: float, b: float) -> bool:
            return abs(a - b) <= EPS

        def count_eq(n: int) -> bool:
            return n == 0
    """, CORE),
    "hl004_runtime_out_of_scope": ("""
        def f(a: float):
            return a == 0.5
    """, RUNTIME),
    "hl006_param_stores": ("""
        import numpy as np

        def _closed_form_static(speeds, works):
            works[0] = 0.0
            speeds += 1.0
            works.sort()
            return works

        def batched_closed_pull(works):
            wk = np.asarray(works)       # asarray aliases, taint survives
            wk[0] = 1.0
            return wk
    """, "src/repro_torch/core/engine.py"),
    "hl006_copy_clean": ("""
        import numpy as np

        def _closed_form_static(speeds, works):
            works = np.array(works)      # fresh copy: taint cleared
            works[0] = 0.0
            counts = np.zeros(3)
            counts[1] += 1               # local, never parameter storage
            return works, counts

        def helper_not_a_solver(xs):
            xs[0] = 1                    # outside the solver prefixes
            return xs
    """, "src/repro_torch/core/engine.py"),
    "hl006_batched": ("""
        def _closed_form_static(works):
            works[0] = 1.0
            return works
    """, BATCHED),
    "hl006_core_out_of_scope": ("""
        def _closed_form_static(works):
            works[0] = 1.0
            return works
    """, CORE),
    "waiver_inline_and_standalone": ("""
        def solve(a: float, b: float):
            x = a == b  # hemt-lint: disable=HL004  exact sentinel
            # hemt-lint: disable=HL004  covers the next line
            y = a != b
            return x, y
    """, CORE),
    "waiver_wrong_code": ("""
        def solve(a: float, b: float):
            return a == b  # hemt-lint: disable=HL001
    """, CORE),
    "waiver_unused": ("""
        def clean():
            return 0  # hemt-lint: disable=HL004
    """, CORE),
    "syntax_error": ("def broken(:\n", CORE),
}


def _summary(report):
    return ([(f.line, f.col, f.code) for f in report.findings],
            [(f.line, f.col, f.code) for f in report.suppressed],
            [(ln, code) for _, ln, code in report.unused_waivers],
            report.exit_code)


@pytest.mark.parametrize("case", sorted(TWINS))
def test_findings_match_the_reference_linter(ref, case):
    source, path = TWINS[case]
    src = textwrap.dedent(source)
    got = _summary(lint_source(src, path))
    want = _summary(ref[0](src, _ref_path(path)))
    assert got == want
    if case.startswith("hl"):
        assert case.endswith(("clean", "exempt", "out_of_scope", "non_spec")) == (got[0] == [])


def test_twin_table_fires_every_shared_rule(ref):
    fired = {code for source, path in TWINS.values()
             for _, _, code in _summary(lint_source(textwrap.dedent(source), path))[0]}
    assert fired == {"HL000", "HL001", "HL002", "HL003", "HL004", "HL006"}


def test_select_matches_the_reference(ref):
    src = textwrap.dedent("""
        import time
        def solve(a: float, b: float):
            return a == b, time.time()  # hemt-lint: disable=HL004  exactness note
    """)
    for select in (["HL002"], ["HL003"], ["HL004"], None):
        assert _summary(lint_source(src, CORE, select)) == \
            _summary(ref[0](src, _ref_path(CORE), select))


def test_cli_json_matches_the_reference(ref, tmp_path, capsys):
    """The same tree, one copy under ``src/repro`` and one under
    ``src/repro_torch``: both CLIs exit 1 with the same JSON but for the
    paths."""
    bad = textwrap.dedent("""
        import time
        import numpy as np
        def f(a: float):
            return a == 0.0, time.perf_counter(), np.random.rand(2)
    """).lstrip("\n")
    payloads = []
    for pkg, cli in (("repro", ref[1]), ("repro_torch", main)):
        p = tmp_path / "src" / pkg / "core" / "bad.py"
        p.parent.mkdir(parents=True)
        p.write_text(bad, encoding="utf-8")
        assert cli(["--format=json", str(tmp_path / "src" / pkg)]) == 1
        payload = json.loads(capsys.readouterr().out)
        for f in payload["findings"]:
            f["path"] = f["path"].replace(f"/src/{pkg}/", "/src/PKG/")
        payloads.append(payload)
    assert payloads[0] == payloads[1]
    assert payloads[1]["counts"] == {"HL002": 1, "HL003": 1, "HL004": 1}


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_registry_has_the_reference_rules(ref):
    from repro.analysis import all_rules as ref_rules
    got = [(r.code, r.name) for r in all_rules()]
    assert got == [(r.code, r.name) for r in ref_rules()]
    assert [c for c, _ in got] == ["HL001", "HL002", "HL003", "HL004", "HL005", "HL006"]
    for rule in all_rules():
        assert isinstance(rule, Rule) and rule.description
        assert get_rule(rule.code) is rule


# --------------------------------------------------------------------------
# HL001's scope is the port's package
# --------------------------------------------------------------------------

def test_hl001_scope_is_repro_torch():
    src = """
        from dataclasses import dataclass

        @dataclass
        class PullSpec:
            n_tasks: int = 0
    """
    assert codes(src, CORE) == ["HL001"]
    assert codes(src, "src/repro/core/fixture.py") == []


# --------------------------------------------------------------------------
# HL002 on torch's generators
# --------------------------------------------------------------------------

def test_hl002_torch_global_rng_flagged():
    out = run("""
        import torch
        import torch as th
        from torch import randn

        def sample(x, g):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(1)
            torch.seed()
            torch.random.seed()
            g.seed()
            a = torch.rand(3)
            b = th.randperm(5)
            c = torch.randint(0, 5, (3,))
            d = randn(2)
            x.normal_()
            e = torch.multinomial(x, 2)
            return a, b, c, d, e
    """)
    assert [f.line for f in out.findings] == list(range(7, 18))
    assert {f.code for f in out.findings} == {"HL002"}
    assert "process-global" in out.findings[0].message
    assert "entropy" in out.findings[2].message


def test_hl002_explicit_torch_generator_clean():
    assert codes("""
        import numpy as np
        import torch

        def sample(x, seed: int):
            g = torch.Generator().manual_seed(seed)
            a = torch.rand(3, generator=g)
            b = torch.randn((2, 2), generator=g, dtype=torch.float64)
            x.uniform_(0.0, 1.0, generator=g)
            torch.nn.init.normal_(x, generator=g)
            return a, b, np.random.default_rng(seed).random(3)
    """) == []


def test_hl002_torch_scope_and_numpy_seed_reported_once():
    src = """
        import torch
        def f():
            return torch.rand(3)
    """
    assert codes(src, RUNTIME) == ["HL002"]
    assert codes(src, "src/repro_torch/workloads/fixture.py") == ["HL002"]
    assert codes(src, MODELS) == []
    assert codes(src, "tests/test_x.py") == []
    # np.random.seed is the numpy check's one finding, not also a torch one
    assert codes("""
        import numpy as np
        import random
        def f():
            np.random.seed(0)
            random.seed(1)
    """) == ["HL002", "HL002"]


# --------------------------------------------------------------------------
# HL005 inside torch's tracing entry points
# --------------------------------------------------------------------------

def test_hl005_compiled_function_flagged():
    out = run("""
        import torch

        @torch.compile
        def f(x):
            if x.sum() > 0:
                return x
            return -x
    """, KERNEL)
    assert [f.code for f in out.findings] == ["HL005"]
    assert "if" in out.findings[0].message and "'f'" in out.findings[0].message


def test_hl005_every_entry_point_traces():
    out = run("""
        import functools
        import torch
        from torch import compile as tc
        from torch.func import vmap

        @torch.compile(mode="reduce-overhead")
        def a(x):
            return x.item()

        @functools.partial(torch.compile, fullgraph=True)
        def b(x):
            return float(x)

        @torch.jit.script
        def c(x):
            return torch.nonzero(x)

        def d(x):
            return torch.masked_select(x, x > 0)

        def e(x):
            return torch.unique_consecutive(x)

        def f(x):
            return torch.where(x > 0)

        def g(x):
            while x.sum() > 0:
                x = x - 1
            return x

        def h(x):
            assert x.min() >= 0
            return x

        def i(x):
            return x.item()

        run_d = torch.vmap(d)
        run_e = vmap(functools.partial(e))
        run_f = torch.jit.trace(f, (torch.ones(2),))
        run_g = torch.fx.symbolic_trace(g)
        run_h = torch.export.export(h, (torch.ones(2),))
        run_i = torch.cuda.make_graphed_callables(i, (torch.ones(2),))
        alias = a
        run_a = tc(alias)
    """, KERNEL)
    traced = sorted(f.message.split("'")[-2] for f in out.findings)
    assert traced == list("abcdefghi")
    assert {f.code for f in out.findings} == {"HL005"}


def test_hl005_nested_functions_trace_too():
    out = run("""
        import torch

        def outer(xs):
            def step(x):
                return int(x)
            return torch.func.vmap(step)(xs)

        @torch.compile
        def compiled(x):
            def inner(y):
                return y.item()
            return inner(x)
    """, BATCHED)
    assert sorted(f.message.split("'")[-2] for f in out.findings) == ["inner", "step"]


def test_hl005_untraced_and_static_clean():
    assert codes("""
        import jax
        import torch
        from torch.utils.checkpoint import checkpoint

        def plain(x):
            if x.sum() > 0:              # never traced: no entry point
                return x.item()
            return torch.nonzero(x)

        @torch.compile
        def kernel(x, *, n_chunks: int, mask=None):
            if n_chunks > 1:             # kw-only params are static
                return x
            if mask is None:             # an is-None test is static
                return x
            return x

        def eager(x):
            return x.item()

        out = checkpoint(eager, torch.ones(2), use_reentrant=False)

        @jax.jit                         # JAX's entries are the reference's rule
        def f(x):
            return x.item()
    """, KERNEL) == []


def test_hl005_scope_is_kernels_and_batched():
    src = """
        import torch

        @torch.compile
        def f(x):
            return x.item()
    """
    assert codes(src, CORE) == []
    assert codes(src, BATCHED) == ["HL005"]
    assert codes(src, KERNEL) == ["HL005"]
    assert codes(src, "tests/test_x.py") == []


# --------------------------------------------------------------------------
# waivers and the CLI
# --------------------------------------------------------------------------

def test_waivers_suppress_and_stale_ones_fail():
    out = run("""
        import torch
        def solve(a: float, b: float):
            x = torch.rand(2)  # hemt-lint: disable=HL002  fixture draw
            # hemt-lint: disable=HL004  covers the next line
            y = a != b
            return x, y  # hemt-lint: disable=HL003
    """, RUNTIME)
    assert out.findings == [] and len(out.suppressed) == 1
    assert [(ln, c) for _, ln, c in out.unused_waivers] == [(5, "HL004"), (7, "HL003")]
    assert out.exit_code == 1
    assert parse_waivers('msg = "# hemt-lint: disable=HL004"\n') == {}
    assert run("""
        import torch
        def f():
            return torch.rand(2)  # hemt-lint: disable=HL002
    """, RUNTIME, select=["HL004"]).unused_waivers == []


def _write(tmp_path, rel, source):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source).lstrip("\n"), encoding="utf-8")
    return p


def test_cli_exit_codes_select_and_list_rules(tmp_path, capsys):
    root = tmp_path / "src" / "repro_torch"
    _write(tmp_path, "src/repro_torch/runtime/bad.py", """
        import time
        import torch
        def f():
            return torch.randn(3), time.time()
    """)
    assert main([str(root)]) == 1
    text = capsys.readouterr().out
    assert "bad.py:4:" in text and "HL002" in text and "HL003" in text
    assert "2 finding(s), 0 waived, 0 unused waiver(s) in 1 file(s)" in text
    assert main(["--select", "HL003", str(root)]) == 1
    assert "HL002" not in capsys.readouterr().out
    assert main(["--select", "HL005", str(root)]) == 0
    capsys.readouterr()
    assert main(["--select", "XY1", str(root)]) == 2          # usage error
    assert main(["--no-such-flag"]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in listed] == [r.code for r in all_rules()]
    _write(tmp_path, "src/repro_torch/runtime/bad.py", "x = 1\n")
    _write(tmp_path, "src/repro_torch/core/__pycache__/junk.py", "import random\n")
    assert main([str(root)]) == 0
    assert lint_paths([str(root)]).files_checked == 1


def test_cli_json_report_and_output(tmp_path, capsys):
    _write(tmp_path, "src/repro_torch/core/bad.py", """
        import torch
        def f():
            torch.manual_seed(0)
    """)
    out_file = tmp_path / "hemt-lint.json"
    assert main(["--format=json", "--output", str(out_file),
                 str(tmp_path / "src" / "repro_torch")]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["version"] == 1 and payload["files_checked"] == 1
    assert payload["counts"] == {"HL002": 1}
    assert payload["findings"][0]["line"] == 3 and payload["suppressed"] == 0
    assert payload["unused_waivers"] == []
    assert json.loads(out_file.read_text()) == payload


def test_default_path_is_the_port(monkeypatch, capsys):
    from repro_torch.analysis.lint import repo_root
    monkeypatch.chdir(repo_root())
    assert main([]) == 0
    assert "0 finding(s), 0 waived, 0 unused waiver(s)" in capsys.readouterr().out


def test_finding_is_ordered_and_formattable():
    a = Finding("a.py", 1, 0, "HL001", "x")
    b = Finding("a.py", 2, 0, "HL001", "x")
    assert a < b and a.format() == "a.py:1:0: HL001 x"
    assert a.to_json()["code"] == "HL001"


# --------------------------------------------------------------------------
# the port's self-check
# --------------------------------------------------------------------------

def test_port_tree_is_clean_with_no_waiver():
    report = self_check()
    assert report.files_checked > 80
    msgs = [f.format() for f in report.findings]
    assert msgs == [], "hemt-lint violations in src/repro_torch:\n" + "\n".join(msgs)
    assert report.suppressed == [] and report.unused_waivers == []
    assert report.exit_code == 0
