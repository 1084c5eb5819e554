"""The example twins (``examples/*_torch.py``) against the reference's
examples, each run in this process on the CPU: serve_hemt, pagerank_hemt
and fleet_serving print the reference's lines exactly; kmeans_hemt the
same schedule, with its centroid error against the port's own oracle;
burstable_hemt the same schedule (makespans, idle, grain counts) from
other random weights, so other losses. A plumbing test of the demos, as
tests/test_torch_quickstart.py is of the quickstart: the pieces they drive
are held to the reference by their own twins. The reference's examples
import JAX, so they are loaded inside the CPU tests only."""
import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, name, argv=None):
    mod = _load(name)
    mod.main() if argv is None else mod.main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name, argv", [
    ("serve_hemt", ["--device", "cpu"]),
    ("pagerank_hemt", ["--device", "cpu"]),
    ("fleet_serving", None),
])
def test_twin_prints_the_references_lines(capsys, name, argv):
    want = _lines(capsys, name)
    got = _lines(capsys, f"{name}_torch", argv)
    assert len(got) >= 4 and got == want


def test_kmeans_twin_schedules_as_the_reference(capsys):
    want = _lines(capsys, "kmeans_hemt")
    got = _lines(capsys, "kmeans_hemt_torch", ["--device", "cpu"])
    assert len(got) == len(want) == 7
    assert got[0] == want[0] and got[-1] == want[-1]
    for g, w in zip(got[1:5], want[1:5]):
        assert g.split()[:3] == w.split()[:3]          # mode, finish_s, mean_idle_s
        assert float(g.split()[3]) < 1e-4               # centroids against the oracle


def test_burstable_twin_schedules_as_the_reference(capsys):
    want = _lines(capsys, "burstable_hemt")
    got = _lines(capsys, "burstable_hemt_torch", ["--device", "cpu"])
    assert len(got) == len(want)
    steps = [i for i, ln in enumerate(want) if ln.startswith("step")]
    assert len(steps) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        if i in steps:
            gs, ws = g.split(), w.split()
            assert gs[:3] + gs[4:] == ws[:3] + ws[4:]     # all but the loss
            assert 0.0 < float(gs[3]) < 10.0
        else:
            assert g == w


@pytest.mark.gpu
def test_twins_run_on_card(capsys):
    """The four twins that compute on the card, at their default sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, argv in (("serve_hemt_torch", []), ("kmeans_hemt_torch", []),
                       ("pagerank_hemt_torch", []), ("burstable_hemt_torch", ["--steps", "4"])):
        out = _lines(capsys, name, argv)
        assert out and out[-1].strip(), name


def test_twins_import_nothing_of_jax_or_the_reference():
    import ast
    names = sorted(n for n in os.listdir(os.path.join(HERE, "..", "examples"))
                   if n.endswith("_torch.py"))
    assert len(names) == 6
    for name in names:
        path = os.path.join(HERE, "..", "examples", name)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "repro"}.intersection(roots), (name, node.lineno)
