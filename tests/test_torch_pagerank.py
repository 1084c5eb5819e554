"""PageRank (paper Fig 18): the port's job against the JAX package's on the
same graph, on the CPU. Ownership, bucket sizes, stage reports and the
virtual finish time must be equal exactly; the float32 ranks within the
reference's own 1e-6 (the sums run in another order).

Twins of tests/test_workloads.py's three PageRank tests and of the
PageRank halves of tests/test_oa_hemt.py (adaptive) and
tests/test_speculation.py (mitigation), plus the card's job against the
CPU's (``-m gpu``). The JAX side is imported inside a fixture, so
``-m gpu`` runs where only torch is installed.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import engine as t_engine
from repro_torch.core import simulator as t_sim
from repro_torch.core import speculation as t_spec
from repro_torch.launch import pagerank as demo
from repro_torch.workloads import pagerank as t_pr

ATOL = 1e-6     # tests/test_workloads.py::test_pagerank_partitioning_invariance


@pytest.fixture(scope="module")
def jx():
    from repro.core import engine, simulator, speculation
    from repro.workloads import pagerank
    return SimpleNamespace(engine=engine, sim=simulator, spec=speculation, pr=pagerank)


def _nodes(sim, speeds=(1.0, 0.4), overhead=0.05):
    return [sim.SimNode.constant(f"e{i}", s, overhead) for i, s in enumerate(speeds)]


def _twins(jx, n, deg, seed, iters, speeds=(1.0, 0.4), overhead=0.05, **kw):
    """Runs the reference's job and the port's on one graph; checks that
    ownership, stage reports and finish time agree exactly and the ranks
    within ATOL. Returns (reference job, port job, port ranks)."""
    src, dst = jx.pr.random_graph(n, deg, seed=seed)
    t_src, t_dst = t_pr.random_graph(n, deg, seed=seed)
    assert np.array_equal(src, t_src) and np.array_equal(dst, t_dst)
    j_kw = {k: v(jx.engine, jx.spec) if callable(v) else v for k, v in kw.items()}
    t_kw = {k: v(t_engine, t_spec) if callable(v) else v for k, v in kw.items()}
    jjob = jx.pr.PageRankJob(src, dst, n, _nodes(jx.sim, speeds, overhead), **j_kw)
    tjob = t_pr.PageRankJob(src, dst, n, _nodes(t_sim, speeds, overhead), device="cpu",
                            **t_kw)
    assert tjob.owner.dtype == jjob.owner.dtype
    assert np.array_equal(tjob.owner, jjob.owner)
    want, got = jjob.run(iters), tjob.run(iters)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ATOL)
    assert [dataclasses.astuple(r) for r in tjob.reports] == \
        [dataclasses.astuple(r) for r in jjob.reports]
    assert tjob.total_time() == jjob.total_time()
    return jjob, tjob, got


@pytest.mark.parametrize("mode,kw", [("hemt", {"weights": [1.0, 0.4]}), ("even", {}),
                                     ("homt", {"n_tasks": 16})], ids=["hemt", "even", "homt"])
def test_pagerank_partitioning_invariance(jx, mode, kw):
    _, _, got = _twins(jx, 300, 5, 2, 10, mode=mode, **kw)
    ref = t_pr.pagerank_reference(*t_pr.random_graph(300, 5, seed=2), 300, 10, device="cpu")
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(ref, jx.pr.pagerank_reference(
        *jx.pr.random_graph(300, 5, seed=2), 300, iters=10), atol=ATOL)
    assert got.sum() == pytest.approx(1.0, abs=0.2)


def test_pagerank_skewed_buckets_match_capacity(jx):
    _, tjob, _ = _twins(jx, 4000, 4, 0, 1, mode="hemt", weights=[1.0, 0.4])
    sizes = np.bincount(tjob.owner, minlength=2)
    assert sizes[0] / sizes.sum() == pytest.approx(1.0 / 1.4, abs=0.02)


def test_pagerank_hemt_beats_homt_short_stages(jx):
    """Fig 18: short iterations + overhead -> microtasking loses."""
    t = {}
    for mode, kw in (("hemt", {"weights": [1.0, 0.4]}),
                     ("homt", {"n_tasks": 32}), ("even", {})):
        _, tjob, _ = _twins(jx, 3000, 4, 4, 10, overhead=0.1, mode=mode, **kw)
        t[mode] = tjob.total_time()
    assert t["hemt"] < t["homt"] and t["hemt"] < t["even"]


def test_pagerank_adaptive_keeps_math_and_speeds_schedule(jx):
    _, stale, _ = _twins(jx, 400, 4, 1, 5, overhead=0.02, mode="hemt")
    _, adapt, _ = _twins(jx, 400, 4, 1, 5, overhead=0.02, mode="hemt",
                         adaptive=lambda engine, spec: engine.AdaptivePlan())
    assert adapt.total_time() < stale.total_time()


def test_pagerank_job_threads_mitigation(jx):
    kw = dict(speeds=(1.0, 1.0, 0.25), overhead=0.01, mode="hemt",
              weights=[1.0, 1.0, 1.0], work_per_edge=2e-3)
    _, plain, ranks_plain = _twins(jx, 300, 4, 3, 3, **kw)
    _, mitigated, ranks_mit = _twins(
        jx, 300, 4, 3, 3, mitigation=lambda engine, spec: spec.WorkStealing(grain=0.05), **kw)
    assert mitigated.total_time() < plain.total_time()
    np.testing.assert_allclose(ranks_mit, ranks_plain, rtol=1e-6)


def test_pagerank_accepts_tensors_and_matches_float64_oracle():
    """Edges given as tensors; ranks against a float64 numpy oracle
    (np.bincount with weights), the check the card run makes at scale."""
    n, iters = 500, 10
    src, dst = t_pr.random_graph(n, 6, seed=5)
    job = t_pr.PageRankJob(torch.from_numpy(src), torch.from_numpy(dst), n,
                           _nodes(t_sim), mode="hemt", weights=[1.0, 0.4], device="cpu")
    got = job.run(iters)
    deg = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    ranks = np.full(n, 1.0 / n)
    for _ in range(iters):
        ranks = 0.15 / n + 0.85 * np.bincount(dst, weights=(ranks / deg)[src], minlength=n)
    rel_l2 = np.linalg.norm(got - ranks) / np.linalg.norm(ranks)
    assert rel_l2 < 1e-6, rel_l2


def test_demo_prints_modes_with_hemt_first(capsys):
    demo.main(["--device", "cpu", "--n", "2000", "--iters", "5"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["mode"] for ln in lines[:4]] == ["hemt", "even", "homt-16", "homt-64"]
    finish = {ln["mode"]: ln["finish_s"] for ln in lines[:4]}
    assert finish["hemt"] < finish["even"]
    assert all(ln["rank_err"] <= ATOL for ln in lines[:4])
    assert sum(lines[0]["owned_vertices"]) == 2000
    assert lines[4]["hemt_vs_even_pct"] > 0 and lines[4]["hemt_vs_best_homt_pct"] > 0


def test_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = t_pr.random_graph(50, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_pr.PageRankJob(src, dst, 50, _nodes(t_sim))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_pr.pagerank_reference(src, dst, 50, 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        demo.main(["--n", "50", "--iters", "1"])


@pytest.mark.gpu
def test_pagerank_on_card_matches_cpu():
    """The card's job (ownership through the Hopper kernel, atomic
    index_add_) against the CPU's on one graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import skewed_bucket as sb

    src, dst = t_pr.random_graph(3000, 8, seed=6)
    jobs = {}
    for dev in ("cpu", "cuda"):
        before = sb.launches
        jobs[dev] = t_pr.PageRankJob(src, dst, 3000, _nodes(t_sim), mode="hemt",
                                     weights=[1.0, 0.4], device=dev)
        assert sb.launches == before + (dev == "cuda")
    cpu, card = jobs["cpu"], jobs["cuda"]
    assert np.array_equal(card.owner, cpu.owner)
    np.testing.assert_allclose(card.run(10), cpu.run(10), atol=ATOL)
    assert [dataclasses.astuple(r) for r in card.reports] == \
        [dataclasses.astuple(r) for r in cpu.reports]
    assert card.total_time() == cpu.total_time()
