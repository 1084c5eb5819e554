"""The port's copy of the batched many-solve planner
(``repro_torch.core.batched``) against the JAX package's original and the
port's scalar engine, and ``pull_scan_torch`` (the twin of
``pull_scan_jax``) against the numpy ``pull_scan``.

Tolerances: the copied numpy solvers must equal the original's results
bit for bit; against the scalar ``run_job`` they hold at 1e-9 (rel and
abs), as ``tests/test_batched.py`` does; ``pull_scan_torch`` in float64
holds the numpy scan at 1e-9 with equal counts, and its autograd gradient
holds central finite differences at ``gradcheck``'s defaults (eps 1e-6,
atol 1e-5, rtol 1e-3). The JAX package (whose ``repro.core`` imports JAX)
is imported inside a fixture, so ``-m gpu`` runs where only torch is
installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batched as t_b
from repro_torch.core.engine import PullSpec, StaticSpec, run_job, run_job_cache_clear
from repro_torch.core.simulator import SimNode

REL = ABS = 1e-9
OVERHEAD = 0.01


@pytest.fixture(scope="module")
def j_b():
    from repro.core import batched
    return batched


def _approx(x):
    return pytest.approx(x, rel=REL, abs=ABS)


def _nodes(speeds, overhead=OVERHEAD):
    return [SimNode.constant(f"n{i}", float(s), overhead)
            for i, s in enumerate(speeds)]


def _pin_row(res, b, speeds, spec, overhead=OVERHEAD):
    """One batched row vs. the port's scalar whole-job solve."""
    run_job_cache_clear()
    nodes = _nodes(speeds, overhead)
    sched = run_job(nodes, [spec])
    summ = sched.stages[0]
    assert res.makespan[b] == _approx(sched.completion)
    assert res.idle[b] == _approx(summ.idle_time)
    for i, nd in enumerate(nodes):
        assert res.node_finish[b, i] == _approx(summ.node_finish[nd.name])
        assert res.executed[b, i] == _approx(summ.work[nd.name])
        assert res.counts[b, i] == summ.counts[nd.name]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


# --------------------------------------------------------------------------
# the copied numpy solvers: equal to the original, pinned to run_job
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,overhead,seed", [(1, 0.0, 0), (3, 0.05, 1), (5, 0.2, 2)])
def test_static_matches_reference_and_scalar(j_b, n, overhead, seed):
    B = 4
    rng = np.random.default_rng(seed)
    sp = rng.uniform(0.2, 3.0, (B, n))
    wk = rng.uniform(0.0, 4.0, (B, n))
    res = t_b.batched_closed_static(sp, wk, overhead)
    _same(res, j_b.batched_closed_static(sp, wk, overhead))
    for b in range(B):
        _pin_row(res, b, sp[b], StaticSpec(works=tuple(wk[b])), overhead)


@pytest.mark.parametrize("n,n_tasks,task_work,overhead,seed",
                         [(1, 1, 0.05, 0.0, 3), (3, 17, 0.7, 0.01, 4),
                          (5, 40, 2.0, 0.2, 5)])
def test_pull_uniform_matches_reference_and_scalar(j_b, n, n_tasks, task_work,
                                                   overhead, seed):
    B = 3
    sp = np.random.default_rng(seed).uniform(0.2, 3.0, (B, n))
    res = t_b.batched_closed_pull(sp, n_tasks, task_work, overhead)
    _same(res, j_b.batched_closed_pull(sp, n_tasks, task_work, overhead))
    for b in range(B):
        _pin_row(res, b, sp[b], PullSpec(n_tasks=n_tasks, task_work=task_work),
                 overhead)


@pytest.mark.parametrize("n,n_tasks,overhead,blocky,seed",
                         [(1, 0, 0.0, False, 6), (4, 29, 0.01, False, 7),
                          (3, 40, 0.2, True, 8), (5, 3, 0.05, False, 9)])
def test_pull_hetero_matches_reference_and_scalar(j_b, n, n_tasks, overhead,
                                                  blocky, seed):
    B = 3
    rng = np.random.default_rng(seed)
    sp = rng.uniform(0.2, 3.0, (B, n))
    if blocky:
        wk = np.repeat(rng.uniform(0.1, 2.0, (B, max(n_tasks // 4, 1))),
                       4, axis=1)[:, :n_tasks]
    else:
        wk = rng.uniform(0.0, 3.0, (B, n_tasks))
    res = t_b.batched_closed_pull_hetero(sp, wk, overhead)
    _same(res, j_b.batched_closed_pull_hetero(sp, wk, overhead))
    for b in range(B):
        _pin_row(res, b, sp[b], PullSpec(works=tuple(wk[b])), overhead)


def test_pull_tie_break_matches_heap_exactly():
    for speeds in ([1.0] * 4, [1.0, 1.0, 2.0, 2.0], [0.5, 0.5]):
        sp = np.tile(speeds, (2, 1))
        res = t_b.batched_closed_pull(sp, 23, 0.7, OVERHEAD, dedup=False)
        run_job_cache_clear()
        nodes = _nodes(speeds)
        summ = run_job(nodes, [PullSpec(n_tasks=23, task_work=0.7)]).stages[0]
        for i, nd in enumerate(nodes):
            assert res.counts[0, i] == summ.counts[nd.name]
            assert res.node_finish[0, i] == _approx(summ.node_finish[nd.name])


def test_empty_batches_broadcasting_and_validation():
    res = t_b.batched_closed_pull_hetero([[1.0, 2.0]], np.empty((1, 0)))
    assert res.makespan[0] == 0.0 and res.counts.sum() == 0
    sp = np.random.default_rng(0).uniform(0.5, 2.0, (6, 3))
    assert t_b.batched_closed_static(
        sp, np.array([3.0, 2.0, 1.0])[None, :]).makespan.shape == (6,)
    with pytest.raises(ValueError):
        t_b.batched_closed_static([[0.0, 1.0]], [[1.0, 1.0]])
    with pytest.raises(ValueError):
        t_b.batched_closed_pull([[1.0]], -1, 1.0)
    with pytest.raises(ValueError):
        t_b.batched_closed_pull_hetero(np.ones((3, 2)), np.ones((2, 5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_matches_reference(j_b, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 3, (17, 2)).astype(float)
    _same(t_b.dedup_rows(key), j_b.dedup_rows(key))
    base_sp = rng.uniform(0.2, 3.0, (4, 3))
    base_wk = rng.uniform(0.0, 2.0, (4, 11))
    idx = rng.integers(0, 4, 13)
    sp, wk = base_sp[idx], base_wk[idx]
    _same(t_b.batched_closed_pull_hetero(sp, wk, OVERHEAD, dedup=True),
          t_b.batched_closed_pull_hetero(sp, wk, OVERHEAD, dedup=False))


@pytest.mark.parametrize("mode", ["hemt", "homt", "oracle"])
def test_plan_capacity_matches_reference(j_b, mode):
    kw = dict(target=20.0, n_range=range(2, 7), samples=60, seed=11, mode=mode)
    a = t_b.plan_capacity([2.0, 1.0, 0.5], 60.0, **kw)
    b = j_b.plan_capacity([2.0, 1.0, 0.5], 60.0, **kw)
    assert (a.chosen, a.quantiles, a.target, a.percentile, a.mode) == \
        (b.chosen, b.quantiles, b.target, b.percentile, b.mode)
    for n in a.makespans:
        assert np.array_equal(a.makespans[n], b.makespans[n])


# --------------------------------------------------------------------------
# pull_scan_torch, the twin of pull_scan_jax
# --------------------------------------------------------------------------

def _grid(seed, B=7, n=4, T=29):
    rng = np.random.default_rng(seed)
    return (np.full((B, n), OVERHEAD), rng.uniform(0.2, 3.0, (B, n)),
            rng.uniform(0.0, 3.0, (B, T)))


@pytest.mark.parametrize("shape", [(7, 4, 29), (1, 4, 2), (3, 1, 5), (2, 3, 0)],
                         ids=["scan", "k_lt_n", "one_node", "no_tasks"])
def test_pull_scan_torch_matches_numpy(shape):
    oh, sp, wk = _grid(3, *shape)
    ne, ct, ex = t_b.pull_scan(oh, sp, wk)
    tne, tct, tex = t_b.pull_scan_torch(torch.tensor(oh), torch.tensor(sp),
                                        torch.tensor(wk))
    assert tne.dtype == torch.float64 and tex.dtype == torch.float64
    np.testing.assert_allclose(tne.numpy(), ne, rtol=REL, atol=ABS)
    assert np.array_equal(tct.numpy(), ct)
    np.testing.assert_allclose(tex.numpy(), ex, rtol=REL, atol=ABS)


def test_pull_scan_torch_ties_take_the_first_node():
    sp = np.tile([1.0, 1.0, 2.0, 2.0], (2, 1))
    wk = np.full((2, 23), 0.7)
    oh = np.full_like(sp, OVERHEAD)
    ne, ct, _ = t_b.pull_scan(oh, sp, wk)
    tne, tct, _ = t_b.pull_scan_torch(torch.tensor(oh), torch.tensor(sp),
                                      torch.tensor(wk))
    assert np.array_equal(tct.numpy(), ct)
    np.testing.assert_allclose(tne.numpy(), ne, rtol=REL, atol=ABS)


def test_pull_scan_torch_keeps_dtype_and_writes_no_argument():
    oh, sp, wk = (torch.tensor(a, dtype=torch.float32) for a in _grid(4))
    before = [t.clone() for t in (oh, sp, wk)]
    ne, ct, ex = t_b.pull_scan_torch(oh, sp, wk)
    assert ne.dtype == ex.dtype == torch.float32 and ct.dtype == torch.int64
    for a, b in zip((oh, sp, wk), before):
        assert torch.equal(a, b)


def test_pull_scan_torch_gradient_matches_finite_differences():
    oh, sp, wk = _grid(5, B=3, n=3, T=11)
    oh = torch.tensor(oh)
    sp = torch.tensor(sp, requires_grad=True)
    wk = torch.tensor(wk, requires_grad=True)

    def finish(s, w):
        return t_b.pull_scan_torch(oh, s, w)[0]

    assert torch.autograd.gradcheck(finish, (sp, wk))
    makespan = finish(sp, wk).amax(dim=1).sum()
    makespan.backward()
    assert torch.isfinite(wk.grad).all() and torch.isfinite(sp.grad).all()
    assert (wk.grad >= 0).all() and (sp.grad <= 0).all()


def test_pull_scan_torch_matches_reference_twin_shape(j_b):
    """The numpy scans of both packages agree bit for bit, and the torch
    twin holds them on the reference test's grid (seed 3, 7 x 4 x 29)."""
    oh, sp, wk = _grid(3)
    _same(t_b.pull_scan(oh, sp, wk), j_b.pull_scan(oh, sp, wk))
    ne = j_b.pull_scan(oh, sp, wk)[0]
    tne = t_b.pull_scan_torch(torch.tensor(oh), torch.tensor(sp),
                              torch.tensor(wk))[0]
    np.testing.assert_allclose(tne.numpy(), ne, rtol=REL, atol=ABS)


@pytest.mark.gpu
def test_pull_scan_torch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    B, n, T = 1000, 8, 256
    sp = rng.uniform(0.2, 3.0, (B, n))
    wk = rng.uniform(0.0, 3.0, (B, T))
    oh = np.full((B, n), OVERHEAD)
    ne, ct, ex = t_b.pull_scan(oh, sp, wk)
    dev = torch.device("cuda")
    tne, tct, tex = t_b.pull_scan_torch(torch.tensor(oh, device=dev),
                                        torch.tensor(sp, device=dev),
                                        torch.tensor(wk, device=dev))
    assert tne.device.type == "cuda"
    np.testing.assert_allclose(tne.cpu().numpy(), ne, rtol=REL, atol=ABS)
    assert np.array_equal(tct.cpu().numpy(), ct)
    np.testing.assert_allclose(tex.cpu().numpy(), ex, rtol=REL, atol=ABS)
