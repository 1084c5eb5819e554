"""K-Means (paper Fig 17): the port's job against the JAX package's on the
same points, on the CPU. Iteration reports and the virtual finish time
must be equal exactly; the float32 centroids within 1e-5 (the reference
sums in float32, the port in float64).

Twins of tests/test_workloads.py's two K-Means tests and of the K-Means
half of tests/test_oa_hemt.py (adaptive), plus the card's job against the
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
from repro_torch.launch import kmeans as demo
from repro_torch.workloads import kmeans as t_km

torch.set_num_threads(2)

CROSS_ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    from repro.core import engine, simulator
    from repro.workloads import kmeans
    return SimpleNamespace(engine=engine, sim=simulator, km=kmeans)


def _nodes(sim, speeds=(1.0, 0.4), overhead=0.05):
    return [sim.SimNode.constant(f"e{i}", s, overhead) for i, s in enumerate(speeds)]


# --- twins of tests/test_workloads.py -------------------------------------

def test_kmeans_partitioning_invariance():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(400, 4))
    ref = t_km.kmeans_reference(pts, k=5, iters=8, seed=3, device="cpu")
    job = t_km.KMeansJob(pts, 5, _nodes(t_sim), mode="hemt", weights=[1.0, 0.4], seed=3,
                         device="cpu")
    got = job.run(8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_kmeans_hemt_faster_than_even():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(1400, 4))
    times = {}
    for mode, kw in (("hemt", {"weights": [1.0, 0.4]}),
                     ("even", {}), ("homt", {"n_tasks": 16})):
        job = t_km.KMeansJob(pts, 4, _nodes(t_sim), mode=mode, seed=1, device="cpu", **kw)
        job.run(6)
        times[mode] = job.total_time()
    assert times["hemt"] < times["even"]
    assert times["hemt"] < times["homt"]     # per-task overhead regime


# --- twin of the K-Means half of tests/test_oa_hemt.py ----------------------

def test_kmeans_adaptive_keeps_math_and_speeds_schedule():
    rng = np.random.default_rng(3)
    nodes = [t_sim.SimNode.constant(f"n{i}", s, 0.02) for i, s in enumerate([1.0, 0.4])]
    pts = rng.normal(size=(200, 2))
    stale = t_km.KMeansJob(pts, 3, nodes, mode="hemt", seed=0, device="cpu")
    stale.run(5)
    adapt = t_km.KMeansJob(pts, 3, nodes, mode="hemt", seed=0,
                           adaptive=t_engine.AdaptivePlan(), device="cpu")
    cent = adapt.run(5)
    assert np.allclose(cent.numpy(), t_km.kmeans_reference(pts, 3, 5, seed=0, device="cpu"),
                       atol=1e-5)
    assert adapt.total_time() < stale.total_time()


# --- across packages ----------------------------------------------------------

MODES = [("hemt", {"weights": [1.0, 0.4]}), ("even", {}), ("homt", {"n_tasks": 8}),
         ("homt", {"n_tasks": 32}), ("hemt", {})]


@pytest.mark.parametrize("mode,kw", MODES, ids=lambda v: str(v))
def test_kmeans_job_matches_reference_job(jx, mode, kw):
    """Fig 17's setting at a small size: the same points, seed and nodes in
    both packages give the same initial draw, centroids within 1e-5 and
    identical iteration reports and finish times."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2000, 8))
    jjob = jx.km.KMeansJob(pts, 8, _nodes(jx.sim, overhead=0.2), mode=mode,
                           work_per_point=2e-3, **kw)
    tjob = t_km.KMeansJob(pts, 8, _nodes(t_sim, overhead=0.2), mode=mode,
                          work_per_point=2e-3, device="cpu", **kw)
    np.testing.assert_array_equal(tjob.centroids.numpy(),
                                  np.asarray(jjob.centroids, np.float32))
    want, got = np.asarray(jjob.run(12)), tjob.run(12).numpy()
    assert got.dtype == np.float32 and got.shape == (8, 8)
    np.testing.assert_allclose(got, want, atol=CROSS_ATOL)
    assert [dataclasses.astuple(r) for r in tjob.reports] == \
        [dataclasses.astuple(r) for r in jjob.reports]
    assert tjob.total_time() == jjob.total_time()


@pytest.mark.parametrize("seed", [0, 5])
def test_kmeans_reference_matches_jax_reference(jx, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(1500, 3)) * 2.0
    want = jx.km.kmeans_reference(pts, 6, 10, seed=seed)
    got = t_km.kmeans_reference(pts, 6, 10, seed=seed, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=CROSS_ATOL)


def test_kmeans_accepts_tensors_and_keeps_the_device():
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 4)))
    job = t_km.KMeansJob(pts, 3, _nodes(t_sim), mode="even", device="cpu")
    cent = job.run(3)
    assert cent.device.type == "cpu" and cent.dtype == torch.float32
    np.testing.assert_allclose(cent.numpy(),
                               t_km.kmeans_reference(pts.numpy(), 3, 3, device="cpu"),
                               atol=1e-5)


def test_kmeans_entry_points_ask_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_km.kmeans_reference(np.zeros((4, 2)), 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_km.KMeansJob(np.zeros((4, 2)), 2, _nodes(t_sim))


def test_kmeans_demo_on_cpu(capsys):
    demo.main(["--per-blob", "50", "--iters", "6", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    modes = {ln["mode"]: ln for ln in lines[:-1]}
    assert set(modes) == {"hemt", "even", "homt-8", "homt-32"}
    assert all(ln["centroid_err"] < 1e-4 for ln in modes.values())
    assert lines[-1]["hemt_vs_even_pct"] > 0


@pytest.mark.gpu
def test_kmeans_job_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pts = np.random.default_rng(4).normal(size=(50_000, 8))
    got = t_km.KMeansJob(pts, 8, _nodes(t_sim), mode="hemt", weights=[1.0, 0.4],
                         device="cuda").run(10).cpu().numpy()
    want = t_km.kmeans_reference(pts, 8, 10, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_partitions_leave_the_centroids_unchanged(monkeypatch):
    """Float64 sums make the result independent of the partition and of the
    blocks the map stage walks: every mode equals the oracle exactly, here
    with blocks of 1,000 points."""
    monkeypatch.setattr(t_km, "SUM_BLOCK", 1000)
    pts = np.random.default_rng(6).normal(size=(12_345, 8))
    want = t_km.kmeans_reference(pts, 8, 15, device="cpu")
    for mode, kw in MODES:
        job = t_km.KMeansJob(pts, 8, _nodes(t_sim), mode=mode, device="cpu", **kw)
        np.testing.assert_array_equal(job.run(15).numpy(), want)
