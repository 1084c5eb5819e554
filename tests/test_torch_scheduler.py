"""The port's copy of the job-level schedulers (``repro_torch.core.scheduler``)
against the JAX package's original (``repro.core.scheduler``): the paper's
OA-HeMT (Figs 7, 8), provisioned, burstable, HomT and multi-stage schedules
on the same inputs, equal to the last digit, and each holding the
behaviour its reference test asserts.
"""
from dataclasses import asdict
from types import SimpleNamespace

import pytest

from repro.core import capacity as j_cap
from repro.core import estimators as j_est
from repro.core import scheduler as j_sched
from repro.core import simulator as j_sim
from repro_torch.core import capacity as t_cap
from repro_torch.core import estimators as t_est
from repro_torch.core import scheduler as t_sched
from repro_torch.core import simulator as t_sim

REF = SimpleNamespace(cap=j_cap, est=j_est, sched=j_sched, sim=j_sim)
PORT = SimpleNamespace(cap=t_cap, est=t_est, sched=t_sched, sim=t_sim)


def _fig8(m):
    sched = m.sched.AdaptiveHeMTScheduler(["a", "b"], alpha=0.0)
    nodes = lambda k: [m.sim.SimNode.constant("a", 1.0),
                       m.sim.SimNode.constant("b", 0.4)]
    return sched.run_simulated_sequence(nodes, n_jobs=5, total_work=140.0)


def _fig7(m):
    def nodes(k):
        vb = 1.0 if k < 10 else 0.3
        return [m.sim.SimNode.constant("a", 1.0), m.sim.SimNode.constant("b", vb)]
    sched = m.sched.AdaptiveHeMTScheduler(["a", "b"], alpha=0.0)
    return sched.run_simulated_sequence(nodes, n_jobs=20, total_work=130.0)


def _provisioned(m):
    fudge = m.est.FudgeFactorLearner(advertised=0.4, smoothing=1.0)
    fudge.probe(1.0, 0.32)
    sched = m.sched.ProvisionedHeMTScheduler([1.0, 0.4], fudge=fudge, fudge_index=1)
    nodes = [m.sim.SimNode.constant("a", 1.0), m.sim.SimNode.constant("b", 0.32)]
    return sched.run_simulated(nodes, 132.0)


def _burstable(m):
    bnodes = [m.cap.BurstableNode(4, 0.2), m.cap.BurstableNode(8, 0.2),
              m.cap.BurstableNode(12, 0.2)]
    return m.sched.BurstableHeMTScheduler(bnodes).run_simulated(20.0)


def _homt(m):
    nodes = [m.sim.SimNode.constant("a", 1.0), m.sim.SimNode.constant("b", 0.4)]
    homt = m.sched.HomTScheduler(n_tasks=16).run_simulated(nodes, 140.0)
    even = m.sim.run_static_stage(nodes, [[m.sim.SimTask(70.0, task_id=0)],
                                          [m.sim.SimTask(70.0, task_id=1)]])
    return homt, even


def _multistage(m):
    nodes = [m.sim.SimNode.constant("a", 1.0, overhead=0.2),
             m.sim.SimNode.constant("b", 0.4, overhead=0.2)]
    job = m.sched.MultiStageJob(stage_works=[14.0] * 10)
    t_hemt, _ = job.run(nodes, weights=[1.0, 0.4])
    t_homt, _ = job.run(nodes, weights=None, n_tasks_per_stage=16)
    return t_hemt, t_homt


def _adaptive_job(m):
    nodes = [m.sim.SimNode.constant("a", 1.0, overhead=0.05),
             m.sim.SimNode.constant("b", 0.4, overhead=0.05)]
    sched = m.sched.AdaptiveHeMTScheduler(["a", "b"], alpha=0.0)
    return sched.run_simulated_job(nodes, [14.0] * 6)


def _stage(res):
    return (res.completion, res.idle_time,
            sorted(tuple(r) for r in res.records), sorted(res.node_finish.items()))


def _jobs(hist):
    return [asdict(j) for j in hist]


@pytest.mark.parametrize("build,key", [
    (_fig8, _jobs), (_fig7, _jobs), (_adaptive_job, _jobs),
    (_provisioned, _stage), (_burstable, _stage),
    (_homt, lambda r: [_stage(x) for x in r]),
    (_multistage, lambda r: r),
], ids=["fig8", "fig7", "adaptive_job", "provisioned", "burstable", "homt",
        "multistage"])
def test_schedules_match_reference(build, key):
    """Both packages give the same schedule to the last digit."""
    assert key(build(PORT)) == key(build(REF))


def test_oahemt_learns_static_shares_in_two_jobs():
    hist = _fig8(PORT)
    assert hist[0].split == pytest.approx([70.0, 70.0])
    assert hist[2].completion == pytest.approx(140.0 / 1.4, rel=0.02)
    assert hist[4].idle_time < 1e-6


def test_oahemt_adapts_to_interference():
    hist = _fig7(PORT)
    assert hist[10].completion > hist[9].completion * 1.3
    assert hist[12].completion == pytest.approx(100.0, rel=0.03)


def test_provisioned_with_fudge_matches_observed():
    assert _provisioned(PORT).idle_time < 1e-6


def test_burstable_scheduler_finishes_simultaneously():
    res = _burstable(PORT)
    assert res.idle_time < 1e-6
    assert res.completion == pytest.approx(80 / 11)


def test_homt_beats_bad_static_even_under_heterogeneity():
    homt, even = _homt(PORT)
    assert homt.completion < even.completion


def test_multistage_hemt_beats_homt_with_overhead():
    t_hemt, t_homt = _multistage(PORT)
    assert t_hemt < t_homt


def test_chip_smoke_pins_the_cpus_fig7_history():
    """chip_smoke.py holds the card machine's Fig 7 history to FIG7_SHA256:
    the hash both packages' sequences give here."""
    import hashlib
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for m in (PORT, REF):
        digest = hashlib.sha256(cs.fig7_json(m.sched, m.sim).encode()).hexdigest()
        assert digest == cs.FIG7_SHA256
