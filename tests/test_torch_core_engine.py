"""The port's copies of the scheduler core (``repro_torch.core``) against the
JAX package's originals (``repro.core``): identical schedules, stage
results and route names on the same inputs, with fixed seeds.

The copies differ from the originals only in their imports, in
``skewed_hash.bucket_of_torch`` (the twin of ``bucket_of_jnp``), and in
three guards rewritten without lint waivers; a case below pins each guard.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core import faults as j_faults
from repro.core import simulator as j_sim
from repro.core import skewed_hash as j_hash
from repro.core import speculation as j_spec
from repro_torch.core import engine as t_engine
from repro_torch.core import faults as t_faults
from repro_torch.core import simulator as t_sim
from repro_torch.core import skewed_hash as t_hash
from repro_torch.core import speculation as t_spec

REF = SimpleNamespace(engine=j_engine, faults=j_faults, sim=j_sim, spec=j_spec)
PORT = SimpleNamespace(engine=t_engine, faults=t_faults, sim=t_sim, spec=t_spec)


def _nodes(m, speeds, overhead=0.05):
    return [m.sim.SimNode.constant(f"n{i}", s, overhead) for i, s in enumerate(speeds)]


def _works(seed, n, lo=0.1, hi=2.0):
    return tuple(np.random.default_rng(seed).uniform(lo, hi, n).tolist())


# --------------------------------------------------------------------------
# run_job: one builder per scenario, called with either package
# --------------------------------------------------------------------------

def _job_static_hetero(m):
    nodes = _nodes(m, [1.0, 0.4, 0.7])
    return m.engine.run_job(nodes, [m.engine.StaticSpec(works=(3.0, 1.2, 2.1))] * 5)


def _job_pull_uniform(m):
    nodes = _nodes(m, [1.0, 0.4])
    return m.engine.run_job(nodes, [m.engine.PullSpec(n_tasks=40, task_work=0.3)] * 4,
                            start_time=2.5)


def _job_pull_hetero(m):
    nodes = _nodes(m, [1.0, 0.4, 0.25], overhead=0.02)
    specs = [m.engine.PullSpec(works=_works(s, 50)) for s in (1, 2, 3)]
    return m.engine.run_job(nodes, specs)


def _job_profiles(m):
    nodes = [m.sim.SimNode("burst", [(0.0, 1.0), (2.0, 0.4)], 0.05),
             m.sim.SimNode.constant("flat", 0.6, 0.05)]
    specs = [m.engine.StaticSpec(works=(2.0, 1.5)), m.engine.PullSpec(works=_works(4, 20))]
    return m.engine.run_job(nodes, specs * 2)


def _job_faults(m):
    nodes = _nodes(m, [1.0, 1.0, 0.5])
    trace = m.faults.FaultTrace(
        events=(m.faults.NodeCrash(1, at=1.0, recover_at=4.0),
                m.faults.SpotPreemption(2, at=6.0, warning=0.5)),
        retry=m.faults.RetryPolicy(max_attempts=3, relaunch_overhead=0.1),
        checkpoint_grain=0.25)
    specs = [m.engine.StaticSpec(works=(2.0, 2.0, 1.0),
                                 mitigation=m.spec.ReskewHandoff(1.5)),
             m.engine.PullSpec(works=_works(5, 24))] * 3
    return m.engine.run_job(nodes, specs, faults=trace)


def _job_mitigation(m):
    nodes = _nodes(m, [1.0, 1.0, 0.25], overhead=0.01)
    specs = [m.engine.StaticSpec(works=(1.0, 1.0, 1.0),
                                 mitigation=m.spec.WorkStealing(grain=0.05)),
             m.engine.PullSpec(works=_works(6, 30),
                               mitigation=m.spec.SpeculativeCopies()),
             m.engine.StaticSpec(works=(1.0, 1.0, 1.0),
                                 mitigation=m.spec.ReskewHandoff(1.2)),
             m.engine.StaticSpec(works=(1.0, 1.0, 1.0))]
    return m.engine.run_job(nodes, specs)


def _job_adaptive(m):
    nodes = _nodes(m, [1.0, 0.5, 0.25], overhead=0.1)
    plan = m.engine.AdaptivePlan(alpha=0.3)
    sched = m.engine.run_job(nodes, [m.engine.StaticSpec(works=(4.0, 4.0, 4.0))] * 6,
                             adaptive=plan)
    return sched, plan.history


def _job_io(m):
    nodes = _nodes(m, [1.0, 0.8, 0.6, 0.4], overhead=0.01)
    specs = [m.engine.PullSpec(n_tasks=16, task_work=0.01, io_mb=64.0, datanode=0),
             m.engine.StaticSpec(works=(1.0, 0.8, 0.6, 0.4), io_mb=128.0, datanode=1)]
    return m.engine.run_job(nodes, specs * 2, uplink_bw=100.0)


def _schedule(s):
    return (s.completion, s.continuation,
            [(st.start, st.completion, st.idle_time, dict(st.node_finish),
              dict(st.counts), dict(st.work)) for st in s.stages])


@pytest.mark.parametrize("build", [_job_static_hetero, _job_pull_uniform, _job_pull_hetero,
                                   _job_profiles, _job_faults, _job_mitigation,
                                   _job_adaptive, _job_io],
                         ids=lambda f: f.__name__[5:])
def test_run_job_matches_reference(build):
    want, got = build(REF), build(PORT)
    if isinstance(want, tuple):       # (schedule, adaptive history)
        assert [tuple(h) for h in got[1]] == [tuple(h) for h in want[1]]
        want, got = want[0], got[0]
    assert len(want.stages) > 1
    assert _schedule(got) == _schedule(want)


# --------------------------------------------------------------------------
# simulate_stage and plan_path on one stage's queues
# --------------------------------------------------------------------------

def _tasks(m, works, io_mb=0.0, datanodes=None):
    dns = datanodes or [-1] * len(works)
    return [m.sim.SimTask(w, io_mb, dn, k) for k, (w, dn) in enumerate(zip(works, dns))]


def _stage_pull_uniform(m):
    return _nodes(m, [1.0, 0.4]), [_tasks(m, [0.5] * 30)], True, None


def _stage_pull_hetero(m):
    return _nodes(m, [1.0, 0.4, 0.7]), [_tasks(m, _works(7, 40))], True, None


def _stage_pull_runs(m):
    # blocky works: the run-length batched scan
    works = [0.2] * 80 + [0.5] * 80 + [0.2] * 40
    return _nodes(m, [1.0, 0.4, 0.7]), [_tasks(m, works)], True, None


def _stage_static(m):
    return (_nodes(m, [1.0, 0.4, 0.7]), [_tasks(m, [w]) for w in (2.0, 0.8, 1.4)],
            False, None)


def _stage_io_sym(m):
    works = [0.001] * 12
    return (_nodes(m, [1.0, 0.5, 0.5, 0.25], overhead=0.0),
            [_tasks(m, works, 32.0, [k % 2 for k in range(12)])], True, 50.0)


def _stage_io_shared(m):
    return (_nodes(m, [1.0, 0.5]), [_tasks(m, _works(8, 10), 16.0, [0] * 10)], True, 40.0)


def _stage_profile(m):
    nodes = [m.sim.SimNode("burst", [(0.0, 1.0), (1.0, 0.3)], 0.05),
             m.sim.SimNode.constant("flat", 0.6, 0.05)]
    return nodes, [_tasks(m, _works(9, 20))], True, None


STAGES = {"pull_uniform": (_stage_pull_uniform, "closed-pull"),
          "pull_hetero": (_stage_pull_hetero, "closed-pull-hetero"),
          "pull_runs": (_stage_pull_runs, "closed-pull-hetero"),
          "static": (_stage_static, "closed-static"),
          "io_sym": (_stage_io_sym, "closed-pull-io-sym"),
          "io_shared": (_stage_io_shared, "event"),
          "profile": (_stage_profile, "event")}


def _result(r):
    c = r.columns()
    return (dict(r.node_finish), r.completion, r.idle_time, c.node_names,
            [a.tolist() for a in (c.task_ids, c.node_index, c.starts, c.ends, c.works)])


@pytest.mark.parametrize("name", sorted(STAGES))
def test_simulate_stage_and_route_match_reference(name):
    build, route = STAGES[name]
    (jn, jq, pull, bw), (tn, tq, _, _) = build(REF), build(PORT)
    assert j_engine.plan_path(jn, jq, pull, bw) == route
    assert t_engine.plan_path(tn, tq, pull, bw) == route
    assert _result(t_engine.simulate_stage(tn, tq, pull, bw, start_time=1.0)) == \
        _result(j_engine.simulate_stage(jn, jq, pull, bw, start_time=1.0))


def test_simulate_stage_with_faults_and_mitigation_matches_reference():
    def run(m):
        nodes, queues, pull, bw = _stage_pull_hetero(m)
        trace = m.faults.FaultTrace(events=(m.faults.NodeCrash(0, at=2.0, recover_at=3.5),))
        a = m.engine.simulate_stage(nodes, queues, pull, bw, faults=trace)
        b = m.engine.simulate_stage(nodes, queues, pull, bw,
                                    mitigation=m.spec.SpeculativeCopies(factor=1.2))
        return _result(a), _result(b)

    assert run(PORT) == run(REF)


# --------------------------------------------------------------------------
# the three guards rewritten without a waiver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", [j_engine, t_engine], ids=["reference", "port"])
def test_io_mb_one_ulp_apart_routes_to_event(engine):
    """engine._stripe_width: any io_mb inequality, even 1 ulp, leaves the
    symmetric closed form."""
    m = REF if engine is j_engine else PORT
    nodes, (tasks,), pull, bw = _stage_io_sym(m)
    assert engine.plan_path(nodes, [tasks], pull, bw) == "closed-pull-io-sym"
    for bumped in (np.nextafter(32.0, np.inf), np.nextafter(32.0, 0.0)):
        odd = list(tasks)
        odd[5] = m.sim.SimTask(odd[5].cpu_work, float(bumped), odd[5].datanode, 5)
        assert engine.plan_path(nodes, [odd], pull, bw) == "event"


@pytest.mark.parametrize("works", [
    [1.0] * 64 + [2.0] * 64 + [1.0] * 64,
    [1.0] * 64 + [float(np.nextafter(1.0, 2.0))] * 64 + [1.0] * 64,
    [0.0] * 70 + [-0.0] * 70,
    _works(10, 200),                           # mostly distinct: no batching
], ids=["runs", "one_ulp_runs", "signed_zeros", "distinct"])
def test_run_length_grouping_matches_reference(works):
    """engine._pull_hetero_try_batched groups exactly equal neighbours."""
    args = ([0.05, 0.05, 0.02], [1.0, 0.4, 0.7], works, 0.5, True)
    want = j_engine._pull_hetero_try_batched(*args)
    got = t_engine._pull_hetero_try_batched(*args)
    assert (got is None) == (want is None)
    if want is not None:
        node_end, counts, wsums, per_task = got
        assert list(node_end) == list(want[0])
        assert list(counts) == list(want[1]) and list(wsums) == list(want[2])
        assert all(np.array_equal(a, b) for a, b in zip(per_task, want[3]))


@pytest.mark.parametrize("sim", [j_sim, t_sim], ids=["reference", "port"])
def test_profile_must_start_at_exactly_zero(sim):
    """simulator.SimNode: a profile starting at 1e-12 is refused, one at
    0 or 0.0 (or -0.0) is taken."""
    with pytest.raises(ValueError, match="t=0"):
        sim.SimNode("x", [(1e-12, 1.0)])
    for t0 in (0, 0.0, -0.0):
        sim.SimNode("x", [(t0, 1.0), (1.0, 0.5)])


# --------------------------------------------------------------------------
# skewed_hash: the numpy functions and the torch twin of bucket_of
# --------------------------------------------------------------------------

@pytest.mark.parametrize("caps", [[3, 4, 4], [7, 0, 5, 1], [1]], ids=str)
def test_bucket_of_torch_equals_bucket_of(caps):
    rng = np.random.default_rng(12)
    h = np.concatenate([rng.integers(-2**40, 2**40, 500),
                        [np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max, -1, 0]])
    want = j_hash.bucket_of(h, np.asarray(caps))
    assert np.array_equal(t_hash.bucket_of(h, np.asarray(caps)), want)
    got = t_hash.bucket_of_torch(torch.from_numpy(h), torch.tensor(caps))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(t_hash.integer_capacities([1.0, 0.4], 997),
                          j_hash.integer_capacities([1.0, 0.4], 997))
