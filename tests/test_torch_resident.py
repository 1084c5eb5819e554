"""The port's copy of the resident calendar (``repro_torch.core.resident``)
against the JAX package's original (``repro.core.resident``): the same
nodes, jobs, fault traces and resizes give equal outcomes, ``planned``
splits, stage summaries, ``alive`` lists and adaptive histories, exactly.

The copy differs from the original only in its imports and in two guards
on the carry sentinel rewritten without lint waivers; a case below pins
each guard at 0.0, -0.0 and the smallest residual, 5e-324.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import engine as j_engine
from repro.core import faults as j_faults
from repro.core import resident as j_res
from repro.core import simulator as j_sim
from repro_torch.core import engine as t_engine
from repro_torch.core import faults as t_faults
from repro_torch.core import resident as t_res
from repro_torch.core import simulator as t_sim

REF = SimpleNamespace(engine=j_engine, faults=j_faults, res=j_res, sim=j_sim)
PORT = SimpleNamespace(engine=t_engine, faults=t_faults, res=t_res, sim=t_sim)
N_DATANODES = 3


# --------------------------------------------------------------------------
# scenario draws (numbers only), built with either package
# --------------------------------------------------------------------------

def _draw_cluster(rng, constant):
    out = []
    for i in range(int(rng.integers(2, 5))):
        if constant or rng.random() < 0.6:
            prof = [(0.0, float(rng.uniform(0.3, 3.0)))]
        else:
            breaks = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 5.0,
                                                                  int(rng.integers(1, 3))))])
            prof = [(float(tb), float(rng.uniform(0.3, 3.0))) for tb in breaks]
        out.append((f"n{i}", prof, float(rng.uniform(0.0, 0.2))))
    return out


def _draw_jobs(rng, n_jobs):
    jobs = []
    for j in range(n_jobs):
        stages = []
        for _ in range(int(rng.integers(1, 4))):
            io = float(rng.uniform(0.5, 5.0)) if rng.random() < 0.4 else 0.0
            d = int(rng.integers(0, N_DATANODES)) if io else -1
            kind = "static" if rng.random() < 0.6 else "pull"
            width = int(rng.integers(1, 5)) if kind == "static" else int(rng.integers(1, 6))
            works = tuple(float(w) for w in rng.uniform(0.2, 5.0 if kind == "static" else 3.0,
                                                        width))
            stages.append((kind, works, io, d))
        props = None
        if rng.random() < 0.2:
            props = {f"n{i}": float(rng.uniform(0.5, 3.0))
                     for i in range(int(rng.integers(1, 4)))}
        jobs.append(dict(
            name=f"j{j}", stages=tuple(stages),
            arrival=0.0 if rng.random() < 0.6 else float(rng.uniform(0.1, 6.0)),
            priority=int(rng.integers(0, 3)), weight=float(rng.uniform(0.5, 3.0)),
            deadline=None if rng.random() < 0.5 else float(rng.uniform(2.0, 30.0)),
            retry=dict(max_attempts=int(rng.integers(1, 4)),
                       relaunch_overhead=float(rng.choice([0.0, 0.3])),
                       backoff=float(rng.choice([1.0, 2.0]))),
            adaptive=rng.random() < 0.4, proportions=props,
            fold_lost=rng.random() < 0.7))
    return jobs


def _draw_trace(rng, n):
    if rng.random() < 0.25:
        return None
    events = []
    for nd in rng.permutation(n)[:int(rng.integers(1, min(n, 3) + 1))]:
        at = float(rng.uniform(0.1, 10.0))
        u = rng.random()
        if u < 0.35:
            events.append(("crash", int(nd), at, None, False))
        elif u < 0.75:
            events.append(("crash", int(nd), at, at + float(rng.uniform(0.5, 5.0)),
                           bool(rng.random() < 0.3)))
        else:
            events.append(("spot", int(nd), at, float(rng.choice([0.0, 0.5, 1.5])), False))
    return events, float(rng.choice([0.0, 0.25, 1.0]))


def _draw_resizes(rng):
    out = []
    for r in range(int(rng.integers(0, 3))):
        add = [(f"x{r}{k}", float(rng.uniform(0.3, 2.5)), float(rng.uniform(0.0, 0.2)))
               for k in range(int(rng.integers(0, 3)))]
        drop = tuple(int(i) for i in rng.permutation(4)[:int(rng.integers(0, 2))])
        if add or drop:
            out.append((float(rng.uniform(0.2, 10.0)), add, drop))
    return out


def _scenario(seed, kind):
    rng = np.random.default_rng(seed)
    cluster = _draw_cluster(rng, constant=kind != "single")
    n_jobs = {"single": 1, "restart": int(rng.integers(1, 3))}.get(kind, int(rng.integers(2, 4)))
    jobs = _draw_jobs(rng, n_jobs)
    if kind == "single":
        jobs[0]["arrival"] = 0.0
    bw = None if rng.random() < 0.3 else float(rng.uniform(0.5, 4.0))
    with_faults = kind in ("faults", "restart")
    trace = _draw_trace(rng, len(cluster)) if with_faults else None
    resizes = _draw_resizes(rng) if with_faults else []
    return dict(cluster=cluster, jobs=jobs, bw=bw, trace=trace, resizes=resizes,
                recovery="restart" if kind == "restart" else "splice")


def _build(m, sc):
    nodes = [m.sim.SimNode(nm, prof, ov) for nm, prof, ov in sc["cluster"]]
    jobs = []
    for s in sc["jobs"]:
        stages = tuple(
            (m.engine.StaticSpec if kind == "static" else m.engine.PullSpec)(
                works=works, io_mb=io, datanode=d)
            for kind, works, io, d in s["stages"])
        jobs.append(m.res.ResidentJob(
            s["name"], stages, arrival=s["arrival"], priority=s["priority"],
            weight=s["weight"], deadline=s["deadline"],
            retry=m.faults.RetryPolicy(**s["retry"]),
            adaptive=m.engine.AdaptivePlan() if s["adaptive"] else None,
            proportions=s["proportions"], fold_lost=s["fold_lost"]))
    trace = None
    if sc["trace"] is not None:
        events, grain = sc["trace"]
        trace = m.faults.FaultTrace(tuple(
            m.faults.NodeCrash(nd, at, recover_at=rec, cold_restart=cold) if k == "crash"
            else m.faults.SpotPreemption(nd, at, warning=rec)
            for k, nd, at, rec, cold in events), checkpoint_grain=grain)
    resizes = tuple(m.res.ResizeEvent(at, add=tuple(m.sim.SimNode(nm, [(0.0, sp)], ov)
                                                    for nm, sp, ov in add), drop=drop)
                    for at, add, drop in sc["resizes"])
    m.engine.run_job_cache_clear()
    cal = m.res.ResidentCalendar(nodes, uplink_bw=sc["bw"], faults=trace, resizes=resizes,
                                 recovery=sc["recovery"])
    return cal.run(jobs), jobs


def _outcome(o):
    d = dataclasses.asdict(o)
    d["stages"] = [dataclasses.asdict(s) for s in o.stages]
    return d


def _history(jobs):
    return [[tuple(h) for h in j.adaptive.history] if j.adaptive else None
            for j in jobs]


def _assert_same(sc):
    (want, wjobs), (got, gjobs) = _build(REF, sc), _build(PORT, sc)
    assert sorted(got.outcomes) == sorted(want.outcomes)
    for name, w in want.outcomes.items():
        assert _outcome(got.outcomes[name]) == _outcome(w), name
    assert (got.makespan, got.alive) == (want.makespan, want.alive)
    assert got.attainment() == want.attainment()
    assert _history(gjobs) == _history(wjobs)


@pytest.mark.parametrize("kind", ["single", "multi", "faults", "restart"])
@pytest.mark.parametrize("seed", range(8))
def test_resident_calendar_matches_reference(kind, seed):
    _assert_same(_scenario(seed * 101 + len(kind), kind))


def _window(m, crash_at, recover_at, fold_lost, mode):
    """The trainer's window shape: repeated adaptive static stages over
    three slices with a whole-grain quantum."""
    nodes = [m.sim.SimNode("rep0", [(0.0, 1.0)], 0.05),
             m.sim.SimNode("rep1", [(0.0, 1.0), (7.0, 0.5)], 0.05),
             m.sim.SimNode("rep2", [(0.0, 0.4)], 0.05)]
    plan = m.engine.AdaptivePlan(alpha=0.3, quantum=1.0, min_units=1)
    job = m.res.ResidentJob("window", (m.engine.StaticSpec(works=(4.0, 4.0, 4.0)),) * 5,
                            retry=m.faults.RetryPolicy(max_attempts=3),
                            adaptive=plan, fold_lost=fold_lost)
    trace = m.faults.FaultTrace((m.faults.NodeCrash(1, crash_at, recover_at=recover_at),),
                                retry=m.faults.RetryPolicy(max_attempts=3),
                                checkpoint_grain=1.0)
    res = m.res.ResidentCalendar(nodes, faults=trace, recovery=mode).run([job])
    return res, [job]


@pytest.mark.parametrize("mode", ["splice", "restart"])
@pytest.mark.parametrize("fold_lost", [False, True])
@pytest.mark.parametrize("crash", [(6.0, None), (2.5, 9.0)], ids=["permanent", "recovers"])
def test_adaptive_window_with_faults_matches_reference(mode, fold_lost, crash):
    (want, wj), (got, gj) = (_window(m, *crash, fold_lost, mode) for m in (REF, PORT))
    assert _outcome(got.outcomes["window"]) == _outcome(want.outcomes["window"])
    assert (got.makespan, got.alive) == (want.makespan, want.alive)
    assert _history(gj) == _history(wj)


# --------------------------------------------------------------------------
# the two guards rewritten without a waiver
# --------------------------------------------------------------------------

CARRIES = [(0.0, True), (-0.0, True), (5e-324, False)]


@pytest.mark.parametrize("carry,sentinel", CARRIES, ids=["0.0", "-0.0", "5e-324"])
@pytest.mark.parametrize("m", [REF, PORT], ids=["reference", "port"])
def test_base_split_carry_sentinel(m, carry, sentinel):
    """carry == 0.0 keeps the static spec's own split; any computed
    residual, however small, takes the conservative even re-split."""
    spec = m.engine.StaticSpec(works=(3.0, 1.0))
    nodes = [m.sim.SimNode.constant("a", 1.0), m.sim.SimNode.constant("b", 1.0)]
    cal = m.res.ResidentCalendar(nodes)
    js = m.res._JobState(m.res.ResidentJob("j", (spec,)), [])
    js.carry = carry
    got = cal._base_split(js, spec, 4.0, ["a", "b"])
    assert got == ([3.0, 1.0] if sentinel else [2.0, 2.0])


@pytest.mark.parametrize("carry,sentinel", CARRIES, ids=["0.0", "-0.0", "5e-324"])
@pytest.mark.parametrize("m", [REF, PORT], ids=["reference", "port"])
def test_can_fast_forward_carry_sentinel(m, carry, sentinel):
    """The tail fast-forward is taken only with no residual carried."""
    nodes = [m.sim.SimNode.constant("a", 1.0), m.sim.SimNode.constant("b", 1.0)]
    cal = m.res.ResidentCalendar(nodes)
    js = m.res._JobState(m.res.ResidentJob("j", (m.engine.StaticSpec(works=(1.0, 1.0)),)), [])
    cal.jobs, cal._ext_left = [js], 0
    cal.dead, cal.draining = [False, False], [False, False]
    js.nodes = [0, 1]
    js.carry = carry
    assert cal._can_fast_forward(js) is sentinel


def test_copy_differs_only_in_imports_and_guards():
    """Line for line, the copy is the original with ``repro.`` pointed at
    ``repro_torch.``, a header paragraph, one docstring line, and the two
    guards."""
    import inspect
    ref = inspect.getsource(j_res).replace("repro.", "repro_torch.").splitlines()
    port = inspect.getsource(t_res).splitlines()
    body = port.index('``run_window``-style drivers used to re-enter ``run_job`` from scratch')
    port = port[:1] + port[body - 1:]
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    assert len(ref) == len(port)
    assert [(a.split("#")[0].strip(), b.strip()) for a, b in diff] == [
        ("jobs — PR 5's machinery, now fair-sharing across *jobs*, not just",
         "jobs — the I/O-aware mitigation's machinery, now fair-sharing across *jobs*, "
         "not just"),
        ("and js.carry == 0.0):",
         "and math.isclose(js.carry, 0.0, rel_tol=0.0, abs_tol=0.0)):"),
        ("if js.carry != 0.0:",
         "if not math.isclose(js.carry, 0.0, rel_tol=0.0, abs_tol=0.0):")]
