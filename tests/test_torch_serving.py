"""Fleet serving in the port (``repro_torch.core.arrivals``,
``repro_torch.runtime.serving``, ``HeMTBatcher.plan`` and
``repro_torch.launch.serve --simulate``) against the JAX package's
originals: the same numbers go through both packages and the reports,
outcomes, plan splits and CLI lines agree.

The two modules are verbatim copies apart from their imports, so every
comparison here is held to 1e-12 or to equality. The traces are held bit
for bit at up to 10^4 requests per kind and seed; the reference's own
million-request scale test is not repeated here.
"""
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import arrivals as j_arr
from repro.core import faults as j_faults
from repro.core import simulator as j_sim
from repro.core import speculation as j_spec
from repro.launch import serve as j_cli
from repro.runtime import serve_loop as j_loop
from repro.runtime import serving as j_serving
from repro_torch.core import arrivals as t_arr
from repro_torch.core import engine as t_engine
from repro_torch.core import faults as t_faults
from repro_torch.core import simulator as t_sim
from repro_torch.core import speculation as t_spec
from repro_torch.launch import serve as t_cli
from repro_torch.runtime import serve_loop as t_loop
from repro_torch.runtime import serving as t_serving

torch.set_num_threads(2)

REF = SimpleNamespace(arr=j_arr, faults=j_faults, sim=j_sim, spec=j_spec,
                      loop=j_loop, serving=j_serving)
PORT = SimpleNamespace(arr=t_arr, faults=t_faults, sim=t_sim, spec=t_spec,
                       loop=t_loop, serving=t_serving)
TOL = 1e-12
SEEDS = range(8)


def _close(a, b):
    if np.isnan(a) or np.isnan(b):       # no request completed: both nan
        return bool(np.isnan(a) and np.isnan(b))
    return a == b or abs(a - b) <= TOL * max(1.0, abs(a), abs(b))


def assert_reports_equal(r, p):
    sr, sp = r.summary(), p.summary()
    assert sr.keys() == sp.keys()
    for key in sr:
        assert _close(sr[key], sp[key]), (key, sr[key], sp[key])
    assert np.array_equal(np.isinf(r.latencies), np.isinf(p.latencies))
    fin = np.isfinite(r.latencies)
    np.testing.assert_allclose(p.latencies[fin], r.latencies[fin], rtol=TOL, atol=TOL)
    assert np.array_equal(r.arrivals, p.arrivals)
    assert r.result.outcomes.keys() == p.result.outcomes.keys()
    for name, out in r.result.outcomes.items():
        got = p.result.outcomes[name]
        assert got.status == out.status, name
        if out.status == "done":
            assert _close(out.completion, got.completion), name


# --------------------------------------------------------------------------
# traces: the same times, bit for bit
# --------------------------------------------------------------------------

def _traces(pkg, seed):
    a = pkg.arr
    return [a.PoissonTrace(400.0, 20.0, seed=seed),
            a.DiurnalTrace(100.0, 500.0, 10.0, 20.0, seed=seed),
            a.MMPPTrace((100.0, 800.0), (4.0, 1.0), 20.0, seed=seed)]


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["poisson", "diurnal", "mmpp"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_traces_bit_equal(kind, seed):
    want = _traces(REF, seed)[kind].times()
    got = _traces(PORT, seed)[kind].times()
    assert 1000 < want.size <= 10_000
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _traces(PORT, seed)[kind].expected() == _traces(REF, seed)[kind].expected()


def test_trace_specs_frozen_and_validated():
    tr = t_arr.PoissonTrace(3.0, 20.0, seed=5)
    assert hash(tr) == hash(t_arr.PoissonTrace(3.0, 20.0, seed=5))
    with pytest.raises(Exception):
        tr.rate = 4.0
    for bad in (lambda a: a.PoissonTrace(-1.0, 10.0),
                lambda a: a.DiurnalTrace(2.0, 1.0, 10.0, 20.0),
                lambda a: a.MMPPTrace((1.0,), (1.0,), 10.0, start_state=3)):
        with pytest.raises(ValueError):
            bad(t_arr)
    times = np.array([0.0, 0.4, 1.9, 2.0, 7.5])
    assert np.array_equal(t_arr.dispatch_epochs(times, 2.0),
                          j_arr.dispatch_epochs(times, 2.0))


# --------------------------------------------------------------------------
# randomized scenarios through both packages
# --------------------------------------------------------------------------

def _draw(seed, *, burstable, with_mask, with_faults):
    """A scenario as plain numbers, built later by either package."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(int(rng.integers(2, 5))):
        s = float(rng.uniform(0.5, 3.0))
        if burstable and rng.random() < 0.5:
            prof = [(0.0, s), (float(rng.uniform(1.0, 6.0)), s * float(rng.uniform(0.2, 0.8)))]
        else:
            prof = [(0.0, s)]
        nodes.append((f"n{i}", prof, float(rng.uniform(0.0, 0.1))))
    events = []
    if with_faults:
        for nd in rng.permutation(len(nodes))[:int(rng.integers(1, 3))]:
            at = float(rng.uniform(0.5, 7.0))
            if rng.random() < 0.5:
                rec = None if rng.random() < 0.5 else at + float(rng.uniform(0.5, 3.0))
                events.append(("crash", int(nd), at, rec, bool(rng.random() < 0.3)))
            else:
                events.append(("spot", int(nd), at, float(rng.choice([0.0, 0.5]))))
    grain = float(rng.choice([0.0, 0.25]))
    classes = int(rng.integers(2, 4)) if with_mask else 1
    mask = None
    if with_mask:
        names = [n[0] for n in nodes]
        mask = {}
        for c in range(classes):
            if rng.random() < 0.7:
                k = int(rng.integers(1, len(names) + 1))
                mask[c] = sorted(rng.permutation(names)[:k].tolist())
    model = dict(decode_work=float(rng.uniform(0.3, 1.5)),
                 work_cv=float(rng.choice([0.0, 0.5])),
                 prefill_mb=float(rng.choice([0.0, 2.0])),
                 prefill_work=float(rng.choice([0.0, 0.2])),
                 classes=classes, seed=int(rng.integers(0, 1000)))
    scenario = dict(
        window=float(rng.uniform(0.8, 2.0)),
        mode=str(rng.choice(["hemt", "even", "oracle"])),
        slo=None if rng.random() < 0.3 else float(rng.uniform(2.0, 8.0)),
        uplink_bw=None if model["prefill_mb"] == 0.0 or rng.random() < 0.3
        else float(rng.uniform(1.0, 8.0)),
        datanode=int(rng.integers(0, len(nodes))),
        mask=mask, alpha=float(rng.choice([0.0, 0.3])),
        warmup=int(rng.integers(0, 2)), max_prefill_tasks=int(rng.choice([0, 3])))
    times = np.sort(rng.uniform(0.0, 8.0, int(rng.integers(3, 40))))
    return nodes, events, grain, model, scenario, times


def _build(pkg, nodes, events, grain, model, scenario):
    f = pkg.faults
    evs = []
    for ev in events:
        if ev[0] == "crash":
            evs.append(f.NodeCrash(ev[1], ev[2], recover_at=ev[3], cold_restart=ev[4]))
        else:
            evs.append(f.SpotPreemption(ev[1], ev[2], warning=ev[3]))
    faults = f.FaultTrace(tuple(evs), checkpoint_grain=grain) if evs else None
    return pkg.serving.ServingScenario(
        [pkg.sim.SimNode(n, p, o) for n, p, o in nodes],
        model=pkg.serving.RequestModel(**model), faults=faults, **scenario)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("suite", ["clean", "masked", "faults"])
def test_differential_scenarios_match_reference(suite, seed):
    """Prefill pulls, decode macrotasks, shared-estimator plans, oracle
    proportions, compatibility masks, crashes and spot preemptions: the
    port's report equals the reference's."""
    draw = _draw(1000 * ["clean", "masked", "faults"].index(suite) + seed,
                 burstable=suite != "masked", with_mask=suite == "masked",
                 with_faults=suite == "faults")
    times = draw[-1]
    want = _build(REF, *draw[:-1]).run(times)
    got = _build(PORT, *draw[:-1]).run(times)
    assert_reports_equal(want, got)


@pytest.mark.parametrize("mode", ["hemt", "even", "oracle"])
@pytest.mark.parametrize("trace", ["poisson", "diurnal", "mmpp"])
def test_trace_scenarios_match_reference(trace, mode):
    """A frozen trace spec through a four-replica fleet with a burstable
    replica and a prefill over the uplink."""
    def run(pkg):
        tr = dict(zip(["poisson", "diurnal", "mmpp"], _traces(pkg, 3)))[trace]
        tr = type(tr)(**{**{k: getattr(tr, k) for k in tr.__dataclass_fields__},
                         "horizon": 6.0})
        nodes = [pkg.sim.SimNode("rep0", [(0.0, 2.0), (3.0, 0.6)], 0.01),
                 pkg.sim.SimNode("rep1", [(0.0, 1.5)], 0.01),
                 pkg.sim.SimNode("rep2", [(0.0, 1.0)], 0.01),
                 pkg.sim.SimNode("rep3", [(0.0, 0.5)], 0.01)]
        sc = pkg.serving.ServingScenario(
            nodes, window=0.5, mode=mode, slo=2.0, uplink_bw=50.0,
            model=pkg.serving.RequestModel(decode_work=0.02, work_cv=0.5,
                                           prefill_mb=0.5, seed=3))
        return sc.run(tr)

    assert_reports_equal(run(REF), run(PORT))


# --------------------------------------------------------------------------
# crafted scenarios: the reference's exact numbers, and equal reports
# --------------------------------------------------------------------------

def _fleet(pkg, speeds, overhead=0.0):
    return [pkg.sim.SimNode(f"n{i}", [(0.0, s)], overhead) for i, s in enumerate(speeds)]


def test_crafted_single_burst_even_vs_hemt():
    times = np.array([0.1, 0.5, 1.0, 1.9])
    reps = {}
    for key, pkg in (("ref", REF), ("port", PORT)):
        for mode in ("even", "hemt"):
            sc = pkg.serving.ServingScenario(
                _fleet(pkg, (2.0, 1.0)), window=2.0, mode=mode, slo=4.0,
                model=pkg.serving.RequestModel(decode_work=1.5))
            reps[key, mode] = sc.run(times)
    even, hemt = reps["port", "even"], reps["port", "hemt"]
    assert even.result.outcomes["b0000000"].completion == pytest.approx(5.0)
    assert even.attainment == pytest.approx(0.5)
    out = hemt.result.outcomes["b0000000"]
    assert out.completion == pytest.approx(4.0)
    assert out.planned[-1] == {"n0": pytest.approx(4.0), "n1": pytest.approx(2.0)}
    assert hemt.attainment == 1.0
    for mode in ("even", "hemt"):
        assert_reports_equal(reps["ref", mode], reps["port", mode])


def test_compare_modes_matches_reference():
    times = np.array([0.1, 0.5, 1.0, 1.9])

    def sweep(pkg):
        sc = pkg.serving.ServingScenario(_fleet(pkg, (2.0, 1.0)), window=2.0, mode="even",
                                         slo=4.0, model=pkg.serving.RequestModel(decode_work=1.5))
        out = pkg.serving.compare_modes(sc, times)
        assert sc.mode == "even"
        return out

    want, got = sweep(REF), sweep(PORT)
    assert list(got) == list(want) == ["hemt", "even", "oracle"]
    for mode in want:
        assert_reports_equal(want[mode], got[mode])
    sc = t_serving.ServingScenario(_fleet(PORT, (1.0,)), window=1.0)
    with pytest.raises(ValueError, match="unknown modes"):
        t_serving.compare_modes(sc, times, modes=("hemt", "magic"))


def test_crafted_credit_exhaustion_resplit():
    def run(pkg):
        nodes = [pkg.sim.SimNode("burst", [(0.0, 2.0), (2.5, 0.4)], 0.0),
                 pkg.sim.SimNode("flat", [(0.0, 1.0)], 0.0)]
        sc = pkg.serving.ServingScenario(nodes, window=2.0, mode="hemt", alpha=0.0,
                                         model=pkg.serving.RequestModel(decode_work=3.0))
        times = np.array([0.5, 8.5])
        works, klass = sc.model.sample(2)
        jobs, _ = sc.build_jobs(times, works, klass, 12.0)
        res = pkg.serving.ResidentCalendar(nodes).run(jobs)
        return res.outcomes["b0000000"], res.outcomes["b0000004"]

    (w0, w1), (g0, g1) = run(REF), run(PORT)
    assert g0.planned[-1] == {"burst": pytest.approx(2.0), "flat": pytest.approx(1.0)}
    assert g1.planned[-1] == {"burst": pytest.approx(1.2), "flat": pytest.approx(1.8)}
    assert g0.completion == pytest.approx(5.0) and g1.completion == pytest.approx(13.0)
    for w, g in ((w0, g0), (w1, g1)):
        assert w.planned == g.planned and w.completion == g.completion


def test_crafted_stranded_batch_and_mask():
    def stranded(pkg):
        faults = pkg.faults.FaultTrace((pkg.faults.NodeCrash(0, 0.5),
                                        pkg.faults.NodeCrash(1, 0.6)))
        sc = pkg.serving.ServingScenario(_fleet(pkg, (1.0, 1.0)), window=1.0, mode="even",
                                         slo=5.0, faults=faults)
        return sc.run(np.array([0.2, 0.7]))

    got = stranded(PORT)
    assert got.n_completed == 0 and got.attainment == 0.0 and got.goodput == 0.0
    assert_reports_equal(stranded(REF), got)

    def masked(pkg):
        nodes = _fleet(pkg, (1.0, 1.0))
        sc = pkg.serving.ServingScenario(nodes, window=1.0, mode="even",
                                         model=pkg.serving.RequestModel(classes=2),
                                         mask={1: ["n1"]})
        jobs, _ = sc.build_jobs(np.array([0.1, 0.2]), np.array([2.0, 2.0]),
                                np.array([0, 1]), 2.0)
        res = pkg.serving.ResidentCalendar(nodes).run(jobs)
        return {j.name: (j.allowed, res.outcomes[j.name].admitted_at,
                         res.outcomes[j.name].completion,
                         res.outcomes[j.name].planned) for j in jobs}

    want, got = masked(REF), masked(PORT)
    assert want == got
    assert sorted(c for _, _, c, _ in got.values()) == [pytest.approx(2.0),
                                                        pytest.approx(4.0)]


def test_report_reductions_match_reference():
    lat = np.array([1.0, 2.0, 3.0, np.inf])
    result = type("R", (), {"makespan": 8.0})()
    want = j_serving.ServingReport(lat, np.zeros(4), slo=2.5, horizon=10.0, result=result)
    got = t_serving.ServingReport(lat, np.zeros(4), slo=2.5, horizon=10.0, result=result)
    sw, sg = want.summary(), got.summary()
    assert sw.keys() == sg.keys() and all(_close(sw[k], sg[k]) for k in sw)
    assert got.goodput == pytest.approx(0.2)
    m = t_serving.RequestModel(decode_work=2.0, work_cv=0.5, classes=3, seed=4)
    wm = j_serving.RequestModel(decode_work=2.0, work_cv=0.5, classes=3, seed=4)
    for a, b in zip(m.sample(500), wm.sample(500)):
        assert np.array_equal(a, b)
    nd = [t_sim.SimNode("a", [(0.0, 1.0)], 0.0)]
    for bad in (dict(window=0.0), dict(window=1.0, mode="magic"),
                dict(window=1.0, mask={0: ["ghost"]})):
        with pytest.raises(ValueError):
            t_serving.ServingScenario(nd, **bad)
    empty = t_serving.ServingScenario(nd, window=1.0, slo=2.0).run(np.empty(0))
    assert empty.n_requests == 0 and empty.attainment == 1.0


# --------------------------------------------------------------------------
# HeMTBatcher.plan and run_round
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"quantum": 1.0}, {"quantum": 0.5, "min_units": 1}])
def test_batcher_plan_splits_match_reference(kwargs):
    names = ["rep0", "rep1", "rep2"]
    obs = [("rep0", 40, 1.0), ("rep1", 30, 1.0), ("rep2", 5, 1.0),
           ("rep0", 44, 1.1), ("rep2", 7, 0.9)]
    plans = []
    for pkg in (REF, PORT):
        b = pkg.loop.HeMTBatcher(names, alpha=0.3)
        for r, tok, sec in obs:
            b.observe(r, tok, sec)
        plan = b.plan(**kwargs)
        assert plan.estimator is b.estimator      # the batcher's own AR(1) state
        plans.append(plan)
    want, got = plans
    for total in (12.0, 24.0, 7.5):
        assert got.split(names, total) == want.split(names, total)
    assert isinstance(got, t_engine.AdaptivePlan)


def test_run_round_observe_loop_converges():
    for pkg in (REF, PORT):
        nodes = _fleet(pkg, (2.0, 1.0))
        b = pkg.loop.HeMTBatcher([nd.name for nd in nodes], alpha=0.0)
        shares0, _ = pkg.serving.run_round(b, nodes, 12, decode_work=1.0)
        shares1, sched = pkg.serving.run_round(b, nodes, 12, decode_work=1.0)
        assert shares0 == {"n0": 6, "n1": 6} and shares1 == {"n0": 8, "n1": 4}
        assert sched.completion == pytest.approx(4.0)


def test_run_round_speculation_matches_reference():
    def run(pkg, hedge):
        nodes = [pkg.sim.SimNode("fast", [(0.0, 2.0)], 0.0),
                 pkg.sim.SimNode("ok", [(0.0, 2.0)], 0.0),
                 pkg.sim.SimNode("slow", [(0.0, 2.0), (1.0, 0.1)], 0.0)]
        b = pkg.loop.HeMTBatcher([nd.name for nd in nodes], alpha=0.0, min_share=1)
        pkg.serving.run_round(b, nodes, 12, prefill_mb=1.0, prefill_work=0.1,
                              uplink_bw=5.0)
        assert b.straggling(factor=2.0) == ["slow"]
        spec = pkg.spec.SpeculativeCopies(quantile=0.75, factor=1.5) if hedge else None
        shares, sched = pkg.serving.run_round(b, nodes, 12, start_time=30.0,
                                              speculation=spec)
        return shares, sched.completion

    for hedge in (False, True):
        assert run(PORT, hedge) == run(REF, hedge)
    assert run(PORT, True)[1] < run(PORT, False)[1]
    with pytest.raises(ValueError):
        t_serving.run_round(t_loop.HeMTBatcher(["other"]), _fleet(PORT, (1.0,)), 4)


# --------------------------------------------------------------------------
# the CLI: --simulate prints the reference's JSON
# --------------------------------------------------------------------------

def _cli_json(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    module.main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("mode", ["hemt", "even", "oracle"])
@pytest.mark.parametrize("extra", [
    [],
    ["--trace", "mmpp", "--throttle-at", "20", "--preempt-at", "60",
     "--preempt-drain", "2", "--prefill-mb", "0.5", "--work-cv", "0.5"],
    ["--trace", "diurnal", "--rate", "4", "--window", "1"],
], ids=["docstring", "mmpp-throttle-preempt-prefill", "diurnal"])
def test_cli_simulate_prints_the_references_json(mode, extra, monkeypatch, capsys):
    argv = ["--simulate", "--replicas", "2.0,1.5,1.0,0.5", "--trace", "poisson",
            "--rate", "2.5", "--horizon", "120", "--window", "2", "--slo", "4",
            "--mode", mode, *extra]
    want = _cli_json(j_cli, argv, monkeypatch, capsys)
    got = _cli_json(t_cli, argv, monkeypatch, capsys)
    assert got == want
    assert got["mode"] == mode and got["n_requests"] > 100


def test_cli_oracle_needs_simulate(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--mode", "oracle", "--device", "cpu"])
    with pytest.raises(SystemExit, match="only under --simulate"):
        t_cli.main()
