"""The port's fault tolerance, straggler detection and elastic re-planning
(``repro_torch.runtime.ft``, ``core.straggler``, ``runtime.elastic``)
against the JAX package's: twins of tests/test_runtime.py's fleet-monitor
and elastic tests, each running both packages on the same inputs, plus the
copies of the straggler helpers and ``reshard_restore``'s device move.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from repro.core import planner as j_planner
from repro.core import speculation as j_spec
from repro.core import straggler as j_strag
from repro.runtime import elastic as j_elastic
from repro.runtime import ft as j_ft
from repro_torch.core import planner as t_planner
from repro_torch.core import speculation as t_spec
from repro_torch.core import straggler as t_strag
from repro_torch.runtime import elastic as t_elastic
from repro_torch.runtime import ft as t_ft

REF = SimpleNamespace(planner=j_planner, spec=j_spec, strag=j_strag, elastic=j_elastic, ft=j_ft)
PORT = SimpleNamespace(planner=t_planner, spec=t_spec, strag=t_strag, elastic=t_elastic,
                       ft=t_ft)
BOTH = pytest.mark.parametrize("m", [REF, PORT], ids=["reference", "port"])


def _events(m):
    return [dataclasses.astuple(e) for e in m.events]


def _death_and_recovery(m):
    mon = m.ft.FleetMonitor(["a", "b"], timeout=2.0)
    mon.heartbeat(m.ft.Heartbeat("a", 1.0, 4, 1.0))
    mon.heartbeat(m.ft.Heartbeat("b", 1.0, 4, 1.0))
    dead0, _ = mon.check(1.5)
    dead1, _ = mon.check(3.5)                 # both last seen at 1.0
    mon.heartbeat(m.ft.Heartbeat("a", 4.0, 4, 1.0))
    return dead0, dead1, mon.alive(), _events(mon)


@BOTH
def test_fleet_monitor_death_and_recovery(m):
    dead0, dead1, alive, events = _death_and_recovery(m)
    assert dead0 == [] and set(dead1) == {"a", "b"}
    assert alive == ["a"]
    assert any(e[0] == "recovered" for e in events)


def test_fleet_monitor_death_and_recovery_matches_reference():
    assert _death_and_recovery(PORT) == _death_and_recovery(REF)


def _straggler_signal(m):
    mon = m.ft.FleetMonitor(["a", "b", "c", "d"], timeout=100.0)
    for name, rate in zip("abcd", [4.0, 4.2, 3.9, 0.5]):
        mon.heartbeat(m.ft.Heartbeat(name, 1.0, int(rate * 10), 10.0))
    _, stragglers = mon.check(1.0)
    return [dataclasses.astuple(s) for s in stragglers], _events(mon)


@BOTH
def test_fleet_monitor_straggler_signal(m):
    stragglers, _ = _straggler_signal(m)
    assert len(stragglers) == 1


def test_fleet_monitor_straggler_signal_matches_reference():
    assert _straggler_signal(PORT) == _straggler_signal(REF)


def _straggler_episodes(m):
    mon = m.ft.FleetMonitor(["a", "b", "c", "d"], timeout=100.0)
    for name, rate in zip("abcd", [4.0, 4.2, 3.9, 0.5]):
        mon.heartbeat(m.ft.Heartbeat(name, 1.0, int(rate * 10), 10.0))
    _, reports = mon.check(1.0)
    names = [r.name for r in reports]
    mon.check(2.0)                           # same episode: no new event
    first = [(e.slice_name, e.at) for e in mon.events if e.kind == "straggler"]
    mon.heartbeat(m.ft.Heartbeat("d", 3.0, 40, 10.0))   # back to 4 grains/s
    mon.check(3.0)
    rec = [(e.slice_name, e.detail) for e in mon.events if e.kind == "recovered"]
    mon.heartbeat(m.ft.Heartbeat("d", 4.0, 5, 10.0))    # a second episode
    mon.check(4.0)
    again = [e.at for e in mon.events if e.kind == "straggler"]
    return names, first, rec, again, _events(mon)


@BOTH
def test_fleet_monitor_straggler_episode_events(m):
    names, first, rec, again, _ = _straggler_episodes(m)
    assert names == ["d"]
    assert first == [("d", 1.0)]
    assert rec == [("d", "straggler episode ended")]
    assert again == [1.0, 4.0]


def test_fleet_monitor_straggler_episode_events_match_reference():
    assert _straggler_episodes(PORT) == _straggler_episodes(REF)


@BOTH
def test_elastic_replan_with_no_survivors_raises(m):
    p = m.planner.GrainPlanner(["a", "b"], alpha=0.0)
    with pytest.raises(RuntimeError, match="no slices left"):
        m.elastic.replan(p, [], [])


def _newcomer(m):
    p = m.planner.GrainPlanner(["a", "b", "c"], alpha=0.0)
    p.observe_step({"a": {"grains": 4, "elapsed": 1.0},     # 4 grains/s
                    "b": {"grains": 4, "elapsed": 2.0},     # 2 grains/s
                    "c": {"grains": 4, "elapsed": 4.0}})    # 1 grain/s
    p.plan(12)
    new = m.elastic.replan(p, ["a", "b"], ["d"])           # c died, d joins
    p.plan(12)
    return (new, p.estimator.speed("c"), p.estimator.speeds(["a", "b", "d"]),
            m.elastic.scale_event_log(p))


@BOTH
def test_elastic_newcomer_cold_starts_at_survivor_mean(m):
    _, forgotten, sp, _ = _newcomer(m)
    assert forgotten is None
    assert sp[0] == pytest.approx(4.0) and sp[1] == pytest.approx(2.0)
    assert sp[2] == pytest.approx(3.0)                      # mean of (4, 2)


def test_elastic_newcomer_and_scale_log_match_reference():
    got, want = _newcomer(PORT), _newcomer(REF)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    assert list(got[2]) == list(want[2])


def _exhausted(m):
    p = m.planner.GrainPlanner(["a", "b"], alpha=0.0)
    p.observe_step({"a": {"grains": 4, "elapsed": 2.0},
                    "b": {"grains": 4, "elapsed": 4.0}})
    with pytest.raises(m.elastic.FleetExhaustedError) as ei:
        m.elastic.replan(p, [], [])
    err = ei.value
    with pytest.raises(m.elastic.FleetExhaustedError) as ei2:
        m.elastic.replan(m.planner.GrainPlanner(["x"]), [])
    return isinstance(err, RuntimeError), str(err), err.estimates, ei2.value.estimates


@BOTH
def test_fleet_exhausted_error_carries_estimates(m):
    is_runtime, msg, estimates, empty = _exhausted(m)
    assert is_runtime and msg == "no slices left after resize"
    assert estimates == pytest.approx({"a": 2.0, "b": 1.0})
    assert empty == {}


def test_fleet_exhausted_error_matches_reference():
    assert _exhausted(PORT) == _exhausted(REF)


def test_mark_exhausted_logs_the_terminal_event_like_the_reference():
    logs = []
    for m in (REF, PORT):
        mon = m.ft.FleetMonitor(["a"], timeout=1.0)
        mon.mark_exhausted(5.0, {"a": 0.25, "b": 1.5})
        mon.mark_exhausted(6.0)
        logs.append((mon.exhausted, _events(mon)))
    assert logs[1] == logs[0]


def test_reshard_restore_requires_a_checkpoint():
    import jax.numpy as jnp

    for m, zeros, ones in ((REF, jnp.zeros(2), jnp.ones(2)),
                           (PORT, torch.zeros(2), torch.ones(2))):
        class _Empty:
            def restore_latest(self, state_like):
                return None

        class _Full:
            def restore_latest(self, state_like, _ones=ones):
                return 7, {"w": _ones}, {}

        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            m.elastic.reshard_restore(_Empty(), {"w": zeros})
        step, state = m.elastic.reshard_restore(_Full(), {"w": zeros})
        assert step == 7
        assert float(state["w"].sum()) == pytest.approx(2.0)


def test_reshard_restore_moves_the_state_to_the_device():
    """``shardings`` may be a device: every tensor of the restored state,
    the model's parameters and the optimizer's moments included, lands
    there."""
    from repro_torch.configs import ArchBundle, TrainConfig, get_reduced
    from repro_torch.runtime.train_loop import train_state_init

    cfg = dataclasses.replace(get_reduced("granite-3-8b"), n_layers=1)
    st = train_state_init(0, cfg, ArchBundle(model=cfg, train=TrainConfig()), device="cpu")

    class _Full:
        def restore_latest(self, state_like):
            return 3, state_like, {}

    step, got = t_elastic.reshard_restore(_Full(), st, torch.device("cpu"))
    assert step == 3 and got.step == st.step
    assert {p.device.type for p in got.params.parameters()} == {"cpu"}
    assert {t.device.type for t in [*got.opt.mu.values(), *got.opt.nu.values()]} == {"cpu"}
    assert list(got.opt.mu) == list(st.opt.mu)


@BOTH
def test_speculative_copies(m):
    done = {0: 1.0, 1: 1.2, 2: None}
    running = {2: 0.5}
    assert m.strag.speculative_copies(done, 1.5, running) == []
    assert m.strag.speculative_copies(done, 3.0, running) == [2]


def test_straggler_helpers_match_reference():
    rates = [4.0, 4.2, 3.9, 0.5, 4.1]
    assert [dataclasses.astuple(r) for r in t_strag.detect_stragglers(rates)] == \
        [dataclasses.astuple(r) for r in j_strag.detect_stragglers(rates)]
    assert t_strag.detect_stragglers([1.0, 1.0, 1.0]) == []
    for args in ((12.0, 8, [1.0, 0.4, 0.7]), (5.0, 3, [0.25])):
        assert t_strag.claim1_bound(*args) == j_strag.claim1_bound(*args)
    for speeds in ([1.0, 0.4], [1.0, 0.5, 0.25]):
        assert t_strag.verify_claim1(20.0, 40, speeds, 0.05) == \
            j_strag.verify_claim1(20.0, 40, speeds, 0.05)
    assert t_strag.rebalance_after_loss([1.0, 2.0, 1.0], [1]) == \
        j_strag.rebalance_after_loss([1.0, 2.0, 1.0], [1])
    with pytest.raises(ValueError, match="all executors lost"):
        t_strag.rebalance_after_loss([1.0], [0])


def test_speculation_candidates_match_reference():
    got = []
    for m in (REF, PORT):
        mon = m.ft.FleetMonitor(["a", "b"], speculation=m.spec.SpeculativeCopies(
            quantile=0.5, factor=1.5, min_completed=2))
        got.append([mon.speculation_candidates(now, [1.0, 1.2, 0.9],
                                               {"t1": 0.0, "t2": 1.0, "t3": 2.5},
                                               {"t1": 40.0})
                    for now in (1.0, 2.0, 2.5, 4.0)])
        mon.remove("a")
        mon.add("c", 3.0)
        got[-1].append(mon.alive())
    assert got[1] == got[0]
