"""HeMT-DP training in the port: twins of tests/test_runtime.py's trainer
tests, the port's trainer against the JAX package's on the same converted
params and corpus, and the verbatim copies of the planner, the grains and
the corpus against their originals. All on the CPU; the ``gpu`` test runs
a few steps on a card against the CPU.

The JAX side is imported inside fixtures and tests, so ``-m gpu`` runs
where only torch is installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ArchBundle, TrainConfig, get_reduced
from repro_torch.core.planner import GrainPlanner, WorkStealingQueue
from repro_torch.data.grains import GrainSource, plan_grain_ranges
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec
from repro_torch.runtime.train_loop import (
    grain_acc_init, make_apply_step, make_grain_accumulate, make_grain_step,
    make_train_step, train_state_init,
)

torch.set_num_threads(2)


def _tiny(dtype=None):
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), n_layers=2)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    bundle = ArchBundle(model=cfg, train=TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    return cfg, bundle


def _state(cfg, bundle):
    return train_state_init(0, cfg, bundle, device="cpu")


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


# --- twins of tests/test_runtime.py ----------------------------------------------

def test_grain_accumulation_matches_full_batch():
    cfg, bundle = _tiny()
    corpus = SyntheticCorpus(cfg.vocab_size, 32, seed=1)
    batch = _torch_batch(corpus.batch(range(8)))

    s_full, m_full = make_train_step(cfg, bundle)(_state(cfg, bundle), batch)
    state0 = _state(cfg, bundle)
    grain_step = make_grain_step(cfg, bundle)
    apply_step = make_apply_step(cfg, bundle)
    acc = grain_acc_init(state0.params)
    for lo in range(0, 8, 2):
        acc = grain_step(state0.params, acc, {k: v[lo:lo + 2] for k, v in batch.items()})
    s_acc, m_acc = apply_step(state0, acc, 4)

    # same loss (mean of grain means == full-batch mean: equal grain sizes)
    assert float(m_acc["loss"]) == pytest.approx(float(m_full["loss"]), rel=1e-5)
    full = dict(s_full.params.named_parameters())
    err = max(float((p.detach().float() - full[n].detach().float()).abs().max())
              for n, p in s_acc.params.named_parameters())
    assert err < 5e-2  # bf16 params, fp32 math


def test_training_descends():
    cfg, bundle = _tiny()
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("s0"), SliceSpec("s1")], grain_batch=2,
                     global_batch=8, seq_len=32, mode="hemt", device="cpu")
    st = _state(cfg, bundle)
    losses = []
    for _ in range(12):
        st, rep = tr.run_step(st)
        losses.append(rep.loss)
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_mode_ordering_under_heterogeneity():
    cfg, bundle = _tiny()
    slices = [SliceSpec("fast", [(0.0, 1.0)], 0.05), SliceSpec("slow", [(0.0, 0.4)], 0.05)]
    results = {}
    for mode in ("hemt", "homt", "static-even"):
        tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=16, seq_len=16,
                         mode=mode, grain_cost=1.0, device="cpu")
        tr.run(_state(cfg, bundle), 6)
        results[mode] = float(np.mean([r.makespan for r in tr.reports[2:]]))
    # HeMT <= HomT <= static-even (paper's core claim)
    assert results["hemt"] < results["homt"] < results["static-even"]


def test_identical_math_across_modes():
    cfg, bundle = _tiny()
    slices = [SliceSpec("fast", [(0.0, 1.0)]), SliceSpec("slow", [(0.0, 0.4)])]
    finals = {}
    for mode in ("hemt", "homt", "static-even"):
        tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=8, seq_len=16,
                         mode=mode, device="cpu")
        tr.run(_state(cfg, bundle), 3)
        finals[mode] = float(tr.reports[-1].loss)
    assert finals["hemt"] == pytest.approx(finals["homt"], abs=1e-6)
    assert finals["hemt"] == pytest.approx(finals["static-even"], abs=1e-6)


def test_run_step_issues_one_accumulate_dispatch_per_step():
    """All grains of a step are folded by one grain-accumulate call."""
    cfg, bundle = _tiny()
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("s0"), SliceSpec("s1")], grain_batch=2,
                     global_batch=16, seq_len=16, mode="hemt", device="cpu")
    calls = []
    inner = tr.grain_accumulate

    def counted(params, acc, grains):
        calls.append(grains["tokens"].shape[0])
        return inner(params, acc, grains)

    tr.grain_accumulate = counted
    tr.run(_state(cfg, bundle), 3)      # 3 steps x 8 grains each
    assert tr.grain_dispatches == 3 and calls == [8, 8, 8]


def test_batched_accumulate_matches_per_grain_loop():
    cfg, bundle = _tiny()
    corpus = SyntheticCorpus(cfg.vocab_size, 16, seed=3)
    batches = [corpus.batch(range(i * 2, i * 2 + 2)) for i in range(4)]
    state = _state(cfg, bundle)
    grain_step = make_grain_step(cfg, bundle)
    acc_loop = grain_acc_init(state.params)
    for b in batches:
        acc_loop = grain_step(state.params, acc_loop, _torch_batch(b))
    stacked = _torch_batch({k: np.stack([b[k] for b in batches]) for k in batches[0]})
    acc_all = make_grain_accumulate(cfg, bundle)(state.params, grain_acc_init(state.params),
                                                 stacked)
    assert acc_all.n == acc_loop.n == 4
    assert float(acc_all.loss_sum) == pytest.approx(float(acc_loop.loss_sum), rel=1e-5)
    assert max(float((acc_loop.grads[n] - g).abs().max())
               for n, g in acc_all.grads.items()) < 1e-4


def test_trainer_modes_and_entry_points(monkeypatch):
    cfg, bundle = _tiny()
    with pytest.raises(ValueError, match="mode must be one of"):
        HeMTTrainer(cfg, bundle, [SliceSpec("a")], grain_batch=2, global_batch=4,
                    seq_len=8, mode="oa", device="cpu")
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("a")], grain_batch=2, global_batch=4,
                     seq_len=8, mode="oa-hemt", device="cpu")
    assert tr.planner.mode == "hemt" and tr.exhausted is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeMTTrainer(cfg, bundle, [SliceSpec("a")], grain_batch=2, global_batch=4, seq_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_init(0, cfg, bundle)


def test_resize_keeps_survivor_estimates():
    cfg, bundle = _tiny()
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("a"), SliceSpec("b", [(0.0, 0.5)])],
                     grain_batch=2, global_batch=8, seq_len=8, mode="hemt", device="cpu")
    st = tr.run(_state(cfg, bundle), 2)
    speed_a = tr.planner.estimator.speed("a")
    tr.resize([SliceSpec("a"), SliceSpec("c")])
    assert tr.planner.estimator.speed("a") == speed_a
    st, rep = tr.run_step(st)
    assert set(rep.grain_counts) == {"a", "c"} and sum(rep.grain_counts.values()) == 4
    assert tr.total_time() == pytest.approx(sum(r.makespan for r in tr.reports))
    assert tr.mean_idle() >= 0.0


# --- across packages ----------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [("granite-3-8b", "hemt"), ("mamba2-2.7b", "hemt"),
                                       ("granite-3-8b", "homt"),
                                       ("granite-3-8b", "static-even")])
def test_trainer_matches_reference_trainer(arch, mode):
    """The same converted params, corpus and slices: identical grain
    counts, elapsed times and makespans, per-step losses within 1e-4
    relative (float32; AdamW's normalised first steps amplify the summation
    order's last bits a little), and the parameters after the last step
    within 1e-4."""
    import jax

    from repro.configs import ArchBundle as JBundle
    from repro.configs import TrainConfig as JTrain
    from repro.configs import get_reduced as j_get_reduced
    from repro.runtime import hemt_driver as jhd
    from repro.runtime import train_loop as jtl
    from repro_torch.runtime.train_loop import train_state_from_params

    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    jb, tb = JBundle(model=jcfg, train=JTrain(**tc)), ArchBundle(model=tcfg, train=TrainConfig(**tc))
    kw = dict(grain_batch=2, global_batch=8, seq_len=16, mode=mode, grain_cost=1.0)
    jslices = [jhd.SliceSpec("fast", [(0.0, 1.0)], 0.05),
               jhd.SliceSpec("slow", [(0.0, 0.4), (6.0, 1.0)], 0.05)]
    tslices = [SliceSpec(s.name, s.profile, s.grain_overhead) for s in jslices]
    jtr = jhd.HeMTTrainer(jcfg, jb, jslices, **kw)
    ttr = HeMTTrainer(tcfg, tb, tslices, device="cpu", **kw)
    jst = jtl.train_state_init(jax.random.PRNGKey(0), jcfg, jb)
    tst = train_state_from_params(
        convert.from_jax_params(jax.tree.map(np.asarray, jst.params), tcfg, device="cpu"), tb)
    jst = jtr.run(jst, 4)
    tst = ttr.run(tst, 4)
    for j, t in zip(jtr.reports, ttr.reports):
        assert (t.step, t.mode, t.grain_counts, t.slice_elapsed, t.makespan, t.idle_time,
                t.steals) == (j.step, j.mode, j.grain_counts, j.slice_elapsed, j.makespan,
                              j.idle_time, j.steals)
        assert t.loss == pytest.approx(j.loss, rel=1e-4)
    assert ttr.total_time() == jtr.total_time() and ttr.mean_idle() == jtr.mean_idle()
    got = convert.to_jax_layout(tst.params, tcfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(
                                     jax.tree.map(np.asarray, jst.params))[0]):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=jax.tree_util.keystr(path))


# --- the windowed mode (oa-hemt): twins of tests/test_oa_hemt.py and test_runtime.py ---

def _window_pair(arch, slices, *, global_batch=16, grain_cost=1.0, dtype="float32"):
    """The reference's and the port's oa-hemt trainers over the same slices,
    and their states from the same converted params."""
    import jax

    from repro.configs import ArchBundle as JBundle
    from repro.configs import TrainConfig as JTrain
    from repro.configs import get_reduced as j_get_reduced
    from repro.runtime import hemt_driver as jhd
    from repro.runtime import train_loop as jtl
    from repro_torch.runtime.train_loop import train_state_from_params

    jcfg = dataclasses.replace(j_get_reduced(arch), n_layers=2, dtype=dtype)
    tcfg = dataclasses.replace(get_reduced(arch), n_layers=2, dtype=dtype)
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    jb, tb = JBundle(model=jcfg, train=JTrain(**tc)), ArchBundle(model=tcfg, train=TrainConfig(**tc))
    kw = dict(grain_batch=2, global_batch=global_batch, seq_len=16, mode="oa-hemt",
              grain_cost=grain_cost)
    jtr = jhd.HeMTTrainer(jcfg, jb, [jhd.SliceSpec(*s) for s in slices], **kw)
    ttr = HeMTTrainer(tcfg, tb, [SliceSpec(*s) for s in slices], device="cpu", **kw)
    jst = jtl.train_state_init(jax.random.PRNGKey(0), jcfg, jb)
    tst = train_state_from_params(
        convert.from_jax_params(jax.tree.map(np.asarray, jst.params), tcfg, device="cpu"), tb)
    return (jtr, jst), (ttr, tst, tcfg)


def _assert_reports_equal(jtr, ttr, loss_rel):
    assert len(ttr.reports) == len(jtr.reports)
    for j, t in zip(jtr.reports, ttr.reports):
        assert (t.step, t.mode, t.grain_counts, t.slice_elapsed, t.makespan, t.idle_time,
                t.steals) == (j.step, j.mode, j.grain_counts, j.slice_elapsed, j.makespan,
                              j.idle_time, j.steals)
        assert t.loss == pytest.approx(j.loss, rel=loss_rel)
    assert [s.name for s in ttr.slices] == [s.name for s in jtr.slices]
    assert ttr.exhausted == jtr.exhausted
    assert ttr.planner.estimator.known() == jtr.planner.estimator.known()
    assert [dataclasses.astuple(p) for p in ttr.planner.step_log] == \
        [dataclasses.astuple(p) for p in jtr.planner.step_log]


def _assert_params_close(jst, tst, tcfg, atol):
    import jax

    got = convert.to_jax_layout(tst.params, tcfg)
    want = jax.tree.map(np.asarray, jst.params)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_trainer_oa_hemt_window_adapts_and_keeps_math():
    """mode='oa-hemt': one adaptive resident-calendar pass schedules the
    whole window (per-barrier grain re-splits, whole-grain quantum) while
    the math stays a real grain-accumulated update per step."""
    cfg, bundle = _tiny()
    slices = [SliceSpec("fast", [(0.0, 1.0)], 0.05), SliceSpec("slow", [(0.0, 0.4)], 0.05)]
    tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=16, seq_len=16,
                     mode="oa-hemt", grain_cost=2.0, device="cpu")
    st = tr.run_window(_state(cfg, bundle), 5)
    assert int(st.step) == 5 and tr.grain_dispatches == 5 and len(tr.reports) == 5
    # grains/sec in the shared estimator: fast ran 6 grains in 0.05 + 12.0 s
    assert tr.planner.estimator.speed("fast") == pytest.approx(6.0 / 12.05, rel=1e-3)
    st, rep = tr.run_step(st)           # per-step path on the same state
    assert tr.planner.estimator.speed("fast") == pytest.approx(0.49, rel=0.05)
    for rep in tr.reports:
        assert sum(rep.grain_counts.values()) == tr.n_grains
        assert np.isfinite(rep.loss)
    assert tr.reports[0].grain_counts == {"fast": 4, "slow": 4}
    assert tr.reports[-1].grain_counts["fast"] > tr.reports[-1].grain_counts["slow"]
    assert tr.reports[-1].makespan < tr.reports[0].makespan


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_trainer_oa_hemt_window_matches_reference(arch):
    """The same window in both packages (float32): equal grain counts,
    elapsed times, makespans, idles and estimator speeds; losses and the
    parameters after the window within 1e-5."""
    (jtr, jst), (ttr, tst, tcfg) = _window_pair(
        arch, [("fast", [(0.0, 1.0)], 0.05), ("slow", [(0.0, 0.4)], 0.05)], grain_cost=2.0)
    jst = jtr.run_window(jst, 5)
    tst = ttr.run_window(tst, 5)
    _assert_reports_equal(jtr, ttr, 1e-5)
    assert ttr.planner.estimator.speed("fast") == jtr.planner.estimator.speed("fast")
    assert ttr.total_time() == jtr.total_time() and tst.step == int(jst.step) == 5
    _assert_params_close(jst, tst, tcfg, 1e-5)
    # a per-step step after the window, on both
    jst, _ = jtr.run_step(jst)
    tst, _ = ttr.run_step(tst)
    _assert_reports_equal(jtr, ttr, 1e-5)


def _crash_window(m, tr, st):
    trace = m.faults.FaultTrace((m.faults.NodeCrash(1, 6.0),))    # permanent, mid-step-1
    mon = m.ft.FleetMonitor(["fast", "slow"], timeout=4.0)
    return tr.run_window(st, 6, faults=trace, monitor=mon), mon


def test_trainer_window_detects_crash_and_replans_survivors():
    """A fault trace kills a slice mid-window, its heartbeats stop, the
    FleetMonitor declares it dead, and elastic.replan drops it — all in one
    run_window call — in both packages alike."""
    from types import SimpleNamespace

    from repro.core import faults as j_faults
    from repro.runtime import ft as j_ft
    from repro_torch.core import faults as t_faults
    from repro_torch.runtime import ft as t_ft

    (jtr, jst), (ttr, tst, tcfg) = _window_pair(
        "granite-3-8b", [("fast", [(0.0, 1.0)], 0.05), ("slow", [(0.0, 1.0)], 0.05)])
    jst, jmon = _crash_window(SimpleNamespace(faults=j_faults, ft=j_ft), jtr, jst)
    tst, tmon = _crash_window(SimpleNamespace(faults=t_faults, ft=t_ft), ttr, tst)
    assert tst.step == 6 and len(ttr.reports) == 6
    assert [s.name for s in ttr.slices] == ["fast"] and tmon.alive() == ["fast"]
    assert [e.slice_name for e in tmon.events if e.kind == "dead"] == ["slow"]
    for rep in ttr.reports:
        assert sum(rep.grain_counts.values()) == ttr.n_grains
        assert np.isfinite(rep.loss)
    assert ttr.reports[-1].grain_counts == {"fast": 8}
    _assert_reports_equal(jtr, ttr, 1e-5)
    assert [dataclasses.astuple(e) for e in tmon.events] == \
        [dataclasses.astuple(e) for e in jmon.events]
    _assert_params_close(jst, tst, tcfg, 1e-5)


def test_trainer_per_step_mode_rejects_fault_wiring():
    from repro_torch.core.faults import FaultTrace, NodeCrash
    from repro_torch.runtime.ft import FleetMonitor

    cfg, bundle = _tiny()
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("a", [(0.0, 1.0)], 0.05)], grain_batch=2,
                     global_batch=4, seq_len=16, mode="hemt", device="cpu")
    st = _state(cfg, bundle)
    with pytest.raises(ValueError, match="windowed scheduling"):
        tr.run_window(st, 1, faults=FaultTrace((NodeCrash(0, 1.0),)))
    with pytest.raises(ValueError, match="windowed scheduling"):
        tr.run_window(st, 1, monitor=FleetMonitor(["a"]))
    st = tr.run_window(st, 2)           # no wiring: per-step scheduling
    assert st.step == 2 and len(tr.reports) == 2


def test_trainer_window_exhausted_fleet_halts_gracefully():
    """The whole fleet dies mid-window: the stranded tail is abandoned, the
    FleetExhaustedError is absorbed into ``exhausted``, and the monitor logs
    the terminal event — as in the reference."""
    import jax

    from repro.configs import ArchBundle as JBundle
    from repro.configs import TrainConfig as JTrain
    from repro.configs import get_reduced as j_get_reduced
    from repro.core.faults import FaultTrace as JTrace
    from repro.core.faults import NodeCrash as JCrash
    from repro.runtime import hemt_driver as jhd
    from repro.runtime import train_loop as jtl
    from repro.runtime.ft import FleetMonitor as JMonitor
    from repro_torch.core.faults import FaultTrace, NodeCrash
    from repro_torch.runtime.ft import FleetMonitor

    cfg, bundle = _tiny()
    kw = dict(grain_batch=2, global_batch=4, seq_len=16, mode="oa-hemt", grain_cost=1.0)
    tr = HeMTTrainer(cfg, bundle, [SliceSpec("solo", [(0.0, 1.0)], 0.05)], device="cpu", **kw)
    m = FleetMonitor(["solo"], timeout=4.0)
    assert tr.exhausted is None
    # step 0 finishes (~2.05 s); the permanent crash at 3.0 strands the rest
    st = tr.run_window(_state(cfg, bundle), 3, faults=FaultTrace((NodeCrash(0, 3.0),)),
                       monitor=m)
    assert st.step == 1 and len(tr.reports) == 1
    assert tr.slices == []
    assert tr.exhausted is not None and "solo" in tr.exhausted
    assert m.exhausted
    term = [e for e in m.events if e.kind == "exhausted"]
    assert len(term) == 1 and term[0].slice_name == "*" and "solo" in term[0].detail

    jcfg = dataclasses.replace(j_get_reduced("granite-3-8b"), n_layers=2)
    jb = JBundle(model=jcfg, train=JTrain(lr=1e-3, warmup_steps=2, total_steps=50))
    jtr = jhd.HeMTTrainer(jcfg, jb, [jhd.SliceSpec("solo", [(0.0, 1.0)], 0.05)], **kw)
    jm = JMonitor(["solo"], timeout=4.0)
    jtr.run_window(jtl.train_state_init(jax.random.PRNGKey(0), jcfg, jb), 3,
                   faults=JTrace((JCrash(0, 3.0),)), monitor=jm)
    assert tr.exhausted == jtr.exhausted
    assert [dataclasses.astuple(e) for e in m.events] == \
        [dataclasses.astuple(e) for e in jm.events]
    assert [(r.grain_counts, r.makespan, r.idle_time) for r in tr.reports] == \
        [(r.grain_counts, r.makespan, r.idle_time) for r in jtr.reports]


# --- the verbatim copies ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_and_grains_copies_give_the_same_tokens(seed):
    from repro.data import grains as j_grains
    from repro.data import pipeline as j_pipe
    jc, tc = j_pipe.SyntheticCorpus(300, 24, seed=seed), SyntheticCorpus(300, 24, seed=seed)
    for i in (0, 1, 17, 10_000):
        for k, v in jc.sample(i).items():
            np.testing.assert_array_equal(tc.sample(i)[k], v)
    ja = j_grains.plan_grain_ranges(3, 16, 2, ["a", "b"], [5, 3])
    ta = plan_grain_ranges(3, 16, 2, ["a", "b"], [5, 3])
    assert [dataclasses.astuple(g) for gs in ta.per_slice.values() for g in gs] == \
        [dataclasses.astuple(g) for gs in ja.per_slice.values() for g in gs]
    assert ta.counts() == ja.counts()
    grains = [g for gs in ta.per_slice.values() for g in gs]
    jblock = j_grains.GrainSource(jc, 2).load_stacked(
        [g for gs in ja.per_slice.values() for g in gs])
    tblock = GrainSource(tc, 2).load_stacked(grains)
    for k in jblock:
        np.testing.assert_array_equal(tblock[k], jblock[k])
    with pytest.raises(ValueError, match="grain counts"):
        plan_grain_ranges(0, 16, 2, ["a"], [3])


def test_planner_copy_plans_like_the_original():
    from repro.core import planner as j_planner
    obs = [{"a": {"grains": 4, "elapsed": 1.0}, "b": {"grains": 4, "elapsed": 2.0},
            "c": {"grains": 4, "elapsed": 4.0}},
           {"a": {"grains": 7, "elapsed": 1.5}, "b": {"grains": 3, "elapsed": 2.5},
            "c": {"grains": 2, "elapsed": 3.0}}]
    for mode in ("hemt", "homt"):
        jp = j_planner.GrainPlanner(["a", "b", "c"], alpha=0.3, mode=mode)
        tp = GrainPlanner(["a", "b", "c"], alpha=0.3, mode=mode)
        for o in obs:
            assert dataclasses.astuple(tp.plan(14)) == dataclasses.astuple(jp.plan(14))
            jp.observe_step(o)
            tp.observe_step(o)
        tp.resize(["a", "c", "d"])
        jp.resize(["a", "c", "d"])
        assert dataclasses.astuple(tp.plan(11)) == dataclasses.astuple(jp.plan(11))
        assert tp.predicted_barrier_idle(tp.step_log[-1]) == \
            jp.predicted_barrier_idle(jp.step_log[-1])
    q = WorkStealingQueue()
    q.seed(10)
    assert q.pull(3) == [0, 1, 2] and len(q) == 7 and q.steals == 1


# --- on the card ------------------------------------------------------------------------

@pytest.mark.gpu
def test_trainer_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, bundle = _tiny("float32")
    slices = [SliceSpec("fast", [(0.0, 1.0)], 0.05), SliceSpec("slow", [(0.0, 0.4)], 0.05)]
    reports = {}
    for dev in ("cpu", "cuda"):
        tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=8, seq_len=16,
                         mode="hemt", device=dev)
        params = convert.from_jax_params(convert.to_jax_layout(
            train_state_init(0, cfg, bundle, device="cpu").params, cfg), cfg, device=dev)
        from repro_torch.runtime.train_loop import train_state_from_params
        tr.run(train_state_from_params(params, bundle), 3)
        reports[dev] = tr.reports
    for c, g in zip(reports["cpu"], reports["cuda"]):
        assert (g.grain_counts, g.makespan) == (c.grain_counts, c.makespan)
        assert g.loss == pytest.approx(c.loss, rel=1e-4)


@pytest.mark.gpu
def test_trainer_window_on_card_matches_cpu():
    """An oa-hemt window with a crash and a monitor on the card: the same
    schedule, monitor events and surviving slices as on the CPU, losses
    within 1e-4 (float32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.faults import FaultTrace, NodeCrash
    from repro_torch.runtime.ft import FleetMonitor
    from repro_torch.runtime.train_loop import train_state_from_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, bundle = _tiny("float32")
    slices = [SliceSpec("a", [(0.0, 1.0)], 0.05), SliceSpec("b", [(0.0, 1.0)], 0.05),
              SliceSpec("c", [(0.0, 0.4)], 0.05)]
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = HeMTTrainer(cfg, bundle, slices, grain_batch=2, global_batch=24, seq_len=16,
                         mode="oa-hemt", device=dev)
        params = convert.from_jax_params(convert.to_jax_layout(
            train_state_init(0, cfg, bundle, device="cpu").params, cfg), cfg, device=dev)
        mon = FleetMonitor(["a", "b", "c"], timeout=6.0)
        st = tr.run_window(train_state_from_params(params, bundle), 4,
                           faults=FaultTrace((NodeCrash(1, 4.0),)), monitor=mon)
        assert st.params["embed"]["table"].device.type == dev
        runs[dev] = (tr, mon)
    (c, cmon), (g, gmon) = runs["cpu"], runs["cuda"]
    assert [s.name for s in g.slices] == [s.name for s in c.slices] == ["a", "c"]
    assert [dataclasses.astuple(e) for e in gmon.events] == \
        [dataclasses.astuple(e) for e in cmon.events]
    for cr, gr in zip(c.reports, g.reports):
        assert (gr.grain_counts, gr.makespan, gr.idle_time) == \
            (cr.grain_counts, cr.makespan, cr.idle_time)
        assert gr.loss == pytest.approx(cr.loss, rel=1e-4)
