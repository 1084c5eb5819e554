"""Job-level schedulers: OA-HeMT adaptation loop, HomT baseline, provisioned
and burstable HeMT — paper §5, §6.

Copy of the JAX package's ``repro/core/scheduler.py`` (pure Python), imports
pointed at ``repro_torch.core``.

`AdaptiveHeMTScheduler` drives a sequence of same-class jobs (paper: fifty
WordCount jobs through a submission queue; here also: a sequence of training
steps): partition by current speed estimates -> run (simulated or real) ->
feed observed (d_i, t_i) back into the AR(1) estimator.

All schedulers simulate through ``run_pull_stage``/``run_static_stage`` and
therefore ride the fast-path engine (``repro_torch.core.engine``): the constant-
speed stages every scheduler below emits take the vectorized closed forms,
so job sweeps (Fig 7/8/13) scale to large task counts.  ``MultiStageJob``
goes one further: it hands the whole stage sequence to ``engine.run_job``,
which carries per-node finish vectors across the program barriers —
an S-stage HomT/HeMT job costs O(S·n) instead of S separate engine entries
materializing task records per stage.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.capacity import BurstableNode, burstable_split
from repro_torch.core.estimators import ARSpeedEstimator, FudgeFactorLearner
from repro_torch.core.partitioner import hemt_split_floats
from repro_torch.core.simulator import (
    SimNode, SimTask, StageResult, run_pull_stage, run_static_stage,
)


@dataclass
class JobResult:
    job_index: int
    completion: float
    idle_time: float
    split: List[float]
    speeds_used: List[float]


class AdaptiveHeMTScheduler:
    """Oblivious-Adaptive HeMT (paper §5).

    First job: even split (the paper's k=1 rule). Afterwards d_i ~ v_i.

    ``mitigation`` (an event-level policy from ``repro_torch.core.speculation``,
    e.g. WorkStealing/SpeculativeCopies) covers the window where estimates
    are stale — the very first job's even split, and every job after an
    un-observed capacity change — by letting idle executors rescue the
    straggler instead of idling until the barrier (paper §5's OA-HeMT
    discussion).  Speed observations then use *executed* work per node (a
    stolen-from node must not be credited for work it handed off).
    """

    def __init__(self, executors: Sequence[str], alpha: float = 0.0,
                 min_share: float = 0.0, mitigation=None):
        # NB: the paper's Fig 7 experiment uses *zero* forgetting factor.
        self.executors = list(executors)
        self.estimator = ARSpeedEstimator(alpha=alpha)
        self.min_share = min_share
        self.mitigation = mitigation
        self.history: List[JobResult] = []

    def plan(self, total_work: float) -> List[float]:
        if not self.estimator.known():
            n = len(self.executors)
            return [total_work / n] * n
        speeds = self.estimator.speeds(self.executors)
        split = hemt_split_floats(total_work, speeds)
        if self.min_share > 0:
            floor = self.min_share * total_work
            split = [max(s, floor) for s in split]
            scale = total_work / sum(split)
            split = [s * scale for s in split]
        return split

    def adaptive_plan(self, quantum: Optional[float] = None,
                      min_units: int = 0):
        """An :class:`~repro_torch.core.engine.AdaptivePlan` sharing THIS
        scheduler's estimator, for handing to ``run_job``/
        ``MultiStageJob.run``: barrier-level observations inside a job and
        job-level observations across the submission queue accumulate into
        the same workload-specific AR(1) state (paper §5.1)."""
        from repro_torch.core.engine import AdaptivePlan
        return AdaptivePlan(estimator=self.estimator, quantum=quantum,
                            min_units=min_units)

    def run_simulated_job(self, nodes: Sequence[SimNode],
                          stage_works: Sequence[float],
                          adaptive: bool = True) -> List[JobResult]:
        """Run ONE multi-stage job (program barriers between stages)
        through ``engine.run_job``, re-planning every stage's split at its
        barrier from the shared estimator when ``adaptive`` (the paper's
        OA-HeMT loop; ``adaptive=False`` is the stale-static baseline that
        keeps the submission-time splits).  Per-stage results are appended
        to ``history`` exactly like per-job results from
        :meth:`run_simulated_sequence`."""
        from repro_torch.core.engine import StaticSpec, run_job
        specs = [StaticSpec(works=tuple(self.plan(w))) for w in stage_works]
        plan = self.adaptive_plan() if adaptive else None
        base = len(self.history)
        sched = run_job(nodes, specs, adaptive=plan)
        for k, summ in enumerate(sched.stages):
            split = [summ.work.get(nd.name, 0.0) for nd in nodes]
            if not adaptive:
                # keep the estimator in the loop even without re-planning
                # (a stale-static scheduler still observes, paper §5)
                for nd, w in zip(nodes, split):
                    dt = summ.node_finish[nd.name] - summ.start
                    if w > 0.0 and dt > 0.0:
                        self.estimator.observe(nd.name, w, dt)
            speeds = self.estimator.speeds([nd.name for nd in nodes])
            self.history.append(JobResult(base + k, summ.span,
                                          summ.idle_time, split, speeds))
        return self.history[base:]

    def record(self, job_index: int, split: Sequence[float],
               elapsed: Sequence[float], result: Optional[StageResult] = None,
               ) -> None:
        for ex, d, t in zip(self.executors, split, elapsed):
            if d > 0 and t > 0:
                self.estimator.observe(ex, d, t)
        speeds = self.estimator.speeds(self.executors)
        comp = max(elapsed)
        idle = comp - min(elapsed)
        if result is not None:
            comp, idle = result.completion, result.idle_time
        self.history.append(JobResult(job_index, comp, idle, list(split), speeds))

    # -- simulation driver ---------------------------------------------------
    def run_simulated_sequence(self, node_factory: Callable[[int], List[SimNode]],
                               n_jobs: int, total_work: float,
                               io_mb_total: float = 0.0,
                               uplink_bw: Optional[float] = None,
                               datanode: int = 0) -> List[JobResult]:
        """Run n_jobs jobs; node_factory(k) returns the cluster as it exists
        at job k (speed profiles relative to job start — lets benchmarks
        inject interference at chosen job indices, paper Fig 7).

        ``io_mb_total`` + ``uplink_bw`` put each job's input behind the
        flow-shared uplink of ``datanode`` (macrotasks read a
        works-proportional share): with an I/O-aware mitigation policy,
        stale-estimate stragglers are rescued by duplicate readers
        re-fetching through the same uplink (the Claim 2 x mitigation
        cross setting)."""
        for k in range(n_jobs):
            nodes = node_factory(k)
            split = self.plan(total_work)
            assignments = [
                [SimTask(w, io_mb_total * w / total_work if io_mb_total > 0
                         else 0.0,
                         datanode if io_mb_total > 0 else -1, task_id=i)]
                for i, w in enumerate(split)]
            res = run_static_stage(nodes, assignments, uplink_bw=uplink_bw,
                                   mitigation=self.mitigation)
            per_node_elapsed = [res.node_finish[nd.name] for nd in nodes]
            if self.mitigation is not None:
                # mitigation moves work between nodes: feed the estimator
                # the work each node actually executed, not the plan
                executed = {nd.name: 0.0 for nd in nodes}
                win_end: Dict[int, float] = {}
                for r in res.records:
                    executed[r.node] += r.cpu_work
                    win_end[r.task_id] = r.end
                split_observed = [executed[nd.name] for nd in nodes]
                for i, nd in enumerate(nodes):
                    if split_observed[i] > 0.0 or split[i] <= 0.0:
                        continue
                    # a straggler whose only attempt was cancelled by a
                    # winning speculative copy left no record — credit the
                    # partial progress its executor would report (real
                    # drivers see a killed attempt's progress counters),
                    # else the estimator never observes the degraded speed
                    # the mitigation exists to cover
                    t_cancel = win_end.get(i)
                    if t_cancel is not None and t_cancel > 0.0:
                        split_observed[i] = min(
                            split[i],
                            nodes[i].work_between(nd.task_overhead, t_cancel))
                        per_node_elapsed[i] = t_cancel
            else:
                split_observed = split
            self.record(k, split_observed, per_node_elapsed, res)
        return self.history


class HomTScheduler:
    """Homogeneous microtasking baseline with a configurable task count."""

    def __init__(self, n_tasks: int):
        self.n_tasks = n_tasks

    def run_simulated(self, nodes: Sequence[SimNode], total_work: float,
                      ) -> StageResult:
        per = total_work / self.n_tasks
        tasks = [SimTask(per, task_id=i) for i in range(self.n_tasks)]
        return run_pull_stage(nodes, tasks)


class ProvisionedHeMTScheduler:
    """§6.1: split by known static resource shares (e.g. Mesos offers of
    1.0 and 0.4 CPUs), optionally corrected by a learned fudge factor."""

    def __init__(self, shares: Sequence[float],
                 fudge: Optional[FudgeFactorLearner] = None,
                 fudge_index: int = -1):
        self.shares = list(shares)
        self.fudge = fudge
        self.fudge_index = fudge_index  # which executor the fudge applies to

    def effective_shares(self) -> List[float]:
        s = list(self.shares)
        if self.fudge is not None and 0 <= self.fudge_index < len(s):
            fastest = max(s)
            s[self.fudge_index] = fastest * self.fudge.effective
        return s

    def plan(self, total_work: float) -> List[float]:
        return hemt_split_floats(total_work, self.effective_shares())

    def run_simulated(self, nodes: Sequence[SimNode], total_work: float,
                      ) -> StageResult:
        split = self.plan(total_work)
        assignments = [[SimTask(w, task_id=i)] for i, w in enumerate(split)]
        return run_static_stage(nodes, assignments)


class BurstableHeMTScheduler:
    """§6.2: split by superposed token-bucket workload curves W_i(t')."""

    def __init__(self, nodes: Sequence[BurstableNode]):
        self.bnodes = list(nodes)

    def plan(self, total_work: float) -> Tuple[List[float], float]:
        return burstable_split(self.bnodes, total_work)

    def run_simulated(self, total_work: float, overhead: float = 0.0,
                      ) -> StageResult:
        split, _ = self.plan(total_work)
        nodes = [SimNode.burstable(f"b{i}", bn, overhead)
                 for i, bn in enumerate(self.bnodes)]
        assignments = [[SimTask(w, task_id=i)] for i, w in enumerate(split)]
        return run_static_stage(nodes, assignments)


# -- multi-stage jobs (paper §7) ---------------------------------------------

@dataclass
class MultiStageJob:
    """stages: list of per-stage total work; between stages data is shuffled
    by either an even or a capacity-skewed partitioner (Algorithm 1).

    ``stage_io_mb`` (optional, one total per stage) makes each stage read
    its input from ``datanode`` through the flow-shared uplink: HomT
    microtasks each fetch an even share, HeMT macrotasks a
    works-proportional share (``StaticSpec.io_mb`` semantics).  Pass
    ``uplink_bw`` to :meth:`run` to make the I/O effective — the Claim 2 x
    mitigation cross setting, where duplicate readers re-fetch through the
    same shared uplink."""
    stage_works: List[float]
    stage_io_mb: Optional[List[float]] = None
    datanode: int = 0

    def _stage_io(self, k: int) -> float:
        if self.stage_io_mb is None:
            return 0.0
        return self.stage_io_mb[k]

    def specs(self, weights: Optional[Sequence[float]],
              n_tasks_per_stage: Optional[int] = None,
              mitigation=None) -> List:
        """The job as engine stage specs: HomT (weights=None) -> one uniform
        PullSpec per stage; HeMT -> one skewed StaticSpec per stage.
        ``mitigation`` (a ``repro_torch.core.speculation`` policy) rides every
        stage spec — event-level policies run inside each stage,
        ReskewHandoff folds straggler residuals across the barriers."""
        from repro_torch.core.engine import PullSpec, StaticSpec
        if weights is None:
            return [PullSpec(n_tasks=n_tasks_per_stage,
                             task_work=w / n_tasks_per_stage,
                             io_mb=self._stage_io(k) / n_tasks_per_stage,
                             datanode=self.datanode if self._stage_io(k) > 0
                             else -1,
                             mitigation=mitigation)
                    for k, w in enumerate(self.stage_works)]
        norm = sum(weights)
        return [StaticSpec(works=tuple(w * wi / norm for wi in weights),
                           mitigation=mitigation,
                           io_mb=self._stage_io(k),
                           datanode=self.datanode if self._stage_io(k) > 0
                           else -1)
                for k, w in enumerate(self.stage_works)]

    def run(self, nodes: Sequence[SimNode], weights: Optional[Sequence[float]],
            n_tasks_per_stage: Optional[int] = None, records: bool = False,
            mitigation=None, adaptive=None,
            uplink_bw: Optional[float] = None) -> Tuple[float, List]:
        """weights=None -> HomT with n_tasks_per_stage; else HeMT skewed.

        Thin wrapper over ``engine.run_job``: per-node finish vectors are
        carried across the program barriers, so the whole S-stage sequence
        costs O(S·n) on constant-speed clusters (record-free
        ``StageSummary`` per stage).  ``records=True`` re-enters the engine
        once per stage instead and returns full ``StageResult`` objects
        with per-task records (the differential-test / debugging path).
        ``adaptive`` (an :class:`~repro_torch.core.engine.AdaptivePlan`) re-plans
        each HeMT stage's split at its barrier from AR(1)-learned speeds —
        the paper's OA-HeMT loop riding the same run_job call.
        ``uplink_bw`` activates the flow-shared I/O model for stages with
        ``stage_io_mb`` input (both spec and records paths).
        """
        if records:
            from repro_torch.core.speculation import ReskewHandoff
            if adaptive is not None:
                raise ValueError(
                    "records=True re-enters the engine per stage; "
                    "per-barrier adaptive re-planning only runs through "
                    "run_job (records=False)")
            if isinstance(mitigation, ReskewHandoff):
                raise ValueError(
                    "records=True re-enters the engine per stage and cannot "
                    "apply barrier-level ReskewHandoff; use records=False "
                    "(run_job folds residuals across barriers) or an "
                    "event-level policy")
            t, results = 0.0, []
            norm = None if weights is None else sum(weights)
            for k, w in enumerate(self.stage_works):
                io = self._stage_io(k)
                dn = self.datanode if io > 0 else -1
                if weights is None:
                    per = w / n_tasks_per_stage
                    tasks = [SimTask(per, io / n_tasks_per_stage, dn,
                                     task_id=i)
                             for i in range(n_tasks_per_stage)]
                    res = run_pull_stage(nodes, tasks, start_time=t,
                                         uplink_bw=uplink_bw,
                                         mitigation=mitigation)
                else:
                    assignments = [[SimTask(w * wi / norm, io * wi / norm,
                                            dn, task_id=i)]
                                   for i, wi in enumerate(weights)]
                    res = run_static_stage(nodes, assignments, start_time=t,
                                           uplink_bw=uplink_bw,
                                           mitigation=mitigation)
                results.append(res)
                t = res.completion  # program barrier between stages
            return t, results
        from repro_torch.core.engine import run_job
        sched = run_job(nodes, self.specs(weights, n_tasks_per_stage,
                                          mitigation=mitigation),
                        uplink_bw=uplink_bw, adaptive=adaptive)
        return sched.completion, sched.stages
