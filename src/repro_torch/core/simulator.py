"""Discrete-event cluster simulator — the paper's EC2/Mesos testbed in code.

Copy of the JAX package's ``repro/core/simulator.py`` (pure Python), imports
pointed at ``repro_torch.core``. The profile check compares with the integer 0 (the same
test as ``!= 0.0``), so it needs no lint waiver.

Models, per §5-§6 of the paper:
  * nodes with piecewise-constant speed profiles (static container shares,
    interference injections at arbitrary times, burstable token-bucket
    two-segment profiles),
  * per-task overhead (scheduling + launch + I/O setup) — the microtasking
    cost the paper analyzes,
  * pull-based task assignment (HomT; Claim 1's setting) and static
    macrotask assignment (HeMT),
  * a flow-level storage model: tasks read input from datanodes whose
    uplinks are fairly shared by concurrent readers (Claim 2 / Fig 5/15);
    a task completes when both its I/O and CPU work are done.

All times are seconds, work is in abstract units (1 unit = 1 second on a
speed-1.0 node), I/O sizes in MB, bandwidths in MB/s.

``run_pull_stage``/``run_static_stage`` dispatch to the layered fast-path
engine in ``repro_torch.core.engine`` (event calendar + vectorized closed forms);
the ``_run_stage`` rescan loop below is retained as the reference oracle the
engine's differential tests are pinned against.  Whole multi-stage jobs
(``run_job`` + ``PullSpec``/``StaticSpec``/``JobSchedule``/``StageSummary``,
re-exported lazily below to avoid the import cycle) carry per-node finish
vectors across program barriers so S-stage sweeps cost O(S·n) on
constant-speed clusters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.capacity import BurstableNode


# --------------------------------------------------------------------------
# node model
# --------------------------------------------------------------------------

@dataclass
class SimNode:
    """A computing node with a piecewise-constant speed profile.

    profile: [(t_start, speed), ...] sorted by t_start, first at t=0.
    """
    name: str
    profile: List[Tuple[float, float]] = field(default_factory=lambda: [(0.0, 1.0)])
    task_overhead: float = 0.0          # seconds added per task

    def __post_init__(self):
        # constructor contract: profiles are authored literals and must
        # start at exactly t=0; exact != is the validation, not arithmetic
        if not self.profile or self.profile[0][0] != 0:
            raise ValueError("profile must start at t=0")
        for (t0, _), (t1, _) in zip(self.profile, self.profile[1:]):
            if t1 <= t0:
                raise ValueError("profile times must increase")

    @classmethod
    def constant(cls, name: str, speed: float, overhead: float = 0.0) -> "SimNode":
        return cls(name, [(0.0, speed)], overhead)

    @classmethod
    def burstable(cls, name: str, node: BurstableNode, overhead: float = 0.0,
                  ) -> "SimNode":
        """Two-segment profile: peak until credit depletion, then baseline."""
        tb = node.burst_time
        if math.isinf(tb):
            return cls(name, [(0.0, node.peak)], overhead)
        if tb <= 0.0:     # zero credits: at baseline from the start
            return cls(name, [(0.0, node.baseline)], overhead)
        return cls(name, [(0.0, node.peak), (tb, node.baseline)], overhead)

    def speed_at(self, t: float) -> float:
        s = self.profile[0][1]
        for t0, sp in self.profile:
            if t0 <= t:
                s = sp
            else:
                break
        return s

    def work_between(self, t0: float, t1: float) -> float:
        """Integrate speed over [t0, t1]."""
        if t1 <= t0:
            return 0.0
        total, t = 0.0, t0
        segs = self.profile + [(math.inf, 0.0)]
        for (s0, sp), (s1, _) in zip(segs, segs[1:]):
            lo, hi = max(t, s0), min(t1, s1)
            if hi > lo:
                total += sp * (hi - lo)
        return total

    def finish_time(self, work: float, t0: float) -> float:
        """Earliest t with work_between(t0, t) >= work."""
        if work <= 0:
            return t0
        t, rem = t0, work
        segs = self.profile + [(math.inf, 0.0)]
        for (s0, sp), (s1, _) in zip(segs, segs[1:]):
            lo, hi = max(t0, s0), s1
            if hi <= t0:
                continue
            span = hi - lo
            if sp > 0 and rem <= sp * span:
                return lo + rem / sp
            rem -= sp * span
            if math.isinf(hi):
                break
        if rem > 1e-12:
            raise RuntimeError(f"node {self.name} can never finish work={work}")
        return hi


# --------------------------------------------------------------------------
# tasks & storage
# --------------------------------------------------------------------------

@dataclass(slots=True)
class SimTask:
    """cpu_work: seconds-at-speed-1; io_mb: input bytes to fetch;
    datanode: which storage node serves it (-1 = no I/O)."""
    cpu_work: float
    io_mb: float = 0.0
    datanode: int = -1
    task_id: int = -1


class TaskRecord(NamedTuple):
    # NamedTuple (C-level tuple construction) rather than a dataclass: the
    # closed forms and the event calendar materialize one record per task,
    # so construction cost is on every stage's critical path.
    task_id: int
    node: str
    start: float
    end: float
    cpu_work: float


class StageColumns(NamedTuple):
    """Columnar view of a stage's completed attempts, in record order.

    ``node_index`` indexes into ``node_names`` (stage node order), so batch
    consumers can ``np.bincount`` per-node aggregates without touching a
    single ``TaskRecord``.
    """
    task_ids: "np.ndarray"      # int64  [T]
    node_index: "np.ndarray"    # int64  [T]
    starts: "np.ndarray"        # float64 [T]
    ends: "np.ndarray"          # float64 [T]
    works: "np.ndarray"         # float64 [T] cpu work per attempt
    node_names: Tuple[str, ...]


class StageResult:
    """Stage outcome, lazy between two equivalent per-task representations.

    The closed forms build **columnar** results (parallel numpy arrays, no
    per-task Python objects); the event paths still build the legacy
    ``TaskRecord`` list.  Whichever view a caller asks for is derived from
    the other on first access and cached: ``.records`` materializes the
    NamedTuples only when a record-consuming caller (driver counts-by-node,
    scheduler steal accounting, tests) actually needs them, while
    ``.columns()`` hands batch consumers (benchmarks, whole-job summaries,
    serving sweeps) the arrays directly.
    """

    __slots__ = ("node_finish", "completion", "idle_time", "_records", "_cols")

    def __init__(self, node_finish: Dict[str, float], completion: float,
                 idle_time: float, *,
                 records: Optional[List[TaskRecord]] = None,
                 cols: Optional[StageColumns] = None):
        if records is None and cols is None:
            raise ValueError("StageResult needs records or cols")
        self.node_finish = node_finish
        self.completion = completion     # max end
        # Claim 1 quantity: max finish - min finish over nodes that ran
        # >= 1 task (a node that never received work sits at start_time
        # and would otherwise inflate the barrier-idle metric).
        self.idle_time = idle_time
        self._records = records
        self._cols = cols

    @property
    def makespan(self) -> float:
        return self.completion

    @property
    def records(self) -> List[TaskRecord]:
        if self._records is None:
            c = self._cols
            names = c.node_names
            self._records = [
                TaskRecord(tid, names[ni], s, e, w)
                for tid, ni, s, e, w in zip(
                    c.task_ids.tolist(), c.node_index.tolist(),
                    c.starts.tolist(), c.ends.tolist(), c.works.tolist())
            ]
        return self._records

    def columns(self) -> StageColumns:
        if self._cols is None:
            rs = self._records
            # node_finish insertion order == stage node order on every
            # constructing path, so it doubles as the name table.
            names = tuple(self.node_finish)
            idx_of = {nm: i for i, nm in enumerate(names)}
            m = len(rs)
            self._cols = StageColumns(
                np.fromiter((r.task_id for r in rs), np.int64, count=m),
                np.fromiter((idx_of[r.node] for r in rs), np.int64, count=m),
                np.fromiter((r.start for r in rs), np.float64, count=m),
                np.fromiter((r.end for r in rs), np.float64, count=m),
                np.fromiter((r.cpu_work for r in rs), np.float64, count=m),
                names)
        return self._cols

    def __repr__(self) -> str:    # keep debugging output bounded
        n = len(self._records) if self._records is not None \
            else self._cols.task_ids.size
        return (f"StageResult(n_records={n}, completion={self.completion!r}, "
                f"idle_time={self.idle_time!r})")


def _stage_result(records: List[TaskRecord], node_finish: Dict[str, float],
                  start_time: float) -> StageResult:
    """Shared result assembly (legacy oracle + engine event paths): idle
    time is the finish spread over nodes that actually ran work, 0 if
    none did."""
    ran = {r.node for r in records}
    if ran:
        finishes = [node_finish[name] for name in ran]
        idle = max(finishes) - min(finishes)
    else:
        idle = 0.0
    completion = max(node_finish.values()) if node_finish else start_time
    return StageResult(node_finish, completion, idle, records=records)


def _stage_result_columns(cols: StageColumns, node_finish: Dict[str, float],
                          start_time: float) -> StageResult:
    """Columnar twin of :func:`_stage_result` — the closed forms hand their
    arrays straight in and no ``TaskRecord`` is built unless asked for."""
    if cols.node_index.size:
        ran = np.unique(cols.node_index)
        fins = np.fromiter((node_finish[cols.node_names[i]] for i in ran),
                           np.float64, count=ran.size)
        idle = float(fins.max() - fins.min())
    else:
        idle = 0.0
    completion = max(node_finish.values()) if node_finish else start_time
    return StageResult(node_finish, completion, idle, cols=cols)


# --------------------------------------------------------------------------
# the event loop
# --------------------------------------------------------------------------

_EPS = 1e-9


def _run_stage(nodes: Sequence[SimNode], queues: List[List[SimTask]],
               pull: bool, uplink_bw: Optional[float] = None,
               start_time: float = 0.0) -> StageResult:
    """Core fluid/event simulation — the reference oracle (O(N·T) rescan
    loop; the fast paths in ``repro_torch.core.engine`` are differential-tested
    against it).

    queues: if pull, queues[0] is the shared pending queue; otherwise
    queues[i] is node i's private queue (HeMT macrotask list).

    I/O model: active readers of datanode d share `uplink_bw` equally
    (progressive filling, recomputed at every event). A task must finish
    its I/O and its CPU work; both progress concurrently (pipelined
    read-process, as in Spark).
    """
    n = len(nodes)
    shared = queues[0] if pull else None
    private = None if pull else [list(q) for q in queues]

    # per-node running task state
    @dataclass
    class Running:
        task: SimTask
        io_left: float
        cpu_done_at: float   # absolute time CPU work completes (fixed at start)
        start: float

    running: List[Optional[Running]] = [None] * n
    node_finish = {nd.name: start_time for nd in nodes}
    records: List[TaskRecord] = []
    t = start_time

    def io_rates() -> Dict[int, float]:
        """Current per-reader rate for each datanode."""
        readers: Dict[int, int] = {}
        for r in running:
            if r and r.io_left > _EPS and r.task.datanode >= 0:
                readers[r.task.datanode] = readers.get(r.task.datanode, 0) + 1
        return {d: (uplink_bw / c if uplink_bw else math.inf)
                for d, c in readers.items()}

    def next_task_for(i: int) -> Optional[SimTask]:
        if pull:
            return shared.pop(0) if shared else None
        return private[i].pop(0) if private[i] else None

    def start_task(i: int, task: SimTask, now: float):
        nd = nodes[i]
        launch = now + nd.task_overhead
        cpu_end = nd.finish_time(task.cpu_work, launch)
        running[i] = Running(task, task.io_mb, cpu_end, now)

    # prime all nodes
    for i in range(n):
        tk = next_task_for(i)
        if tk:
            start_task(i, tk, t)

    guard = 0
    while any(running):
        guard += 1
        if guard > 10_000_000:
            raise RuntimeError("simulator event-loop runaway")
        rates = io_rates()
        # per-reader rate, computed once per iteration and shared by the
        # event search and the io advancement below
        node_rate = [rates.get(r.task.datanode, math.inf)
                     if r and r.io_left > _EPS and r.task.datanode >= 0
                     else None for r in running]
        # next event: earliest of (cpu completion if io done / will be done,
        # io completion) over running tasks
        t_next, who = math.inf, -1
        for i, r in enumerate(running):
            if not r:
                continue
            rate = node_rate[i]
            if rate is not None:
                t_io = t + (r.io_left / rate if math.isfinite(rate) else 0.0)
                cand = max(t_io, r.cpu_done_at)
                # but an io completion *event* (another flow freeing up) can
                # change rates: we only advance to the earliest *completion*;
                # flows finishing earlier are themselves completions.
                cand_evt = t_io if t_io < r.cpu_done_at else cand
            else:
                cand_evt = r.cpu_done_at
            if cand_evt < t_next:
                t_next, who = cand_evt, i
        # advance io progress to t_next
        for i, r in enumerate(running):
            rate = node_rate[i]
            if rate is not None:
                if math.isfinite(rate):
                    r.io_left = max(0.0, r.io_left - rate * (t_next - t))
                else:
                    r.io_left = 0.0
        t = t_next
        r = running[who]
        if r.io_left <= _EPS and t + _EPS >= r.cpu_done_at:
            # task complete
            records.append(TaskRecord(r.task.task_id, nodes[who].name,
                                      r.start, t, r.task.cpu_work))
            node_finish[nodes[who].name] = t
            running[who] = None
            tk = next_task_for(who)
            if tk:
                start_task(who, tk, t)
        # else: io finished but cpu still running (or vice versa): loop again;
        # rates recompute naturally.

    return _stage_result(records, node_finish, start_time)


def run_pull_stage(nodes: Sequence[SimNode], tasks: Sequence[SimTask],
                   uplink_bw: Optional[float] = None,
                   start_time: float = 0.0, mitigation=None,
                   faults=None) -> StageResult:
    """HomT: shared queue, idle nodes pull (paper Claim 1 setting).

    Rides the fast-path engine: vectorized closed form for uniform tasks on
    constant-speed nodes without effective I/O, event calendar otherwise.
    ``mitigation`` (an event-level policy from ``repro_torch.core.speculation``)
    adds straggler speculation / work stealing on the event calendar.
    ``faults`` (a ``repro_torch.core.faults.FaultTrace``) injects node crashes /
    spot preemptions; killed work re-enters the shared queue.
    """
    from repro_torch.core.engine import simulate_stage
    return simulate_stage(nodes, [tasks], pull=True, uplink_bw=uplink_bw,
                          start_time=start_time, mitigation=mitigation,
                          faults=faults)


def run_static_stage(nodes: Sequence[SimNode],
                     assignments: Sequence[Sequence[SimTask]],
                     uplink_bw: Optional[float] = None,
                     start_time: float = 0.0, mitigation=None,
                     faults=None) -> StageResult:
    """HeMT: one (or more) pre-assigned macrotasks per node.

    Rides the fast-path engine: per-node vectorized cumsum for constant
    speeds without effective I/O, event calendar otherwise.  ``mitigation``
    (an event-level policy from ``repro_torch.core.speculation``) lets idle nodes
    speculate on or steal from straggling macrotasks.  ``faults`` (a
    ``repro_torch.core.faults.FaultTrace``) injects node crashes / spot
    preemptions; a dead node's macrotasks are re-executed on recovery or
    redistributed to survivors per the trace's retry policy.
    """
    if len(assignments) != len(nodes):
        raise ValueError("need one task list per node")
    from repro_torch.core.engine import simulate_stage
    return simulate_stage(nodes, assignments, pull=False,
                          uplink_bw=uplink_bw, start_time=start_time,
                          mitigation=mitigation, faults=faults)


_ENGINE_EXPORTS = ("run_job", "PullSpec", "StaticSpec", "JobSchedule",
                   "StageSummary", "plan_path", "run_job_cache_clear",
                   "AdaptivePlan")


def __getattr__(name: str):
    """Lazy re-export of the whole-job engine API (PEP 562): the engine
    imports this module at top level, so a direct top-level import here
    would be circular."""
    if name in _ENGINE_EXPORTS:
        from repro_torch.core import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# --------------------------------------------------------------------------
# convenience: whole-job helpers used by benchmarks
# --------------------------------------------------------------------------

def homt_job(nodes: Sequence[SimNode], total_work: float, n_tasks: int,
             io_mb_total: float = 0.0, uplink_bw: Optional[float] = None,
             n_datanodes: int = 4, replica: int = 2, seed: int = 0,
             ) -> StageResult:
    """Evenly partition total_work into n_tasks and run pull-based."""
    import numpy as np
    rng = np.random.default_rng(seed)
    per_cpu = total_work / n_tasks
    per_io = io_mb_total / n_tasks
    tasks = []
    # block -> datanode selection with replica-aware choice (Claim 2 model):
    # consecutive tasks read consecutive ranges, tasks sharing a block pick
    # uniformly among its replicas.
    n_blocks = max(1, min(n_tasks, 64))
    placement = [rng.choice(n_datanodes, size=min(replica, n_datanodes),
                            replace=False) for _ in range(n_blocks)]
    for i in range(n_tasks):
        dn = int(rng.choice(placement[i * n_blocks // n_tasks])) \
            if io_mb_total > 0 else -1
        tasks.append(SimTask(per_cpu, per_io, dn, task_id=i))
    return run_pull_stage(nodes, tasks, uplink_bw=uplink_bw)


def hemt_job(nodes: Sequence[SimNode], total_work: float,
             weights: Sequence[float], io_mb_total: float = 0.0,
             uplink_bw: Optional[float] = None, n_datanodes: int = 4,
             replica: int = 2, seed: int = 0) -> StageResult:
    """One macrotask per node, sized by weights (paper §5.1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = sum(weights)
    assignments = []
    for i, (_nd, w) in enumerate(zip(nodes, weights)):
        dn = int(rng.integers(0, n_datanodes)) if io_mb_total > 0 else -1
        assignments.append([SimTask(total_work * w / s,
                                    io_mb_total * w / s, dn, task_id=i)])
    return run_static_stage(nodes, assignments, uplink_bw=uplink_bw)
