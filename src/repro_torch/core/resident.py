"""Resident multi-tenant cluster loop: splice-in recovery + fair-share jobs.

Copy of the JAX package's ``repro/core/resident.py`` (pure Python), imports
pointed at ``repro_torch``. The two carry-sentinel guards (``_base_split``,
``_can_fast_forward``) use ``math.isclose`` with both tolerances 0: the same
exact test as the original's float ``==`` / ``!=``, without lint waivers.
The module docstring names the flow-sharing machinery by what it does.

``run_window``-style drivers used to re-enter ``run_job`` from scratch
after every mid-window event, discarding in-flight schedule state.  The
paper's own premise — capacity change is a *re-skew*, not a restart —
argues for a **resident** event calendar instead: one loop that owns the
cluster for its whole lifetime, extends each job's barrier sequence
lazily, and lets fault recoveries (:mod:`repro_torch.core.faults` traces) and
elastic resizes **splice into** the adaptive schedule.  Survivors keep
their AR(1) state, lost work folds forward, nothing restarts.

On top of the single-job splice the calendar adds **multi-job
admission**: concurrent jobs space-share the nodes under weighted fair
shares and share the per-datanode uplinks through the engine's
incremental flow repricing (readers of a datanode are global across
jobs — the I/O-aware mitigation's machinery, now fair-sharing across *jobs*, not just
tasks), with per-job deadlines/SLOs, retry budgets with backoff, and
graceful degradation: when capacity drops below the admitted load the
lowest-priority jobs are *shed* (paused, attempts checkpointed, no
retry charge) instead of failing the fleet, and every re-quantization
happens at the owning job's next barrier.

Exact semantics (shared verbatim by :class:`ResidentCalendar` and the
naive restart-per-event oracle in tests/test_resident.py — the oracle
recomputes rates, next events and partitions from scratch at every
event, while the calendar splices incrementally; both must agree to
1e-9):

* **Ranking & fair shares.**  Active jobs (arrived, not finished, not
  stranded) are ranked by ``(priority, arrival, name)`` — lower
  priority value is more important.  With ``U`` usable nodes (alive,
  not draining) the first ``k = min(n_active, U)`` ranked jobs are
  *entitled*; their node shares are ``proportional_split(U, weights,
  min_share=1)`` (largest-remainder, every entitled job gets >= 1
  node); the rest have share 0 — see *shedding*.

* **Lazy sticky assignment.**  Assignments change only at these
  points, never continuously:

  - a job's **own barrier**: its assignment is trimmed/grown to its
    share — it keeps its lowest-indexed held usable nodes up to the
    share, releases the rest, then takes free nodes ascending;
  - **node loss** (kill / drain start / resize drop): the node leaves
    its owner immediately and is *not* replaced mid-stage — the job
    runs narrow until its next barrier (the splice);
  - a mid-stage job that loses **all** nodes, and any waiting/stalled
    job, is rescued at the next *rescue pass* (run after every
    external event, barrier, admission and completion): ranked jobs
    with no nodes and a positive share take free nodes ascending, up
    to the share.  Running jobs that still hold >= 1 node never grab
    free nodes mid-stage; a recovered node idles in the free pool
    until some job's barrier or rescue claims it.

* **Compatibility (sparse task->server pruning).**  A job created with
  ``allowed={names}`` only ever takes nodes whose names are in the
  set — at barrier growth and at rescue; its fair share is computed
  as usual, so capacity the job cannot hold stays in the free pool
  for lower-ranked jobs in the same pass.  This is the resident form
  of the rate-matrix pruning knob (Zhao & Mukherjee 2023, PAPERS.md):
  request classes whose service rate on a server is pruned simply
  never land there.  A job whose allowed nodes never free up waits
  (and strands if the calendar drains first).

* **Shedding (graceful degradation).**  A rebalance that finds a
  node-holding job with share 0 sheds it: every in-flight attempt is
  killed *with* the checkpoint-grain flooring of a fault kill but
  *without* a retry charge, the residual re-enters the job's overflow
  queue, its nodes return to the free pool, and the job stalls until
  a rescue pass re-admits it.  Queued work is untouched.

* **Stage materialization.**  At admission / each barrier the stage's
  total work is ``spec total + carry`` (carry = the previous stage's
  lost work, folded forward; jobs created with ``fold_lost=False``
  eat the loss instead — the windowed driver's historical contract).
  A :class:`~repro_torch.core.engine.StaticSpec` is re-quantized to the
  current assignment: the *base split* is the job's ``proportions``
  (by node name, missing names weight 1.0) when given, else the
  spec's own works when the width matches and carry == 0, else even;
  an adaptive job then runs ``AdaptivePlan.replan`` on the base spec
  (fold first, re-plan second — exactly ``run_job``).  One macrotask
  per assigned node launches immediately (zero-work macrotasks still
  pay the overhead); ``io_mb`` splits works-proportionally.  A
  :class:`~repro_torch.core.engine.PullSpec` enqueues its tasks (works
  scaled uniformly by the carry, as ``run_job`` folds pull specs)
  into the job's shared deque and assigned idle nodes pull ascending.

* **Execution & flows.**  Identical to ``run_stage_events``: a task
  completes when its CPU work (overhead + profile integral) and its
  I/O are both done; active readers of a datanode — *across all
  jobs* — share ``uplink_bw`` equally, repriced causally at every
  reader-set change.

* **Refill.**  An idle usable node owned by job j takes, in order:
  the head of j's overflow deque (requeued residuals), then the head
  of j's shared pull deque.  Static stages hand work to nodes only at
  materialization and through the overflow queue — residents do not
  use the single-stage engine's wait-for-recovery / least-loaded
  destinations: the next idle owned node is the least-loaded by
  construction.

* **Kills, retries, SLOs.**  A fault kill checkpoints
  ``floor(executed / g) * g`` (g = the trace's ``checkpoint_grain``)
  as executed work, then requeues the residual to the owner's
  overflow per the *job's* :class:`~repro_torch.core.faults.RetryPolicy`
  (each requeue of a task id counts against ``max_attempts``; the
  k-th relaunch pays ``relaunch_overhead * backoff**(k-1)`` at its
  next launch; exhausted retries abandon the residual, which folds
  forward at the barrier).  A job finishing at ``t`` attains its SLO
  iff ``t <= deadline`` (jobs without deadlines always attain).  Jobs
  still unfinished when the calendar drains (no events left, no
  usable capacity coming back) are **stranded**: completion = inf,
  SLO missed.

* **Event order.**  All external events at an instant process before
  any completion at that instant, ordered ``(t, rank, key)`` with
  rank recover(0) < drain(1) < kill(2) < resize(3) < arrival(4) (the
  fault ranks are :data:`repro_torch.core.faults.SUB_EVENT_RANK`); within a
  resize, drops apply before adds.  Completions order by ``(t, node
  index)``.  After each external event one rebalance (+ rescue) pass
  runs.

* **Recovery modes.**  ``recovery="splice"`` (default) is everything
  above.  ``recovery="restart"`` is the baseline the benchmarks beat:
  after *every* external capacity event (kill / drain / recover /
  resize — not arrivals) every running job abandons its stage —
  in-flight attempts cancelled with nothing saved, queues cleared,
  partial stage statistics discarded — and re-materializes it from
  scratch at that instant over its current nodes (the old
  ``run_window`` re-enter-per-event behavior, made explicit).

* **Tail fast-forward (the resumable-``run_job`` splice).**  In
  splice mode, when a barrier finds exactly one unfinished job, no
  pending external events, zero carry and the job holding every
  usable node, the rest of its schedule is handed to
  ``run_job(resume=JobContinuation(...))`` — the remaining stages
  re-based to the surviving width — so the tail runs through the
  cached closed forms instead of the event loop.  The oracle keeps
  looping; both must agree to 1e-9.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.engine import (
    AdaptivePlan, JobContinuation, ProfileCursor, PullSpec, StageSummary,
    StaticSpec, run_job,
)
from repro_torch.core.faults import (
    DEAD, DRAINING, SUB_EVENT_RANK, FaultTrace, RetryPolicy, lost_work,
)
from repro_torch.core.partitioner import hemt_split_floats, proportional_split
from repro_torch.core.simulator import SimNode, SimTask

_EPS = 1e-9

_EXT_RANK = dict(SUB_EVENT_RANK, resize=3, arrive=4)


# --------------------------------------------------------------------------
# job & event models
# --------------------------------------------------------------------------

@dataclass
class ResidentJob:
    """One admitted job: stages + scheduling identity + SLO.

    ``priority`` ranks jobs (lower = more important), ``weight`` sizes the
    fair share among entitled jobs, ``deadline`` is the absolute SLO
    instant, ``retry`` is the *job's* kill-requeue budget, ``adaptive``
    (an :class:`~repro_torch.core.engine.AdaptivePlan`, optionally sharing a
    scheduler's estimator) re-splits static stages at every barrier,
    ``proportions`` (node name -> weight) is the static split of a
    non-adaptive job (the "stale HeMT" baseline), ``fold_lost=False``
    eats abandoned work instead of folding it into the next stage,
    ``allowed`` (a set of node names) restricts which nodes the job may
    ever hold — the sparse task->server compatibility mask of the
    rate-matrix pruning idea (see the module docstring).
    Stage specs must not carry mitigation policies — the resident loop's
    recovery *is* the mitigation."""
    name: str
    stages: Tuple[object, ...]
    arrival: float = 0.0
    priority: int = 0
    weight: float = 1.0
    deadline: Optional[float] = None
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    adaptive: Optional[AdaptivePlan] = None
    proportions: Optional[Dict[str, float]] = None
    fold_lost: bool = True
    allowed: Optional[frozenset] = None

    def __post_init__(self):
        if not self.stages:
            raise ValueError(f"job {self.name!r} has no stages")
        if self.weight <= 0.0:
            raise ValueError("weight must be positive")
        if self.allowed is not None:
            self.allowed = frozenset(self.allowed)
            if not self.allowed:
                raise ValueError(
                    f"job {self.name!r} has an empty allowed set "
                    "(omit the mask to allow every node)")
        for spec in self.stages:
            if not isinstance(spec, (PullSpec, StaticSpec)):
                raise ValueError("stages must be PullSpec/StaticSpec")
            if spec.mitigation is not None:
                raise ValueError(
                    "resident jobs carry no per-stage mitigation policies "
                    "(splice-in recovery and barrier folds are built in)")


@dataclass(frozen=True)
class ResizeEvent:
    """Elastic fleet change at ``at``: ``drop`` removes cluster node
    indices for good (in-flight attempts requeue with checkpoint credit,
    no retry charge), ``add`` appends new nodes (absolute-clock profiles,
    fresh names) to the free pool."""
    at: float
    add: Tuple[SimNode, ...] = ()
    drop: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.at < 0.0:
            raise ValueError("resize time must be >= 0")
        if any(i < 0 for i in self.drop):
            raise ValueError("drop indices must be >= 0")


@dataclass
class JobOutcome:
    """Per-job result: completion/SLO plus per-stage summaries and the
    planned per-node split of every static stage (None for pull stages) —
    how drivers recover barrier assignments from a record-free run."""
    name: str
    completion: float
    deadline: Optional[float]
    attained: bool
    status: str                       # "done" | "stranded"
    admitted_at: Optional[float]
    stages: List[StageSummary]
    planned: List[Optional[Dict[str, float]]]
    lost: float = 0.0                 # work abandoned for good
    retries: int = 0                  # kill-requeues charged
    sheds: int = 0                    # times degraded to zero nodes


@dataclass
class ResidentResult:
    outcomes: Dict[str, JobOutcome]
    makespan: float                   # last finite job completion
    alive: List[str]                  # usable node names at calendar end

    def attainment(self) -> float:
        """Fraction of deadline-carrying jobs that met their SLO (1.0
        when no job carries one)."""
        slo = [o for o in self.outcomes.values() if o.deadline is not None]
        if not slo:
            return 1.0
        return sum(o.attained for o in slo) / len(slo)


def fair_shares(ranked: Sequence[Tuple[str, float]], capacity: int,
                ) -> Dict[str, int]:
    """Node shares of rank-ordered ``(name, weight)`` jobs over
    ``capacity`` usable nodes: the first ``min(n, capacity)`` jobs split
    the capacity proportionally to weight with a floor of one node each;
    the rest get 0 (shed).  Pure policy — shared by the calendar and the
    differential oracle."""
    shares = {name: 0 for name, _ in ranked}
    k = min(len(ranked), capacity)
    if k:
        entitled = ranked[:k]
        for (name, _), s in zip(
                entitled,
                proportional_split(capacity, [w for _, w in entitled],
                                   min_share=1)):
            shares[name] = s
    return shares


# --------------------------------------------------------------------------
# internal per-job runtime state
# --------------------------------------------------------------------------

class _JobState:
    __slots__ = (
        "job", "status", "arrived", "admitted_at", "nodes", "stage_idx",
        "stage_start", "stage_total", "carry", "pending_materialize",
        "open_tasks", "overflow", "shared", "exec_work", "counts", "fin",
        "planned_dict", "requeues", "penalty", "task_seq", "cold",
        "summaries", "planned", "completion", "lost", "retries", "sheds",
    )

    def __init__(self, job: ResidentJob, cold: List[Tuple[float, int]]):
        self.job = job
        self.status = "idle"          # "idle" | "running" | "done"
        self.arrived = False
        self.admitted_at: Optional[float] = None
        self.nodes: List[int] = []
        self.stage_idx = 0
        self.stage_start = 0.0
        self.stage_total = 0.0
        self.carry = 0.0
        self.pending_materialize = True
        self.open_tasks = 0
        self.overflow: Deque[SimTask] = deque()
        self.shared: Deque[SimTask] = deque()
        self.exec_work: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.fin: Dict[str, float] = {}
        self.planned_dict: Optional[Dict[str, float]] = None
        self.requeues: Dict[int, int] = {}
        self.penalty: Dict[int, float] = {}
        self.task_seq = 0
        self.cold = deque(cold)       # pending cold-restart forgettings
        self.summaries: List[StageSummary] = []
        self.planned: List[Optional[Dict[str, float]]] = []
        self.completion = math.inf
        self.lost = 0.0
        self.retries = 0
        self.sheds = 0

    def rank(self) -> Tuple:
        return (self.job.priority, self.job.arrival, self.job.name)

    def active(self) -> bool:
        return self.arrived and self.status != "done"

    def next_tid(self) -> int:
        self.task_seq += 1
        return self.task_seq


# --------------------------------------------------------------------------
# the calendar
# --------------------------------------------------------------------------

class ResidentCalendar:
    """A resident cluster scheduler (single-use: build, :meth:`run`, read
    the :class:`ResidentResult`).  See the module docstring for the
    normative semantics; ``recovery`` selects ``"splice"`` (default) or
    the ``"restart"``-per-event baseline."""

    def __init__(self, nodes: Sequence[SimNode],
                 uplink_bw: Optional[float] = None,
                 faults: Optional[FaultTrace] = None,
                 resizes: Sequence[ResizeEvent] = (),
                 recovery: str = "splice"):
        if recovery not in ("splice", "restart"):
            raise ValueError("recovery must be 'splice' or 'restart'")
        # an event-free trace still configures the checkpoint grain (sheds
        # and resize drops checkpoint too); only the event machinery is
        # skippable
        self.ckpt_grain = faults.checkpoint_grain if faults is not None \
            else 0.0
        if faults is not None and not faults.events:
            faults = None
        self.nodes = list(nodes)
        self.uplink_bw = uplink_bw if uplink_bw else None
        self.faults = faults
        self.resizes = sorted(resizes, key=lambda r: r.at)
        self.recovery = recovery
        n_total = len(self.nodes) + sum(len(r.add) for r in self.resizes)
        if faults is not None and faults.max_node() >= n_total:
            raise ValueError(
                f"fault trace names node {faults.max_node()} but the "
                f"calendar ever has {n_total} nodes")
        self._ran = False

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[ResidentJob]) -> ResidentResult:
        if self._ran:
            raise RuntimeError("ResidentCalendar is single-use")
        self._ran = True
        names = [j.name for j in jobs]
        if len(set(names)) != len(names):
            raise ValueError("job names must be unique")
        if not jobs:
            return ResidentResult({}, 0.0, [nd.name for nd in self.nodes])
        fast = self._whole_job_fast_path(jobs)
        if fast is not None:
            return fast
        return self._run_loop(jobs)

    # ------------------------------------------------------------------
    def _whole_job_fast_path(self, jobs) -> Optional[ResidentResult]:
        """One job, arrival 0, no externals: resident semantics coincide
        with ``run_job`` exactly (full assignment at every barrier, no
        splice points), so delegate to the closed forms + solve LRU."""
        if (len(jobs) != 1 or self.faults is not None or self.resizes
                or self.recovery != "splice"):
            return None
        job = jobs[0]
        if job.arrival > 0.0 or job.proportions is not None:
            return None
        if job.allowed is not None \
                and not {nd.name for nd in self.nodes} <= job.allowed:
            return None
        n = len(self.nodes)
        if any(isinstance(s, StaticSpec) and len(s.works) != n
               for s in job.stages):
            return None
        sched = run_job(self.nodes, list(job.stages), self.uplink_bw,
                        adaptive=job.adaptive)
        h = len(job.adaptive.history) - len(job.stages) \
            if job.adaptive is not None else 0
        node_names = [nd.name for nd in self.nodes]
        planned: List[Optional[Dict[str, float]]] = []
        for k, spec in enumerate(job.stages):
            if not isinstance(spec, StaticSpec):
                planned.append(None)
            elif job.adaptive is not None:
                works = job.adaptive.history[h + k].works
                planned.append(dict(zip(node_names, works)))
            else:
                planned.append(dict(zip(node_names, spec.works)))
        out = JobOutcome(
            job.name, sched.completion, job.deadline,
            job.deadline is None or sched.completion <= job.deadline + _EPS,
            "done", 0.0, sched.stages, planned)
        return ResidentResult({job.name: out}, sched.completion, node_names)

    # ------------------------------------------------------------------
    def _run_loop(self, jobs) -> ResidentResult:
        n = len(self.nodes)
        self.names = [nd.name for nd in self.nodes]
        self.cursors = [ProfileCursor(nd.profile) for nd in self.nodes]
        self.overheads = [nd.task_overhead for nd in self.nodes]
        self.dead = [False] * n
        self.draining = [False] * n
        self.owner: List[Optional[_JobState]] = [None] * n
        self.task: List[Optional[SimTask]] = [None] * n
        self.t_started = [0.0] * n
        self.launch_at = [0.0] * n
        self.attempt_work = [0.0] * n
        self.attempt_io = [0.0] * n
        self.cpu_done = [0.0] * n
        self.io_left = [0.0] * n
        self.io_rate = [0.0] * n
        self.io_at = [0.0] * n
        self.reading = [-1] * n
        self.version = [0] * n
        self.readers: Dict[int, Set[int]] = {}
        self.heap: List[Tuple[float, int, int]] = []
        self.ckpt = self.ckpt_grain

        cold = self.faults.cold_restarts() if self.faults else []
        self.jobs = [_JobState(j, cold) for j in jobs]

        # external events, processed (t, rank, key) — see module docstring
        externals: List[Tuple[float, int, Tuple, str, object]] = []
        if self.faults is not None:
            for i in range(n):
                st = self.faults.state_at(i, 0.0)
                self.dead[i] = st == DEAD
                self.draining[i] = st == DRAINING
            for (t, node, kind) in self.faults.sub_events(0.0):
                externals.append((t, _EXT_RANK[kind], (node,), kind, node))
        for seq, rz in enumerate(self.resizes):
            externals.append((rz.at, _EXT_RANK["resize"], (seq,),
                              "resize", rz))
        for js in self.jobs:
            if js.job.arrival <= 0.0:
                js.arrived = True
            else:
                externals.append((js.job.arrival, _EXT_RANK["arrive"],
                                  (js.job.priority, js.job.name),
                                  "arrive", js))
        externals.sort(key=lambda e: (e[0], e[1], e[2]))
        self._externals = externals
        self._ext_left = len(externals)
        for idx, (t, _, _, _, _) in enumerate(externals):
            heapq.heappush(self.heap, (t, -1, idx))

        self._rebalance(0.0)

        guard = 0
        limit = 1000 * (len(self.jobs) + 1) * (n + 8) \
            * (1 + sum(len(js.job.stages) for js in self.jobs))
        while self.heap:
            guard += 1
            if guard > limit:
                raise RuntimeError("resident calendar failed to converge")
            t, i, ver = heapq.heappop(self.heap)
            if i < 0:
                _, _, _, kind, payload = self._externals[ver]
                self._ext_left -= 1
                self._handle_external(kind, payload, t)
                continue
            if ver != self.version[i] or self.task[i] is None:
                continue
            if self.reading[i] >= 0:
                d = self.reading[i]
                self.io_left[i] = 0.0
                self.reading[i] = -1
                self.readers[d].discard(i)
                self._reprice(d, t)
                if t + _EPS >= self.cpu_done[i]:
                    self._finish(i, t)
                else:
                    self._push(self.cpu_done[i], i)
            elif t + _EPS >= self.cpu_done[i]:
                self._finish(i, t)
            else:
                self._push(self.cpu_done[i], i)

        return self._result()

    # ------------------------------------------------------------------
    # engine-mirrored flow/attempt primitives
    # ------------------------------------------------------------------
    def _push(self, t: float, i: int) -> None:
        self.version[i] += 1
        heapq.heappush(self.heap, (t, i, self.version[i]))

    def _reprice(self, d: int, now: float) -> None:
        rd = self.readers.get(d)
        if not rd:
            return
        drained = []
        for i in rd:
            left = self.io_left[i] - self.io_rate[i] * (now - self.io_at[i])
            self.io_left[i] = left if left > 0.0 else 0.0
            self.io_at[i] = now
            if self.io_left[i] <= _EPS:
                drained.append(i)
        for i in drained:
            rd.discard(i)
            self.reading[i] = -1
            self._push(max(now, self.cpu_done[i]), i)
        if not rd:
            return
        rate = self.uplink_bw / len(rd)
        for i in rd:
            self.io_rate[i] = rate
            self._push(now + self.io_left[i] / rate, i)

    def _start_task(self, i: int, js: _JobState, tk: SimTask,
                    now: float) -> None:
        launch = now + self.overheads[i] + js.penalty.pop(tk.task_id, 0.0)
        self.task[i] = tk
        self.t_started[i] = now
        self.launch_at[i] = launch
        self.attempt_work[i] = tk.cpu_work
        self.cpu_done[i] = self.cursors[i].finish_time(tk.cpu_work, launch)
        if (self.uplink_bw is not None and tk.datanode >= 0
                and tk.io_mb > _EPS):
            self.attempt_io[i] = tk.io_mb
            self.io_left[i] = tk.io_mb
            self.io_at[i] = now
            self.io_rate[i] = 0.0
            self.reading[i] = tk.datanode
            self.readers.setdefault(tk.datanode, set()).add(i)
            self._reprice(tk.datanode, now)
        else:
            self.attempt_io[i] = 0.0
            self.io_left[i] = 0.0
            self._push(self.cpu_done[i], i)

    def _drop_flow(self, i: int, now: float) -> None:
        d = self.reading[i]
        if d < 0:
            return
        self.reading[i] = -1
        self.io_left[i] = 0.0
        self.readers[d].discard(i)
        self._reprice(d, now)

    def _remaining(self, i: int, now: float) -> float:
        if now < self.launch_at[i]:
            return self.attempt_work[i]
        return self.cursors[i].work_between(now, self.cpu_done[i])

    def _refill(self, i: int, now: float) -> None:
        js = self.owner[i]
        if (js is None or self.task[i] is not None or self.dead[i]
                or self.draining[i]):
            return
        if js.overflow:
            self._start_task(i, js, js.overflow.popleft(), now)
        elif js.shared:
            self._start_task(i, js, js.shared.popleft(), now)

    def _wake(self, js: _JobState, now: float) -> None:
        for i in js.nodes:
            if self.task[i] is None:
                self._refill(i, now)

    def _record(self, js: _JobState, name: str, work: float,
                now: float) -> None:
        js.exec_work[name] = js.exec_work.get(name, 0.0) + work
        js.counts[name] = js.counts.get(name, 0) + 1
        js.fin[name] = now

    def _finish(self, i: int, now: float) -> None:
        js = self.owner[i]
        self._record(js, self.names[i], self.attempt_work[i], now)
        self.task[i] = None
        js.open_tasks -= 1
        if self.draining[i]:
            # a draining node leaves its owner the moment its in-flight
            # attempt completes (it can take nothing new)
            self._release_node(i)
        else:
            self._refill(i, now)
        if js.open_tasks == 0:
            self._barrier(js, now)

    # ------------------------------------------------------------------
    # kills, sheds, externals
    # ------------------------------------------------------------------
    def _cancel_attempt(self, i: int, now: float, *, checkpoint: bool,
                        charge: bool) -> None:
        """Kill node i's in-flight attempt.  ``checkpoint``: grain-floored
        prefix survives as executed work; residual requeues to the
        owner's overflow per the job's retry policy (``charge=False``:
        scheduler-initiated — shed / resize drop — no retry charge)."""
        js, tk = self.owner[i], self.task[i]
        if js is None or tk is None:
            return
        executed = self.attempt_work[i] - self._remaining(i, now)
        saved = 0.0
        if checkpoint and self.ckpt > 0.0 and executed > 0.0:
            saved = min(math.floor((executed + _EPS) / self.ckpt)
                        * self.ckpt, self.attempt_work[i])
        if saved > _EPS:
            self._record(js, self.names[i], saved, now)
        self.task[i] = None
        self.version[i] += 1
        self._drop_flow(i, now)
        rem = self.attempt_work[i] - saved
        if rem <= _EPS:
            js.open_tasks -= 1
            return
        if charge:
            k = js.requeues.get(tk.task_id, 0)
            if k >= js.job.retry.max_attempts - 1:
                js.open_tasks -= 1          # retries exhausted: abandoned
                return
            js.requeues[tk.task_id] = k + 1
            js.retries += 1
            pen = js.job.retry.penalty(k + 1)
            if pen > 0.0:
                js.penalty[tk.task_id] = pen
        if self.attempt_io[i] > _EPS and self.attempt_work[i] > _EPS:
            io = self.attempt_io[i] * rem / self.attempt_work[i]
        else:
            io = 0.0
        js.overflow.append(SimTask(rem, io,
                                   tk.datanode if io > _EPS else -1,
                                   task_id=tk.task_id))

    def _release_node(self, i: int) -> None:
        js = self.owner[i]
        if js is not None:
            js.nodes.remove(i)
            self.owner[i] = None

    def _shed(self, js: _JobState, now: float) -> None:
        js.sheds += 1
        for i in list(js.nodes):
            if not self._usable(i):
                continue   # draining: finishes its attempt, releases itself
            self._cancel_attempt(i, now, checkpoint=True, charge=False)
            self._release_node(i)
        if not js.nodes:
            js.status = "idle"
        if js.open_tasks == 0 and not js.pending_materialize:
            self._barrier(js, now)

    def _handle_external(self, kind: str, payload, now: float) -> None:
        if kind == "kill":
            i = payload
            if i < len(self.nodes):
                self.dead[i] = True
                self.draining[i] = False
                js = self.owner[i]
                self._cancel_attempt(i, now, checkpoint=True, charge=True)
                self._release_node(i)
                if js is not None and js.open_tasks == 0 \
                        and not js.pending_materialize:
                    self._barrier(js, now)
                elif js is not None and not js.nodes:
                    js.status = "idle"
        elif kind == "drain":
            i = payload
            if i < len(self.nodes):
                self.draining[i] = True
                if self.task[i] is None:
                    self._release_node(i)
        elif kind == "recover":
            i = payload
            if i < len(self.nodes):
                self.dead[i] = False
                self.draining[i] = False
                if self.owner[i] is not None and self.task[i] is None:
                    self._release_node(i)   # rejoins via the free pool
        elif kind == "resize":
            for i in payload.drop:
                if i >= len(self.nodes) or self.dead[i]:
                    continue
                js = self.owner[i]
                self._cancel_attempt(i, now, checkpoint=True, charge=False)
                self._release_node(i)
                self.dead[i] = True      # removed for good
                self.draining[i] = False
                if js is not None and js.open_tasks == 0 \
                        and not js.pending_materialize:
                    self._barrier(js, now)
                elif js is not None and not js.nodes:
                    js.status = "idle"
            for nd in payload.add:
                if nd.name in self.names:
                    raise ValueError(f"added node {nd.name!r} duplicates "
                                     "an existing name")
                self.names.append(nd.name)
                self.cursors.append(ProfileCursor(nd.profile))
                self.overheads.append(nd.task_overhead)
                for arr, zero in ((self.dead, False), (self.draining, False),
                                  (self.owner, None), (self.task, None),
                                  (self.reading, -1), (self.version, 0)):
                    arr.append(zero)
                for arr in (self.t_started, self.launch_at,
                            self.attempt_work, self.attempt_io,
                            self.cpu_done, self.io_left, self.io_rate,
                            self.io_at):
                    arr.append(0.0)
                self.nodes.append(nd)
        else:                            # arrive
            payload.arrived = True
        self._rebalance(now)
        if self.recovery == "restart" and kind != "arrive":
            for js in self._ranked():
                if js.status == "running":
                    self._restart_stage(js, now)

    # ------------------------------------------------------------------
    # partitioning
    # ------------------------------------------------------------------
    def _ranked(self) -> List[_JobState]:
        return sorted((js for js in self.jobs if js.active()),
                      key=_JobState.rank)

    def _usable(self, i: int) -> bool:
        return not self.dead[i] and not self.draining[i]

    def _free_nodes(self) -> List[int]:
        return [i for i in range(len(self.nodes))
                if self._usable(i) and self.owner[i] is None]

    def _permits(self, js: _JobState, i: int) -> bool:
        return js.job.allowed is None or self.names[i] in js.job.allowed

    def _rebalance(self, now: float,
                   barrier_job: Optional[_JobState] = None) -> None:
        ranked = self._ranked()
        capacity = sum(self._usable(i) for i in range(len(self.nodes)))
        shares = fair_shares([(js.job.name, js.job.weight) for js in ranked],
                             capacity)
        for js in ranked:
            if shares[js.job.name] == 0 \
                    and any(self._usable(i) for i in js.nodes):
                self._shed(js, now)
        if barrier_job is not None:
            share = shares.get(barrier_job.job.name, 0)
            if share > 0:
                held = sorted(i for i in barrier_job.nodes
                              if self._usable(i))
                for i in held[share:]:
                    self._release_node(i)
                free = [i for i in self._free_nodes()
                        if self._permits(barrier_job, i)]
                for i in free[:share - len(barrier_job.nodes)]:
                    self.owner[i] = barrier_job
                    barrier_job.nodes.append(i)
                barrier_job.nodes.sort()
        for js in ranked:
            if js.status == "done" or js.nodes or shares[js.job.name] == 0:
                continue
            free = [i for i in self._free_nodes() if self._permits(js, i)]
            if not free:
                continue
            for i in free[:shares[js.job.name]]:
                self.owner[i] = js
                js.nodes.append(i)
            js.nodes.sort()
            if js.admitted_at is None:
                js.admitted_at = now
            js.status = "running"
            if js.pending_materialize:
                self._materialize(js, now)
            else:
                self._wake(js, now)
        # queued work freed by a kill/shed may be waiting on nodes that
        # went idle earlier in the stage — hand it out now
        for js in self.jobs:
            if (js.status == "running" and js.nodes
                    and not js.pending_materialize):
                self._wake(js, now)

    # ------------------------------------------------------------------
    # barriers & materialization
    # ------------------------------------------------------------------
    def _base_split(self, js: _JobState, spec, total: float,
                    names: Sequence[str]) -> List[float]:
        if js.job.proportions is not None:
            weights = [js.job.proportions.get(nm, 1.0) for nm in names]
            return hemt_split_floats(total, weights)
        # carry == 0.0 is the "no reskew residual" sentinel (set from the
        # literal, never computed); a near-zero computed residual keeps
        # the conservative re-split branch, which is still correct
        if (isinstance(spec, StaticSpec) and len(spec.works) == len(names)
                and math.isclose(js.carry, 0.0, rel_tol=0.0, abs_tol=0.0)):
            return list(spec.works)
        return [total / len(names)] * len(names)

    def _materialize(self, js: _JobState, now: float,
                     total_override: Optional[float] = None) -> None:
        spec = js.job.stages[js.stage_idx]
        if js.job.adaptive is not None:
            while js.cold and js.cold[0][0] <= now + _EPS:
                t_rec, node = js.cold.popleft()
                if node < len(self.names):
                    js.job.adaptive.estimator.forget(self.names[node])
        names = [self.names[i] for i in js.nodes]
        js.exec_work, js.counts, js.fin = {}, {}, {}
        js.stage_start = now
        js.pending_materialize = False
        js.status = "running"
        if isinstance(spec, StaticSpec):
            if total_override is None:
                total = sum(spec.works) + js.carry
            else:
                total = total_override
            base = self._base_split(js, spec, total, names)
            js.carry = 0.0
            if js.job.adaptive is not None:
                base_spec = StaticSpec(works=tuple(base), io_mb=spec.io_mb,
                                       datanode=spec.datanode)
                works = list(js.job.adaptive.replan(names, base_spec).works)
            else:
                works = base
            js.stage_total = sum(works)
            js.planned_dict = dict(zip(names, works))
            wsum = js.stage_total
            for i, w in zip(js.nodes, works):
                if spec.io_mb > 0.0 and spec.datanode >= 0:
                    io = spec.io_mb * (w / wsum if wsum > 0.0
                                       else 1.0 / len(works))
                else:
                    io = 0.0
                js.open_tasks += 1
                self._start_task(i, js, SimTask(
                    w, io, spec.datanode if io > _EPS else -1,
                    task_id=js.next_tid()), now)
        else:
            w = spec.work_array()
            wtot = float(w.sum())
            if total_override is not None:
                carry = total_override - wtot
            else:
                carry = js.carry
            js.carry = 0.0
            if carry > 0.0:
                if wtot > 0.0:
                    w = w * (1.0 + carry / wtot)
                else:
                    w = w + carry / len(w)
            js.stage_total = float(w.sum())
            js.planned_dict = None
            js.shared = deque(
                SimTask(float(x), spec.io_mb, spec.datanode,
                        task_id=js.next_tid())
                for x in w)
            js.open_tasks += len(js.shared)
            self._wake(js, now)

    def _restart_stage(self, js: _JobState, now: float) -> None:
        """restart-per-event baseline: abandon the running stage — nothing
        saved, queues cleared, partial stats discarded — and re-run it
        from scratch at ``now`` over the current nodes."""
        for i in list(js.nodes):
            if self.task[i] is not None:
                self.task[i] = None
                self.version[i] += 1
                self._drop_flow(i, now)
            if not self._usable(i):
                self._release_node(i)
        js.overflow.clear()
        js.shared.clear()
        js.open_tasks = 0
        total = js.stage_total
        if js.nodes:
            self._materialize(js, now, total_override=total)
        else:
            js.carry = 0.0
            js.stage_total = total
            js.pending_materialize = True
            js.status = "idle"

    def _barrier(self, js: _JobState, now: float) -> None:
        names = list(self.names)
        offs = [js.fin.get(nm, js.stage_start) - js.stage_start
                for nm in names]
        ran = [o for nm, o in zip(names, offs) if js.counts.get(nm, 0)]
        idle = (max(ran) - min(ran)) if ran else 0.0
        summ = StageSummary(
            js.stage_start, now, idle,
            {nm: js.stage_start + o for nm, o in zip(names, offs)},
            {nm: js.counts.get(nm, 0) for nm in names},
            {nm: js.exec_work.get(nm, 0.0) for nm in names})
        js.summaries.append(summ)
        js.planned.append(dict(js.planned_dict)
                          if js.planned_dict is not None else None)
        if js.job.adaptive is not None:
            js.job.adaptive.observe(names, summ)
        lost = lost_work(js.stage_total, sum(js.exec_work.values()))
        js.stage_total = 0.0   # consumed — a stranded job only reports
        #                        unexecuted work of a *materialized* stage
        js.stage_idx += 1
        last = js.stage_idx >= len(js.job.stages)
        if lost > 0.0:
            if js.job.fold_lost and not last:
                js.carry = lost
            else:
                js.lost += lost
        js.requeues.clear()
        js.penalty.clear()
        if last:
            js.status = "done"
            js.completion = now
            for i in list(js.nodes):
                self._release_node(i)
            self._rebalance(now)
            return
        js.pending_materialize = True
        self._rebalance(now, barrier_job=js)
        if not js.nodes:
            js.status = "idle"
            return
        if self._can_fast_forward(js):
            self._fast_forward(js, now)
            return
        self._materialize(js, now)

    # ------------------------------------------------------------------
    # tail fast-forward through resumable run_job
    # ------------------------------------------------------------------
    def _can_fast_forward(self, js: _JobState) -> bool:
        if self.recovery != "splice" or self._ext_left > 0:
            return False
        # same carry sentinel as _base_split: nonzero residual (however
        # small) must keep the event-by-event path, so exact is safe
        if not math.isclose(js.carry, 0.0, rel_tol=0.0, abs_tol=0.0):
            return False
        if any(other is not js and other.active() for other in self.jobs):
            return False
        usable = [i for i in range(len(self.nodes)) if self._usable(i)]
        return usable == js.nodes

    def _fast_forward(self, js: _JobState, now: float) -> None:
        if js.job.adaptive is not None:
            # run_job gets no fault trace (the tail is event-free), so any
            # cold restarts already past must be forgotten here, exactly
            # where the materialize path would have
            while js.cold and js.cold[0][0] <= now + _EPS:
                _, node = js.cold.popleft()
                if node < len(self.names):
                    js.job.adaptive.estimator.forget(self.names[node])
        sub = [self.nodes[i] for i in js.nodes]
        names = [self.names[i] for i in js.nodes]
        stages: List[object] = []
        for k, spec in enumerate(js.job.stages):
            if k < js.stage_idx or not isinstance(spec, StaticSpec):
                stages.append(spec)
            elif len(spec.works) == len(sub) \
                    and js.job.proportions is None:
                stages.append(spec)
            else:
                total = sum(spec.works)
                stages.append(StaticSpec(
                    works=tuple(self._base_split(js, spec, total, names)),
                    io_mb=spec.io_mb, datanode=spec.datanode))
        h0 = len(js.job.adaptive.history) if js.job.adaptive else 0
        sched = run_job(sub, stages, self.uplink_bw,
                        adaptive=js.job.adaptive,
                        resume=JobContinuation(js.stage_idx, now))
        for m, summ in enumerate(sched.stages):
            k = js.stage_idx + m
            js.summaries.append(summ)
            spec = stages[k]
            if not isinstance(spec, StaticSpec):
                js.planned.append(None)
            elif js.job.adaptive is not None:
                works = js.job.adaptive.history[h0 + m].works
                js.planned.append(dict(zip(names, works)))
            else:
                js.planned.append(dict(zip(names, spec.works)))
        js.stage_idx = len(js.job.stages)
        js.status = "done"
        js.completion = sched.completion
        js.pending_materialize = False
        for i in list(js.nodes):
            self._release_node(i)

    # ------------------------------------------------------------------
    def _result(self) -> ResidentResult:
        outcomes = {}
        makespan = 0.0
        for js in self.jobs:
            done = js.status == "done"
            completion = js.completion if done else math.inf
            if done:
                makespan = max(makespan, completion)
            elif js.stage_total:
                js.lost += lost_work(js.stage_total,
                                     sum(js.exec_work.values()))
            dl = js.job.deadline
            outcomes[js.job.name] = JobOutcome(
                js.job.name, completion, dl,
                done and (dl is None or completion <= dl + _EPS),
                "done" if done else "stranded",
                js.admitted_at, js.summaries, js.planned,
                js.lost, js.retries, js.sheds)
        alive = [self.names[i] for i in range(len(self.nodes))
                 if self._usable(i)]
        return ResidentResult(outcomes, makespan, alive)
