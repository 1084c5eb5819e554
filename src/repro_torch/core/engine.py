"""Fast-path simulation engine behind ``run_pull_stage``/``run_static_stage``.

Copy of the JAX package's ``repro/core/engine.py`` (pure Python), imports
pointed at ``repro_torch.core``. The io-symmetry guard uses ``math.isclose``
with both tolerances 0 and the run-length grouping
``np.flatnonzero(np.diff(w))``: the same exact tests as the original's
float ``!=``, without lint waivers.

The legacy ``simulator._run_stage`` loop rescans every node at every event
(O(N·T)), pops the shared queue with O(T) ``list.pop(0)``, and re-walks each
node's speed profile from t=0 per task — quadratic exactly in the paper's own
regime (HomT sweeps at realistic microtask counts).  This module replaces it
on the hot path with two layers, keeping ``_run_stage`` as a reference oracle
for differential tests:

1. **Event calendar** (``run_stage_events``): a ``heapq`` of per-node
   completion events keyed ``(time, node_index, version)`` so tie-breaking
   matches the legacy lowest-index scan; ``collections.deque`` task queues
   (O(1) pops); a per-node :class:`ProfileCursor` making ``finish_time`` /
   ``work_between`` amortized O(1) under the engine's monotone query times;
   and incremental I/O flow repricing — when a datanode's reader set changes,
   only *that* datanode's readers have their remaining bytes checkpointed and
   their predicted finish re-pushed (stale heap entries are version-skipped).

2. **Closed forms** (no event loop at all) for the dominant special
   cases, auto-selected by :func:`simulate_stage` via :func:`plan_path`.
   With T tasks over n nodes the selection table is (first match wins):

   ====================================  =====================  ==============
   input shape                           chosen path            complexity
   ====================================  =====================  ==============
   fault-injected stage (``faults=``)    ``event``              O(T log n)
   any multi-segment speed profile       ``event``              O(T log n)
   static, const speeds, no eff. I/O     ``closed-static``      O(T) numpy
   pull, uniform tasks, no eff. I/O,     ``closed-pull``        O(T) numpy
   positive per-pull period
   pull, heterogeneous tasks (or zero    ``closed-pull-hetero`` O(T log n)
   period), no eff. I/O                                         tight merge
   pull, equal ``io_mb`` > 0, striped    ``closed-pull-io-sym`` O(T) numpy
   round-robin over d | n datanodes,
   network-governed rounds
   anything else (flow-shared I/O)       ``event``              O(T log n)
   ====================================  =====================  ==============

   * ``closed-static``: per-node ``cumsum`` of ``overhead + work/speed``
     (HeMT macrotasks);
   * ``closed-pull``: each node's pull times form the arithmetic grid
     ``j * (overhead_i + work/speed_i)``; the schedule is the T smallest
     grid points (ties by node index), found with a vectorized threshold
     search + ``np.lexsort``;
   * ``closed-pull-hetero``: the merged-grid scan — each node's end times
     are a prefix sum over its assigned works, and the FIFO queue hands task
     k to the node owning the k-th smallest end event, so a single
     ``heapreplace`` pass over the n per-node grid heads reproduces the
     event calendar exactly with none of its per-event bookkeeping;
   * ``closed-pull-io-sym``: every task reads the same ``io_mb``, task k
     from datanode ``dns[k % d]`` (round-robin stripe over d distinct
     datanodes with ``d | n``; d = 1 is the single-datanode case), and CPU
     never governs (``overhead + work/speed <= round I/O time`` for every
     assignment), so the flow-sharing schedule is piecewise linear: in a
     full round each datanode serves exactly ``n / d`` co-readers and all
     n drain simultaneously after ``io_mb / (uplink_bw / (n/d))``; the
     tail round's datanode groups (``c_j`` readers each) drain
     independently after ``io_mb / (uplink_bw / c_j)``.

   "No effective I/O" means ``uplink_bw`` is None/0 (infinite rate — I/O can
   never delay a completion) or no task has ``datanode >= 0`` with positive
   ``io_mb``.  Anything else takes the event calendar, which reproduces the
   oracle's completion times to float round-off (differential tests pin both
   paths to ``_run_stage`` at 1e-9).  A fault-injected stage (a non-empty
   ``faults=`` :class:`~repro_torch.core.faults.FaultTrace`) always routes to the
   event calendar: kills, drains and recoveries are point events the closed
   forms cannot express.

3. **Whole jobs** (:func:`run_job`): an S-stage sequence of
   :class:`PullSpec`/:class:`StaticSpec` stages separated by program
   barriers.  On constant-speed clusters every stage schedule is
   start-invariant, so each *distinct* spec is solved once (record-free
   summaries — no ``TaskRecord`` objects) and repeated stages are O(n)
   shifts of the cached per-node finish vector: an S-stage HomT/HeMT job
   costs O(S·n) after the one-time per-spec solve instead of
   O(S·T log n).  Solves are additionally shared *across* ``run_job``
   calls through a module-level LRU keyed on (cluster signature,
   uplink_bw, spec) — repeated benchmark invocations and the adaptive
   schedulers reuse each other's solves (``run_job_cache_clear`` resets
   it).  Non-constant clusters fall back to per-stage ``simulate_stage``
   at the true absolute start times.

4. **Straggler mitigation** (``repro_torch.core.speculation``): the event
   calendar accepts ``mitigation=`` — a :class:`SpeculativeCopies`
   (quantile-triggered duplicate launch, first finisher wins, loser
   cancelled) or :class:`WorkStealing` (idle node steals the remainder of
   the most-backlogged attempt at a grain boundary) policy — adding task
   cancel / re-launch / idle-recheck events on top of the completion
   calendar.  ``PullSpec``/``StaticSpec`` carry a ``mitigation`` field so
   ``run_job`` threads policies through whole jobs (mitigated stages are
   solved on the event path; they stay start-invariant on constant-speed
   clusters, so the solve caches still apply).  Barrier-level
   :class:`ReskewHandoff` is applied by ``run_job`` itself: stragglers of
   a static stage are cut at ``cutoff_factor * median`` finish and their
   residual work is folded into the next stage's split.  Stages with
   effective I/O are mitigated too: a speculative copy or stolen
   remainder re-fetches its input as a *new flow* through the
   flow-shared uplink (placement chosen by
   :class:`~repro_torch.core.hdfs_model.DuplicatePlacement` — same datanode or
   the ring-adjacent replica), joining the incremental per-datanode
   repricing; cancelling the loser frees its flow and reprices the
   survivors causally at that instant, never retroactively.  Exact
   event semantics live in the ``speculation`` module docstring;
   differential tests pin the engine against naive per-event oracles
   (tests/test_speculation.py, tests/test_speculation_io.py).

5. **Fault injection** (``repro_torch.core.faults``): every layer accepts
   ``faults=`` — a :class:`~repro_torch.core.faults.FaultTrace` of
   :class:`~repro_torch.core.faults.NodeCrash` / :class:`~repro_torch.core.faults.
   SpotPreemption` events with a :class:`~repro_torch.core.faults.RetryPolicy`
   and optional grain-boundary checkpointing.  ``run_stage_events`` kills
   the victim's in-flight attempt (its uplink flow freed through the same
   causal ``drop_flow`` repricing losers use), re-queues the residual per
   the retry policy, and composes with speculation (a surviving copy
   becomes the primary attempt).  ``run_job`` keeps the solve caches
   honest — see the run_job docstring — because faults break
   start-invariance.  Exact semantics live in the ``faults`` module
   docstring, pinned by the naive full-rescan fault oracle in
   tests/test_faults.py.

6. **Online adaptation** (:class:`AdaptivePlan`): the paper's full §5
   OA-HeMT loop at ``run_job`` scale.  ``run_job(..., adaptive=plan)``
   feeds every stage's observed per-node (executed work, busy time) into
   the plan's :class:`~repro_torch.core.estimators.ARSpeedEstimator` at the
   stage's barrier, and re-derives each upcoming ``StaticSpec``'s split
   proportions from the updated speed estimates (``d_i = D v_i / V``)
   before it is solved.  Composition with barrier-level
   :class:`~repro_torch.core.speculation.ReskewHandoff` is exact: a cut stage's
   residual is first folded into the next stage's planned works and the
   re-plan then re-splits the *combined* total — both the split and the
   residual are re-skewed by the freshest estimates.  Solve-cache
   correctness needs no estimator state in the cache keys: a re-planned
   stage is a *new* ``StaticSpec`` value whose works tuple is a pure
   function of the estimator state, and the caches key solves by spec
   value — two adaptive stages collide in the LRU only when their splits
   (and therefore their solves) are identical.  ``PullSpec`` stages pass
   through un-replanned (the shared queue self-balances at run time) but
   still feed the estimator.

Tie semantics: the one deliberate divergence from the oracle is simultaneous
I/O drains.  When two flows hit zero at the exact same instant, the legacy
loop re-candidates the non-owner at its (already past) ``cpu_done_at``,
records a completion *earlier than its I/O finish*, and then advances every
other flow by a negative time delta — inflating their remaining bytes and
cascading through the rest of the stage (visible in the seed's Fig-5 rows at
32/64 identical tasks).  The engine instead completes every task causally at
``max(io_finish, cpu_done)``.  Randomized differential tests draw continuous
task sizes, where exact ties have measure zero and the oracle is sound.

Enforced contracts (machine-checked by ``python -m repro.analysis.lint``,
the ``hemt-lint`` CI job, and the tier-1 self-check in
tests/test_analysis.py — rule table in the README "Static analysis"
section): stage specs and everything reachable from them stay frozen and
hashable because the solve LRU and ``batched.dedup_rows`` key by value
(HL001); solver code never reads the wall clock or unseeded RNG — the
1e-9 differential oracles depend on it (HL002/HL003); float ``==`` in
solver modules is either a documented exact-routing guard or a bug
(HL004); the jax twins stay tracer-safe for the Pallas port (HL005); and
closed-form solvers never mutate parameter arrays, because cached solves
are replayed (HL006).
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.estimators import ARSpeedEstimator
from repro_torch.core.faults import ALIVE, DEAD, DRAINING, FaultTrace, lost_work
from repro_torch.core.partitioner import hemt_split_floats, proportional_split
from repro_torch.core.simulator import (
    SimNode, SimTask, StageColumns, StageResult, TaskRecord, _stage_result,
    _stage_result_columns,
)
from repro_torch.core.speculation import (
    ReskewHandoff, RunningAttempt, Speculate, fold_residual, is_event_policy,
)

_EPS = 1e-9


# --------------------------------------------------------------------------
# profile cursor
# --------------------------------------------------------------------------

class ProfileCursor:
    """Amortized O(1) speed-profile queries for nondecreasing times.

    The engine's event clock is monotone per node, so each profile segment is
    crossed once per stage instead of once per task.  The arithmetic mirrors
    ``SimNode.finish_time``/``work_between`` operation-for-operation, so the
    results are bit-identical to the legacy full walks.
    """

    __slots__ = ("segs", "k")

    def __init__(self, profile: Sequence[Tuple[float, float]]):
        self.segs: List[Tuple[float, float]] = list(profile) + [(math.inf, 0.0)]
        self.k = 0

    def _seek(self, t0: float) -> int:
        """Advance the cursor past segments ending at or before t0."""
        k, segs = self.k, self.segs
        while segs[k + 1][0] <= t0:
            k += 1
        self.k = k
        return k

    def finish_time(self, work: float, t0: float) -> float:
        """Earliest t with work_between(t0, t) >= work (t0 nondecreasing)."""
        if work <= 0:
            return t0
        segs = self.segs
        k = self._seek(t0)
        rem = work
        while True:
            s0, sp = segs[k]
            hi = segs[k + 1][0]
            lo = t0 if t0 > s0 else s0
            span = hi - lo
            if sp > 0 and rem <= sp * span:
                return lo + rem / sp
            rem -= sp * span
            if math.isinf(hi):
                if rem > 1e-12:
                    raise RuntimeError(f"node can never finish work={work}")
                return hi
            k += 1

    def work_between(self, t0: float, t1: float) -> float:
        """Integrate speed over [t0, t1] (t0 nondecreasing across calls)."""
        if t1 <= t0:
            return 0.0
        segs = self.segs
        k = self._seek(t0)
        total = 0.0
        while k < len(segs) - 1:
            s0, sp = segs[k]
            s1 = segs[k + 1][0]
            lo = max(t0, s0)
            hi = min(t1, s1)
            if hi > lo:
                total += sp * (hi - lo)
            if s1 >= t1:
                break
            k += 1
        return total


# --------------------------------------------------------------------------
# event-calendar core
# --------------------------------------------------------------------------

def run_stage_events(nodes: Sequence[SimNode], queues: Sequence[Sequence[SimTask]],
                     pull: bool, uplink_bw: Optional[float] = None,
                     start_time: float = 0.0,
                     mitigation=None, faults: Optional[FaultTrace] = None,
                     ) -> StageResult:
    """Event-calendar equivalent of the legacy ``_run_stage`` rescan loop.

    Semantics match the oracle: tasks pipeline I/O and CPU concurrently and
    complete when both are done; active readers of a datanode share
    ``uplink_bw`` equally; a falsy ``uplink_bw`` means infinite I/O rate.

    ``mitigation`` is an event-level straggler policy
    (:class:`~repro_torch.core.speculation.SpeculativeCopies` or
    :class:`~repro_torch.core.speculation.WorkStealing`); it adds cancel,
    re-launch, and idle-recheck events on top of the completion calendar.
    Exact semantics (offer instants, fixpoint order, tie resolution, steal
    granularity) are specified in the ``repro_torch.core.speculation`` module
    docstring and pinned by the differential oracles in
    tests/test_speculation.py and tests/test_speculation_io.py.  On stages
    with effective I/O a duplicate launch (speculative copy / stolen
    remainder) re-fetches its input as a *new flow* through the same
    per-datanode repricing primary readers use; cancelling the loser frees
    its flow and reprices the survivors causally at that instant.  A node
    whose only attempts were cancelled produces no record and keeps its
    previous ``node_finish`` (it completed nothing).

    ``faults`` injects a :class:`~repro_torch.core.faults.FaultTrace`: kill /
    drain / recover sub-events ride the same heap as point events ordered
    *before* any same-instant completion of the same node, a kill frees
    the victim's flow through ``drop_flow`` and re-queues the residual per
    the trace's retry policy, and a surviving speculative copy becomes the
    primary attempt.  Exact semantics (checkpoint flooring, re-queue
    destinations, retry accounting, tie rules) are specified in the
    ``repro_torch.core.faults`` module docstring and pinned by the naive
    full-rescan fault oracle in tests/test_faults.py.
    """
    n = len(nodes)
    shared = deque(queues[0]) if pull else None
    private = None if pull else [deque(q) for q in queues]
    cursors = [ProfileCursor(nd.profile) for nd in nodes]
    overheads = [nd.task_overhead for nd in nodes]
    bw = uplink_bw if uplink_bw else None   # falsy -> infinite rate -> no I/O

    if mitigation is not None:
        if not is_event_policy(mitigation):
            raise ValueError(
                f"{type(mitigation).__name__} is not an event-level policy "
                "(barrier-level ReskewHandoff applies through run_job)")
        pl = getattr(mitigation, "placement", None)
        if pl is not None and pl.policy == "replica" and bw is not None:
            top = max((t.datanode for q in queues for t in q), default=-1)
            if top >= pl.n_datanodes:
                raise ValueError(
                    f"replica placement ring (n_datanodes="
                    f"{pl.n_datanodes}) does not cover datanode {top}")

    task: List[Optional[SimTask]] = [None] * n
    t_started = [0.0] * n
    launch_at = [0.0] * n              # when the attempt's CPU work begins
    attempt_work = [0.0] * n           # work of the current attempt
    attempt_io = [0.0] * n             # input bytes of the current attempt
    #                                    (0 when I/O is not effective)
    cpu_done = [0.0] * n
    io_left = [0.0] * n
    io_rate = [0.0] * n
    io_at = [0.0] * n                  # last checkpoint time of io_left
    reading = [-1] * n                 # datanode being read, -1 = none
    version = [0] * n                  # invalidates superseded heap entries
    twin = [-1] * n                    # node running the other copy, -1=none
    copied: Set[int] = set()           # task_ids ever speculatively copied
    done_durations: List[float] = []   # completed attempt durations

    readers: Dict[int, Set[int]] = {}  # datanode -> node indices mid-I/O
    heap: List[Tuple[float, int, int]] = []

    node_finish = {nd.name: start_time for nd in nodes}
    records: List[TaskRecord] = []

    # ---- fault state (repro_torch.core.faults semantics) -----------------------
    if faults is not None and not faults.events:
        faults = None
    dead = [False] * n
    draining = [False] * n
    requeues: Dict[int, int] = {}      # task_id -> kill-requeues so far
    penalty: Dict[int, float] = {}     # task_id -> pending relaunch penalty
    fevents: List[Tuple[float, int, str]] = []
    if faults is not None:
        if faults.max_node() >= n:
            raise ValueError(
                f"fault trace names node {faults.max_node()} but the stage "
                f"has {n} nodes")
        for i in range(n):
            st = faults.state_at(i, start_time)
            dead[i] = st == DEAD
            draining[i] = st == DRAINING
        fevents = faults.sub_events(start_time)

    def push(t: float, i: int) -> None:
        version[i] += 1
        heapq.heappush(heap, (t, i, version[i]))

    def reprice(d: int, now: float) -> None:
        """Datanode d's reader set changed: checkpoint each of *its* readers
        and re-predict their I/O finishes (the incremental update replacing
        the legacy every-event global rescan).  Readers found already drained
        (a co-reader finished the same instant) leave the flow and fall
        through to their CPU completion, as in the oracle."""
        rd = readers.get(d)
        if not rd:
            return
        drained = []
        for i in rd:
            left = io_left[i] - io_rate[i] * (now - io_at[i])
            io_left[i] = left if left > 0.0 else 0.0
            io_at[i] = now
            if io_left[i] <= _EPS:
                drained.append(i)
        for i in drained:
            rd.discard(i)
            reading[i] = -1
            # causal completion: never before the drain instant (the legacy
            # loop lets a tied drain complete retroactively at cpu_done_at
            # and then applies a negative advancement to every other flow —
            # see the "tie semantics" note in the module docstring)
            push(max(now, cpu_done[i]), i)
        if not rd:
            return
        rate = bw / len(rd)
        for i in rd:
            io_rate[i] = rate
            push(now + io_left[i] / rate, i)

    def start_task(i: int, tk: SimTask, now: float) -> None:
        # a re-queued task's pending relaunch penalty (RetryPolicy backoff)
        # is consumed at its next launch, wherever it lands
        launch = now + overheads[i] + penalty.pop(tk.task_id, 0.0)
        task[i] = tk
        t_started[i] = now
        launch_at[i] = launch
        attempt_work[i] = tk.cpu_work
        cpu_done[i] = cursors[i].finish_time(tk.cpu_work, launch)
        if bw is not None and tk.datanode >= 0 and tk.io_mb > _EPS:
            attempt_io[i] = tk.io_mb
            io_left[i] = tk.io_mb
            io_at[i] = now
            io_rate[i] = 0.0
            reading[i] = tk.datanode
            readers.setdefault(tk.datanode, set()).add(i)
            reprice(tk.datanode, now)
        else:
            attempt_io[i] = 0.0
            io_left[i] = 0.0
            push(cpu_done[i], i)

    def drop_flow(i: int, now: float) -> None:
        """Node i's in-flight flow ends early (cancelled loser / steal
        drained the victim's remaining range): it leaves its datanode's
        reader set and the survivors are repriced causally at ``now`` —
        never retroactively."""
        d = reading[i]
        if d < 0:
            return
        reading[i] = -1
        io_left[i] = 0.0
        readers[d].discard(i)
        reprice(d, now)

    def refill(i: int, now: float) -> None:
        if dead[i] or draining[i]:
            return                     # dead/draining nodes pull nothing new
        if pull:
            nxt = shared.popleft() if shared else None
        else:
            nxt = private[i].popleft() if private[i] else None
        if nxt is not None:
            start_task(i, nxt, now)

    def finish(i: int, now: float) -> None:
        tk = task[i]
        records.append(TaskRecord(tk.task_id, nodes[i].name,
                                  t_started[i], now, attempt_work[i]))
        node_finish[nodes[i].name] = now
        task[i] = None
        loser = -1
        if mitigation is not None:
            done_durations.append(now - t_started[i])
            loser = twin[i]
            if loser >= 0:
                # first finisher wins: cancel the racing copy (no record,
                # no node_finish update — it completed nothing); its
                # in-flight flow is freed and the survivors repriced at
                # this instant
                twin[i] = twin[loser] = -1
                task[loser] = None
                version[loser] += 1   # drop its pending completion event
                drop_flow(loser, now)
        refill(i, now)
        if loser >= 0:
            refill(loser, now)

    def remaining_work(k: int, now: float) -> float:
        """Work of node k's attempt not yet executed at ``now`` (full work
        while still inside the overhead window)."""
        if now < launch_at[k]:
            return attempt_work[k]
        return cursors[k].work_between(now, cpu_done[k])

    # ---- fault handlers (repro_torch.core.faults semantics) --------------------
    def wake_idle(now: float) -> None:
        """Hand queued work to idle usable nodes, ascending index (after a
        kill re-queued work or a recovery brought capacity back)."""
        for k in range(n):
            if task[k] is None:
                refill(k, now)

    def real_task(tk: SimTask) -> bool:
        """Zero-work, zero-byte tasks (an adaptive alive-masked replan
        parks them on dead nodes) are never worth waiting a recovery out
        for — they redistribute immediately instead of serializing the
        stage on a no-op."""
        return tk.cpu_work > _EPS or tk.io_mb > _EPS

    def requeue_task(tk: SimTask, victim: int, now: float) -> None:
        """Queue a task whose node died: pull goes to the back of the
        shared deque; a static victim that recovers later re-executes it on
        recovery (front of its own queue); otherwise the least-loaded alive
        non-draining node takes it (remaining attempt work + queued work,
        ties to the lowest index), falling back to the earliest-recovering
        dead node.  No candidate at all: the work is stranded."""
        if pull:
            shared.append(tk)
            return
        if faults.recovery_after(victim, now) is not None and real_task(tk):
            private[victim].appendleft(tk)
            return
        best, best_load = -1, math.inf
        for j in range(n):
            if dead[j] or draining[j]:
                continue
            load = (remaining_work(j, now) if task[j] is not None else 0.0) \
                + sum(q.cpu_work for q in private[j])
            if load < best_load:
                best, best_load = j, load
        if best < 0:
            best_rec = math.inf
            for j in range(n):
                rec = faults.recovery_after(j, now)
                if rec is not None and rec < best_rec:
                    best, best_rec = j, rec
        if best >= 0:
            private[best].append(tk)

    def shed_queue(i: int, now: float) -> None:
        """A dead static node's private queue: real tasks wait out a
        future recovery (none scheduled: all redistribute); zero-work
        zero-byte tasks redistribute immediately either way."""
        if pull or not private[i]:
            return
        if faults.recovery_after(i, now) is None:
            while private[i]:
                requeue_task(private[i].popleft(), i, now)
            return
        movers = [tk for tk in private[i] if not real_task(tk)]
        if movers:
            stay = [tk for tk in private[i] if real_task(tk)]
            private[i].clear()
            private[i].extend(stay)
            for tk in movers:
                requeue_task(tk, i, now)

    def fault_kill(i: int, now: float) -> None:
        dead[i] = True
        draining[i] = False
        tk = task[i]
        if tk is not None:
            executed = attempt_work[i] - remaining_work(i, now)
            saved = 0.0
            g = faults.checkpoint_grain
            if g > 0.0 and executed > 0.0:
                saved = min(math.floor((executed + _EPS) / g) * g,
                            attempt_work[i])
            if saved > _EPS:
                # grain-boundary checkpoint: the saved prefix survives as a
                # partial record ending at the kill instant
                records.append(TaskRecord(tk.task_id, nodes[i].name,
                                          t_started[i], now, saved))
                node_finish[nodes[i].name] = now
            surviving_copy = twin[i]
            task[i] = None
            version[i] += 1            # drop the pending completion event
            drop_flow(i, now)          # free the flow, reprice survivors
            if surviving_copy >= 0:
                # the racing copy outlives its victim and becomes the
                # task's only attempt: nothing re-queues, no retry charged
                twin[i] = twin[surviving_copy] = -1
            else:
                rem = attempt_work[i] - saved
                if rem > _EPS:
                    k = requeues.get(tk.task_id, 0)
                    if k < faults.retry.max_attempts - 1:
                        requeues[tk.task_id] = k + 1
                        pen = faults.retry.penalty(k + 1)
                        if pen > 0.0:
                            penalty[tk.task_id] = pen
                        # a restart re-fetches input proportional to the
                        # work it still has to do
                        if attempt_io[i] > _EPS and attempt_work[i] > _EPS:
                            io = attempt_io[i] * rem / attempt_work[i]
                        else:
                            io = 0.0
                        requeue_task(
                            SimTask(rem, io, tk.datanode if io > _EPS else -1,
                                    task_id=tk.task_id), i, now)
                    # else: retries exhausted — the residual is abandoned
        shed_queue(i, now)

    def offer_mitigation(now: float) -> None:
        """Fixpoint mitigation sweep (speculation-module semantics): offer
        idle nodes in ascending index; restart after each accepted action;
        schedule idle rechecks once no action is taken."""
        placement = getattr(mitigation, "placement", None)

        def dup_datanode(d: int) -> int:
            return d if placement is None else placement.choose(d)

        while True:
            running = [RunningAttempt(k, task[k].task_id, t_started[k],
                                      attempt_work[k],
                                      remaining_work(k, now),
                                      task[k].task_id in copied,
                                      attempt_io[k])
                       for k in range(n) if task[k] is not None]
            if not running:
                return
            by_node = {r.node: r for r in running}
            acted = False
            for k in range(n):
                if task[k] is not None or dead[k] or draining[k]:
                    continue          # mitigation never offers a dead or
                    #                   draining node new work
                if shared if pull else private[k]:
                    continue          # not idle: work still queued
                act = mitigation.offer(done_durations, running, now)
                if act is None:
                    continue
                victim = by_node[act.victim]
                vt = task[act.victim]
                if isinstance(act, Speculate):
                    # duplicate launch: full original work, from scratch;
                    # with effective I/O the copy re-fetches the full
                    # input as a new flow from the placement-chosen
                    # datanode (start_task joins it to the reader set and
                    # reprices that uplink)
                    copied.add(vt.task_id)
                    start_task(k, SimTask(vt.cpu_work, vt.io_mb,
                                          dup_datanode(vt.datanode),
                                          task_id=vt.task_id), now)
                    twin[k] = act.victim
                    twin[act.victim] = k
                else:                 # Steal: shrink the victim in place
                    v = act.victim
                    moved = 0.0       # input bytes of the stolen range
                    if attempt_io[v] > _EPS and victim.work > 0.0:
                        moved = attempt_io[v] * act.amount / victim.work
                        attempt_io[v] -= moved
                    attempt_work[v] -= act.amount
                    t0 = max(now, launch_at[v])
                    cpu_done[v] = cursors[v].finish_time(
                        victim.remaining - act.amount, t0)
                    if reading[v] >= 0 and moved > 0.0:
                        # the victim stops fetching the stolen range:
                        # checkpoint its flow at the steal instant, drop
                        # the moved bytes (clamped — bytes it already
                        # streamed are not refunded)
                        left = io_left[v] - io_rate[v] * (now - io_at[v])
                        io_left[v] = max(0.0, max(left, 0.0) - moved)
                        io_at[v] = now
                        if io_left[v] <= _EPS:
                            drop_flow(v, now)
                        else:
                            push(now + io_left[v] / io_rate[v], v)
                    if reading[v] < 0:
                        push(cpu_done[v], v)
                    start_task(k, SimTask(act.amount, moved,
                                          dup_datanode(vt.datanode)
                                          if moved > _EPS else -1,
                                          task_id=vt.task_id), now)
                acted = True
                break                 # state changed: restart the sweep
            if not acted:
                for k in range(n):
                    if (task[k] is not None or dead[k] or draining[k]
                            or (shared if pull else private[k])):
                        continue
                    nc = mitigation.next_check(done_durations, running, now)
                    if nc is not None:
                        push(nc, k)   # idle recheck event
                return

    for i in range(n):
        if dead[i] or draining[i]:
            continue                   # not primed: pulls nothing at start
        if pull:
            if shared:
                start_task(i, shared.popleft(), start_time)
        elif private[i]:
            start_task(i, private[i].popleft(), start_time)
    if faults is not None:
        if not pull:
            # nodes dead at the start shed what should not wait for them
            # (everything without a future recovery; no-op tasks always)
            for i in range(n):
                if dead[i]:
                    shed_queue(i, start_time)
            wake_idle(start_time)
        # fault sub-events ride the heap with negative versions: they
        # bypass the version-skip, order before any same-instant completion
        # of the same node, and keep the trace's (t, node, rank) order
        # among themselves
        nf = len(fevents)
        for idx, (ft, fnode, _) in enumerate(fevents):
            heapq.heappush(heap, (ft, fnode, idx - nf))
    if mitigation is not None:
        offer_mitigation(start_time)

    while heap:
        t, i, ver = heapq.heappop(heap)
        if ver < 0:
            kind = fevents[ver + len(fevents)][2]
            if kind == "kill":
                fault_kill(i, t)
                wake_idle(t)           # re-queued work may land on idlers
            elif kind == "drain":
                draining[i] = True
            else:                      # recover
                dead[i] = False
                wake_idle(t)
            if mitigation is not None:
                offer_mitigation(t)
            continue
        if ver != version[i]:
            continue
        if task[i] is None:
            if mitigation is not None:
                offer_mitigation(t)   # idle recheck
            continue
        if reading[i] >= 0:
            # predicted I/O completion for node i
            d = reading[i]
            io_left[i] = 0.0
            reading[i] = -1
            readers[d].discard(i)
            reprice(d, t)
            if t + _EPS >= cpu_done[i]:
                finish(i, t)
                if mitigation is not None:
                    offer_mitigation(t)
            else:
                push(cpu_done[i], i)
        elif t + _EPS >= cpu_done[i]:
            finish(i, t)
            if mitigation is not None:
                offer_mitigation(t)
        else:
            push(cpu_done[i], i)

    return _stage_result(records, node_finish, start_time)


# --------------------------------------------------------------------------
# closed-form fast paths
# --------------------------------------------------------------------------

def _constant_speeds(nodes: Sequence[SimNode]) -> Optional[List[float]]:
    """Per-node speed if every profile is single-segment positive, else None."""
    speeds = []
    for nd in nodes:
        if len(nd.profile) != 1 or nd.profile[0][1] <= 0.0:
            return None
        speeds.append(nd.profile[0][1])
    return speeds


def _io_active(tasks, uplink_bw: Optional[float]) -> bool:
    """True if any task's I/O can delay a completion (finite shared uplink)."""
    if not uplink_bw:
        return False
    return any(t.datanode >= 0 and t.io_mb > _EPS for t in tasks)


def _io_sym_spans_ok(oh: np.ndarray, sp: np.ndarray, work: np.ndarray,
                     io_mb: float, uplink_bw: float, n: int,
                     d: int = 1) -> bool:
    """Network-governed check for the symmetric co-reader closed form: task
    k lands on node ``k % n`` in round ``k // n``; its CPU span must fit
    inside that round's shared-drain time so every round stays a
    simultaneous drain.  ``d`` is the datanode stripe width (``d | n``):
    a full round puts ``n / d`` readers on each datanode; the tail round's
    datanode group j has ``c_j = |{i < q : i % d == j}|`` readers draining
    independently."""
    n_tasks = len(work)
    full_rounds, q = divmod(n_tasks, n)
    idx = np.arange(n_tasks) % n
    spans = oh[idx] + work / sp[idx]
    durations = np.full(n_tasks, io_mb / (uplink_bw / (n // d)))
    if q:
        cj = np.bincount(np.arange(q) % d, minlength=d)
        durations[full_rounds * n:] = \
            io_mb / (uplink_bw / cj[np.arange(q) % d])
    return bool((spans <= durations).all())


def _stripe_width(tasks: Sequence[SimTask], n: int) -> int:
    """Datanode stripe width d >= 1 of a symmetric pull queue: every task
    reads the same positive ``io_mb``, task k from ``dns[k % d]`` where
    ``dns`` is d distinct datanodes and ``d | n`` (so every full round
    loads each datanode with exactly ``n / d`` readers).  0 if the queue
    has no such structure (different io_mb, aperiodic datanodes, d not
    dividing n)."""
    d0, m = tasks[0].datanode, tasks[0].io_mb
    if d0 < 0 or m <= _EPS:
        return 0
    dns = [d0]
    for t in tasks[1:]:
        if t.datanode == d0:
            break
        dns.append(t.datanode)
    d = len(dns)
    if d > n or n % d or len(set(dns)) != d or any(x < 0 for x in dns):
        return 0
    for k, t in enumerate(tasks):
        # exact-routing guard: any io_mb inequality (even 1 ulp) just
        # falls back to the event path, never to a wrong closed form
        if (t.datanode != dns[k % d]
                or not math.isclose(t.io_mb, m, rel_tol=0.0, abs_tol=0.0)):
            return 0
    return d


def _io_symmetric(nodes: Sequence[SimNode], speeds: Sequence[float],
                  tasks: Sequence[SimTask], work: np.ndarray,
                  uplink_bw: Optional[float]) -> int:
    """Stripe width d >= 1 if the stage qualifies for
    ``closed-pull-io-sym`` (round-robin symmetric co-readers, CPU never
    governing a completion — see :func:`_stripe_width` and
    :func:`_io_sym_spans_ok`), else 0."""
    if not uplink_bw:
        return 0
    d = _stripe_width(tasks, len(nodes))
    if not d:
        return 0
    oh = np.asarray([nd.task_overhead for nd in nodes])
    if _io_sym_spans_ok(oh, np.asarray(speeds), work, tasks[0].io_mb,
                        uplink_bw, len(nodes), d):
        return d
    return 0


def _plan(nodes: Sequence[SimNode], queues: Sequence[Sequence[SimTask]],
          pull: bool, uplink_bw: Optional[float],
          ) -> Tuple[str, Optional[List[float]], Optional[np.ndarray]]:
    """Single-pass path selection: (path, speeds, pull work array)."""
    speeds = _constant_speeds(nodes)
    if speeds is None:
        return "event", None, None
    if pull:
        tasks = queues[0]
        if not tasks:
            return "event", speeds, None
        work = np.fromiter((t.cpu_work for t in tasks), np.float64,
                           count=len(tasks))
        if _io_active(tasks, uplink_bw):
            if _io_symmetric(nodes, speeds, tasks, work, uplink_bw):
                return "closed-pull-io-sym", speeds, work
            return "event", speeds, None
        if (work == work[0]).all():
            first = float(work[0])
            if all(nd.task_overhead + first / s > 0.0
                   for nd, s in zip(nodes, speeds)):
                return "closed-pull", speeds, work
            # zero-cost tasks: degenerate grid — the merge scan handles it
        return "closed-pull-hetero", speeds, work
    if any(_io_active(q, uplink_bw) for q in queues):
        return "event", speeds, None
    return "closed-static", speeds, None


def plan_path(nodes: Sequence[SimNode], queues: Sequence[Sequence[SimTask]],
              pull: bool, uplink_bw: Optional[float] = None) -> str:
    """Which execution path ``simulate_stage`` will take: 'closed-pull' |
    'closed-pull-hetero' | 'closed-pull-io-sym' | 'closed-static' |
    'event' (see the module-docstring selection table)."""
    return _plan(nodes, queues, pull, uplink_bw)[0]


def _empty_columns(names: Tuple[str, ...]) -> StageColumns:
    z = np.empty(0, np.float64)
    zi = np.empty(0, np.int64)
    return StageColumns(zi, zi, z, z, z, names)


def _closed_form_static(nodes: Sequence[SimNode], speeds: Sequence[float],
                        assignments: Sequence[Sequence[SimTask]],
                        start_time: float) -> StageResult:
    names = tuple(nd.name for nd in nodes)
    node_finish = {}
    ids_p, nidx_p, starts_p, ends_p, works_p = [], [], [], [], []
    for i, nd in enumerate(nodes):
        q = assignments[i]
        if not q:
            node_finish[nd.name] = start_time
            continue
        work = np.fromiter((t.cpu_work for t in q), np.float64, count=len(q))
        ends = start_time + np.cumsum(nd.task_overhead + work / speeds[i])
        starts = np.empty_like(ends)
        starts[0] = start_time
        starts[1:] = ends[:-1]
        node_finish[nd.name] = float(ends[-1])
        ids_p.append(np.fromiter((t.task_id for t in q), np.int64,
                                 count=len(q)))
        nidx_p.append(np.full(len(q), i, np.int64))
        starts_p.append(starts)
        ends_p.append(ends)
        works_p.append(work)
    if ids_p:
        ids = np.concatenate(ids_p)
        nidx = np.concatenate(nidx_p)
        starts = np.concatenate(starts_p)
        ends = np.concatenate(ends_p)
        works = np.concatenate(works_p)
        order = np.lexsort((nidx, ends))     # oracle order: (time, node idx)
        cols = StageColumns(ids[order], nidx[order], starts[order],
                            ends[order], works[order], names)
    else:
        cols = _empty_columns(names)
    return _stage_result_columns(cols, node_finish, start_time)


def _pull_uniform_grid(periods: np.ndarray, n_tasks: int,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the uniform-pull grid: node i is free to pull at grid times
    ``j * periods[i]``; the schedule is the n_tasks smallest grid points,
    ties resolved by node index (the oracle's lowest-index scan).  Bisect a
    threshold so only ~n_tasks candidates are materialized before the
    lexsort.  Returns ``(pull_node, pull_seq)``: the pulling node and its
    per-node pull sequence number for each scheduled task.  Shared by the
    record path and run_job's record-free summaries — one solver, one
    tie-break."""
    n = len(periods)
    lo, hi = 0.0, float(periods.min()) * (n_tasks + 1)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if int(np.floor(mid / periods).sum()) + n >= n_tasks:
            hi = mid
        else:
            lo = mid
    per_node = np.minimum(np.floor(hi / periods).astype(np.int64) + 2, n_tasks)
    node_idx = np.repeat(np.arange(n), per_node)
    seq = np.concatenate([np.arange(c) for c in per_node])
    times = seq * periods[node_idx]
    order = np.lexsort((node_idx, times))[:n_tasks]
    return node_idx[order], seq[order]


def _closed_form_pull_uniform(nodes: Sequence[SimNode], speeds: Sequence[float],
                              tasks: Sequence[SimTask], work: float,
                              start_time: float) -> StageResult:
    n, n_tasks = len(nodes), len(tasks)
    periods = np.asarray([nd.task_overhead + work / s
                          for nd, s in zip(nodes, speeds)])
    pull_node, pull_seq = _pull_uniform_grid(periods, n_tasks)
    starts = start_time + pull_seq * periods[pull_node]
    ends = start_time + (pull_seq + 1) * periods[pull_node]
    counts = np.bincount(pull_node, minlength=n)

    order = np.lexsort((pull_node, ends))    # completion order
    names = tuple(nd.name for nd in nodes)
    ids = np.fromiter((t.task_id for t in tasks), np.int64, count=n_tasks)
    cols = StageColumns(ids[order], pull_node[order], starts[order],
                        ends[order], np.full(n_tasks, work, np.float64),
                        names)
    node_finish = {
        nd.name: (start_time + float(counts[i] * periods[i])
                  if counts[i] else start_time)
        for i, nd in enumerate(nodes)}
    return _stage_result_columns(cols, node_finish, start_time)


def _pull_hetero_heap(oh: Sequence[float], speeds: Sequence[float],
                      works: Sequence[float], start_time: float,
                      ) -> Tuple[List[Tuple[float, int]], List[int]]:
    """Initial pulls of the merged-grid scan: node i takes task i at the
    stage start; the heap keys ``(end, node)`` reproduce the event
    calendar's lowest-index tie-break.  ``end = (free + overhead) +
    work/speed`` is the exact arithmetic of the constant-speed
    ``finish_time``, so end times match the event calendar bitwise."""
    n_live = min(len(speeds), len(works))
    cur_task = [-1] * len(speeds)
    heap: List[Tuple[float, int]] = []
    for i in range(n_live):
        w = works[i]
        e = start_time + oh[i]
        if w > 0.0:
            e += w / speeds[i]
        heap.append((e, i))
        cur_task[i] = i
    heapq.heapify(heap)
    return heap, cur_task


_RUN_BATCH_MIN = 32     # mean run length below which the heap scan wins


def _pull_hetero_try_batched(oh: Sequence[float], speeds: Sequence[float],
                             works: Sequence[float], start_time: float,
                             want_records: bool):
    """Run-length batched merged-grid scan (ROADMAP item: numpy batching).

    Real shuffle stages (Fig 18 skewed-hash buckets, even splits) enqueue
    *runs* of equal-sized tasks.  Within such a run the merge is the
    offset-uniform-grid problem: node i pulls at ``e_i + m * p_i`` with
    period ``p_i = oh_i + w / s_i``, and the run's schedule is its R
    lexicographically smallest ``(time, node)`` grid points — solved here
    with ``np.lexsort`` over per-node candidate grids instead of R heap
    steps, cutting the ~0.3 us/task pure-Python heap cost to amortized
    numpy.  Tie semantics match the heap exactly: within a path identical
    nodes generate bit-identical grids, and ``lexsort((node, time))``
    reproduces the ``(end, node)`` heap key order.

    Returns ``(node_end, counts, per_task)`` — ``per_task`` is
    ``(node_of, start_of, end_of)`` numpy arrays when ``want_records`` —
    or None when the input is a poor fit (short mean run length, or a
    degenerate zero period somewhere) and the caller should take the heap
    scan.
    """
    w_arr = np.asarray(works, np.float64)
    n_tasks = len(w_arr)
    n = len(speeds)
    if n_tasks < 2 * _RUN_BATCH_MIN:
        return None
    # exact run-length grouping: works that differ by any amount are
    # different runs; float noise only shrinks runs (slower, never wrong)
    change = np.flatnonzero(np.diff(w_arr)) + 1
    bounds = np.concatenate(([0], change, [n_tasks]))
    n_runs = len(bounds) - 1
    if n_runs * _RUN_BATCH_MIN > n_tasks:
        return None                     # mostly distinct sizes: heap wins
    oh_a = np.asarray(oh, np.float64)
    sp = np.asarray(speeds, np.float64)
    run_w = w_arr[bounds[:-1]]
    periods = oh_a[None, :] + run_w[:, None] / sp[None, :]   # [runs, n]
    if (periods <= 0.0).any():
        return None                     # zero-period degenerate: heap scan
    e = np.full(n, float(start_time))
    counts = np.zeros(n, np.int64)
    wsums = np.zeros(n, np.float64)
    if want_records:
        node_of = np.empty(n_tasks, np.int64)
        start_of = np.empty(n_tasks, np.float64)
        end_of = np.empty(n_tasks, np.float64)
    arange_n = np.arange(n)
    for r in range(n_runs):
        k0, k1 = int(bounds[r]), int(bounds[r + 1])
        big_r = k1 - k0
        p = periods[r]
        # candidate cap: the fluid pull time t0 solving
        # sum_i((t0 - e_i)/p_i + 1) = R, plus one max period.  count(t) =
        # sum_i max(0, floor((t - e_i)/p_i) + 1) satisfies count(t0) >=
        # R - n and gains >= n per max(p), so count(cap) >= R: every one
        # of the run's R merged pull points is <= cap.  +2 absorbs float
        # rounding at the boundary (over-generation is harmless — lexsort
        # keeps the R smallest — under-generation is not).
        inv = 1.0 / p
        t0 = (big_r - n + (e * inv).sum()) / inv.sum()
        cap = t0 + p.max()
        m = np.floor((cap - e) * inv).astype(np.int64) + 2
        np.clip(m, 0, big_r, out=m)
        if int(m.sum()) < big_r:      # fp paranoia: conservative re-cap
            cap = (e + (big_r - 1) * p).min()
            m = np.floor((cap - e) * inv).astype(np.int64) + 2
            np.clip(m, 0, big_r, out=m)
        node_idx = np.repeat(arange_n, m)
        seq = np.concatenate([np.arange(c) for c in m])
        times = e[node_idx] + seq * p[node_idx]
        order = np.lexsort((node_idx, times))[:big_r]
        sel = node_idx[order]
        taken = np.bincount(sel, minlength=n)
        if want_records:
            node_of[k0:k1] = sel
            pulls = times[order]
            start_of[k0:k1] = pulls
            end_of[k0:k1] = pulls + p[sel]
        e = e + taken * p
        counts += taken
        wsums += taken * run_w[r]
    node_end = np.where(counts > 0, e, start_time)
    per_task = (node_of, start_of, end_of) if want_records else None
    return node_end.tolist(), counts.tolist(), wsums.tolist(), per_task


def _pull_hetero_summary(oh: Sequence[float], speeds: Sequence[float],
                         works: Sequence[float], start_time: float,
                         ) -> Tuple[List[float], List[int], List[float]]:
    """Record-free merged-grid scan: per-node (last finish, task count,
    executed work) only — the whole-job (``run_job``) hot loop, with no
    per-task object work at all.  Blocky work sequences (runs of equal
    sizes) take the numpy run-length batched path."""
    batched = _pull_hetero_try_batched(oh, speeds, works, start_time, False)
    if batched is not None:
        return batched[0], batched[1], batched[2]
    n, n_tasks = len(speeds), len(works)
    heap, _ = _pull_hetero_heap(oh, speeds, works, start_time)
    counts = [0] * n
    wsums = [0.0] * n
    for _, i in heap:
        counts[i] = 1
        wsums[i] = works[i]
    replace = heapq.heapreplace
    for k in range(min(n, n_tasks), n_tasks):
        w = works[k]
        e0, i = heap[0]
        e = e0 + oh[i]
        if w > 0.0:
            e += w / speeds[i]
        counts[i] += 1
        wsums[i] += w
        replace(heap, (e, i))
    node_end = [start_time] * n
    for e0, i in heap:
        node_end[i] = e0
    return node_end, counts, wsums


def _closed_form_pull_hetero(nodes: Sequence[SimNode], speeds: Sequence[float],
                             tasks: Sequence[SimTask], work: np.ndarray,
                             start_time: float) -> StageResult:
    """Full merged-grid scan (see module docstring): FIFO hands task k to
    the owner of the k-th smallest end event; per-task (node, start, end)
    are stored into flat lists and records are materialized once at the
    end, in task order.  Blocky work sequences take the numpy run-length
    batched path (``_pull_hetero_try_batched``)."""
    n, n_tasks = len(nodes), len(tasks)
    oh = [nd.task_overhead for nd in nodes]
    names = tuple(nd.name for nd in nodes)
    ids = np.fromiter((t.task_id for t in tasks), np.int64, count=n_tasks)
    batched = _pull_hetero_try_batched(oh, speeds, work, start_time, True)
    if batched is not None:
        node_end, _, _, (node_arr, start_arr, end_arr) = batched
        cols = StageColumns(ids, node_arr.astype(np.int64, copy=False),
                            start_arr, end_arr,
                            np.asarray(work, np.float64), names)
        node_finish = {names[i]: node_end[i] for i in range(n)}
        return _stage_result_columns(cols, node_finish, start_time)
    works = work.tolist()
    heap, cur_task = _pull_hetero_heap(oh, speeds, works, start_time)
    node_of = list(range(min(n, n_tasks))) + [0] * (n_tasks - min(n, n_tasks))
    start_of = [start_time] * n_tasks
    end_of = [0.0] * n_tasks
    replace = heapq.heapreplace
    for k in range(min(n, n_tasks), n_tasks):
        e0, i = heap[0]
        end_of[cur_task[i]] = e0
        w = works[k]
        e = e0 + oh[i]
        if w > 0.0:
            e += w / speeds[i]
        start_of[k] = e0
        node_of[k] = i
        cur_task[i] = k
        replace(heap, (e, i))
    node_end = [start_time] * n
    while heap:
        e0, i = heapq.heappop(heap)
        end_of[cur_task[i]] = e0
        node_end[i] = e0
    cols = StageColumns(ids, np.asarray(node_of, np.int64),
                        np.asarray(start_of, np.float64),
                        np.asarray(end_of, np.float64),
                        np.asarray(work, np.float64), names)
    node_finish = {names[i]: node_end[i] for i in range(n)}
    return _stage_result_columns(cols, node_finish, start_time)


def _io_sym_schedule(n: int, n_tasks: int, io_mb: float, uplink_bw: float,
                     start_time: float, d: int = 1,
                     ) -> Tuple[np.ndarray, np.ndarray,
                                List[float], List[int]]:
    """Round times for ``closed-pull-io-sym``: task k runs on node ``k % n``
    in round ``k // n`` reading datanode ``k % d`` of the stripe (``d | n``,
    so each full round's datanode groups hold ``n / d`` co-readers each and
    all drain simultaneously after ``io_mb / (uplink_bw / (n/d))``; the
    tail round's group j, ``c_j`` readers, drains independently after
    ``io_mb / (uplink_bw / c_j)``).  Returns per-task (starts, ends) plus
    per-node (last finish, task count)."""
    full_rounds, q = divmod(n_tasks, n)
    full = io_mb / (uplink_bw / (n // d))
    ks = np.arange(n_tasks)
    starts = start_time + (ks // n) * full
    ends = starts + full
    tail_end = [start_time + full_rounds * full
                + (io_mb / (uplink_bw / int(c)) if c else 0.0)
                for c in np.bincount(np.arange(q) % d, minlength=d)]
    if q:
        ends[full_rounds * n:] = [tail_end[i % d] for i in range(q)]
    node_end, counts = [], []
    for i in range(n):
        if q and i < q:
            node_end.append(tail_end[i % d])
            counts.append(full_rounds + 1)
        elif full_rounds:
            node_end.append(start_time + full_rounds * full)
            counts.append(full_rounds)
        else:
            node_end.append(start_time)   # never ran
            counts.append(0)
    return starts, ends, node_end, counts


def _closed_form_pull_io_sym(nodes: Sequence[SimNode],
                             tasks: Sequence[SimTask], uplink_bw: float,
                             start_time: float) -> StageResult:
    n, n_tasks = len(nodes), len(tasks)
    starts, ends, node_end, _ = _io_sym_schedule(
        n, n_tasks, tasks[0].io_mb, uplink_bw, start_time,
        _stripe_width(tasks, n))
    names = tuple(nd.name for nd in nodes)
    cols = StageColumns(
        np.fromiter((t.task_id for t in tasks), np.int64, count=n_tasks),
        np.arange(n_tasks, dtype=np.int64) % n,
        np.asarray(starts, np.float64), np.asarray(ends, np.float64),
        np.fromiter((t.cpu_work for t in tasks), np.float64, count=n_tasks),
        names)
    node_finish = {names[i]: node_end[i] for i in range(n)}
    return _stage_result_columns(cols, node_finish, start_time)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def simulate_stage(nodes: Sequence[SimNode], queues: Sequence[Sequence[SimTask]],
                   pull: bool, uplink_bw: Optional[float] = None,
                   start_time: float = 0.0, mitigation=None,
                   faults: Optional[FaultTrace] = None) -> StageResult:
    """Run one stage on the fastest applicable path (see module docstring).

    ``mitigation`` must be an event-level policy (SpeculativeCopies /
    WorkStealing); mitigated stages always take the event calendar — the
    closed forms model no cancel/re-launch events.  Barrier-level policies
    (ReskewHandoff) are applied by :func:`run_job`, not per stage.
    ``faults`` (a non-empty :class:`~repro_torch.core.faults.FaultTrace`) also
    forces the event calendar — kills/drains/recoveries are point events
    with no closed form.
    """
    if faults is not None and faults.events:
        return run_stage_events(nodes, queues, pull, uplink_bw, start_time,
                                mitigation, faults)
    if mitigation is not None:
        return run_stage_events(nodes, queues, pull, uplink_bw, start_time,
                                mitigation)   # validates the policy kind
    path, speeds, work = _plan(nodes, queues, pull, uplink_bw)
    if path == "closed-pull":
        return _closed_form_pull_uniform(nodes, speeds, queues[0],
                                         float(work[0]), start_time)
    if path == "closed-pull-hetero":
        return _closed_form_pull_hetero(nodes, speeds, queues[0], work,
                                        start_time)
    if path == "closed-pull-io-sym":
        return _closed_form_pull_io_sym(nodes, queues[0], uplink_bw,
                                        start_time)
    if path == "closed-static":
        return _closed_form_static(nodes, speeds, queues, start_time)
    return run_stage_events(nodes, queues, pull, uplink_bw, start_time)


# --------------------------------------------------------------------------
# whole jobs: stage specs + barrier-carrying run_job
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PullSpec:
    """One HomT stage: a shared FIFO queue that idle nodes pull from.

    Either ``n_tasks`` uniform tasks of ``task_work`` each, or explicit
    per-task ``works`` in queue order (coerced to a tuple so specs stay
    hashable — equal specs share one cached solve inside ``run_job``).
    Optional symmetric I/O: every task reads ``io_mb`` from ``datanode``.
    ``mitigation`` is an event-level straggler policy from
    ``repro_torch.core.speculation`` (hashable frozen dataclass) applied while
    the stage runs; pull stages reject barrier-level ReskewHandoff.
    """
    n_tasks: int = 0
    task_work: float = 0.0
    works: Optional[Tuple[float, ...]] = None
    io_mb: float = 0.0
    datanode: int = -1
    mitigation: Optional[object] = None

    def __post_init__(self):
        if self.works is not None:
            object.__setattr__(self, "works",
                               tuple(float(w) for w in self.works))
        if isinstance(self.mitigation, ReskewHandoff):
            raise ValueError("ReskewHandoff is barrier-level and applies to "
                             "StaticSpec stages only")

    def work_array(self) -> np.ndarray:
        if self.works is not None:
            return np.asarray(self.works, np.float64)
        return np.full(self.n_tasks, float(self.task_work))


@dataclass(frozen=True)
class StaticSpec:
    """One HeMT stage: ``works[i]`` is node i's single macrotask.  Every
    node runs exactly one task (zero-work macrotasks still pay the per-task
    overhead and count as having run, matching ``run_static_stage`` with
    one ``SimTask`` per node).  ``mitigation`` accepts event-level policies
    (applied while the stage runs) or barrier-level ReskewHandoff (applied
    by ``run_job`` at this stage's barrier: stragglers are cut and their
    residual work folds into the next stage's split).

    Optional I/O (the Claim 2 x mitigation cross setting): ``io_mb`` is the
    stage's TOTAL input, split across macrotasks proportionally to
    ``works`` (evenly when every work is zero) and read from ``datanode``
    through the flow-shared uplink.  Stages with effective I/O solve on
    the event calendar; mitigated ones launch duplicate readers there."""
    works: Tuple[float, ...]
    mitigation: Optional[object] = None
    io_mb: float = 0.0
    datanode: int = -1

    def __post_init__(self):
        object.__setattr__(self, "works",
                           tuple(float(w) for w in self.works))

    def io_split(self) -> Tuple[float, ...]:
        """Per-node input bytes: ``io_mb`` proportional to ``works``."""
        n = len(self.works)
        if self.io_mb <= 0.0 or self.datanode < 0 or n == 0:
            return (0.0,) * n
        total = sum(self.works)
        if total <= 0.0:
            return (self.io_mb / n,) * n
        return tuple(self.io_mb * w / total for w in self.works)


@dataclass
class StageSummary:
    """Record-free stage outcome (the whole-job analogue of StageResult)."""
    start: float
    completion: float
    idle_time: float
    node_finish: Dict[str, float]
    counts: Dict[str, int]           # tasks completed per node
    # CPU work each node actually executed (post re-skew cut, where one
    # applies) — what the OA-HeMT loop feeds the AR(1) estimator as d_i
    work: Dict[str, float] = field(default_factory=dict)

    @property
    def span(self) -> float:
        return self.completion - self.start


class JobContinuation(NamedTuple):
    """Splice point for a resumed :func:`run_job`: skip stages before
    ``next_stage`` and run the rest starting at absolute ``clock``, with an
    optional re-skew ``carry`` — ``(residual work, per-node throughputs)``
    exactly as a ReskewHandoff barrier produces — folded into the first
    resumed stage.  This is how a resident scheduler
    (:mod:`repro.core.resident`) hands a job's unaffected tail back to the
    closed-form solver after the last fault/resize has been spliced in."""
    next_stage: int
    clock: float
    carry: Optional[Tuple[float, Tuple[float, ...]]] = None


@dataclass
class JobSchedule:
    completion: float
    stages: List[StageSummary]
    # the continuation this schedule was resumed from (None: ran from
    # stage 0) — stages[k] is then the (continuation.next_stage + k)-th
    # program stage
    continuation: Optional[JobContinuation] = None

    @property
    def makespan(self) -> float:
        return self.completion


def _rel_from_offsets(offs: List[float], counts: List[int],
                      works: List[float],
                      ) -> Tuple[float, float, List[float], List[int],
                                 List[float]]:
    """(span, idle, offsets, counts, executed works) from per-node finish
    offsets; idle is the finish spread over nodes that ran >= 1 task
    (Claim 1 metric)."""
    ran = [o for o, c in zip(offs, counts) if c]
    span = max(offs) if offs else 0.0
    idle = (max(ran) - min(ran)) if ran else 0.0
    return span, idle, offs, counts, works


def _rel_summary_static(oh: Sequence[float], speeds: Sequence[float],
                        spec: StaticSpec):
    if len(spec.works) != len(speeds):
        raise ValueError("StaticSpec needs one macrotask work per node")
    offs = [o + w / s for o, w, s in zip(oh, spec.works, speeds)]
    return _rel_from_offsets(offs, [1] * len(offs), list(spec.works))


def _rel_summary_pull_uniform(oh: Sequence[float], speeds: Sequence[float],
                              n_tasks: int, work: float):
    """Counts + finish offsets of the uniform grid, record-free: the same
    ``_pull_uniform_grid`` solve as ``_closed_form_pull_uniform``, stopping
    at the per-node ``bincount``."""
    periods = np.asarray([o + work / s for o, s in zip(oh, speeds)])
    pull_node, _ = _pull_uniform_grid(periods, n_tasks)
    counts = np.bincount(pull_node, minlength=len(speeds))
    offs = [float(c * p) if c else 0.0 for c, p in zip(counts, periods)]
    return _rel_from_offsets(offs, counts.tolist(),
                             [float(c * work) for c in counts])


def _rel_summary_from_result(res: StageResult, names: Sequence[str],
                             start: float):
    """Per-node counts/works via the columnar view (a bincount — no
    ``TaskRecord`` is materialized on closed-form results)."""
    cols = res.columns()
    n = len(names)
    if cols.node_names == tuple(names):
        nidx = cols.node_index
    else:       # stage ran on a subset / different order of ``names``
        idx_of = {nm: i for i, nm in enumerate(names)}
        remap = np.asarray([idx_of[nm] for nm in cols.node_names], np.int64)
        nidx = remap[cols.node_index]
    counts = np.bincount(nidx, minlength=n)
    works = np.bincount(nidx, weights=cols.works, minlength=n)
    offs = [res.node_finish[nm] - start for nm in names]
    return _rel_from_offsets(offs, counts.tolist(), works.tolist())


def _spec_tasks(spec) -> Sequence[Sequence[SimTask]]:
    """Materialize a spec into engine queues (the event-path fallback)."""
    if isinstance(spec, StaticSpec):
        ios = spec.io_split()
        return [[SimTask(w, ios[i], spec.datanode if ios[i] > 0.0 else -1,
                         task_id=i)]
                for i, w in enumerate(spec.works)]
    return [[SimTask(float(w), spec.io_mb, spec.datanode, task_id=k)
             for k, w in enumerate(spec.work_array())]]


def _rel_summary(nodes: Sequence[SimNode], speeds: Sequence[float],
                 spec, uplink_bw: Optional[float]):
    """Solve one stage spec at relative start 0 on a constant-speed
    cluster: (span, idle, per-node finish offsets, per-node counts,
    per-node executed works).  Stages with an event-level mitigation
    policy — I/O or not — run the mitigated event calendar: flow sharing,
    elapsed-time triggers and placement are all relative to the stage
    start, so the solve is still start-invariant on constant speeds and
    stays shiftable and cacheable."""
    oh = [nd.task_overhead for nd in nodes]
    n = len(nodes)
    if is_event_policy(spec.mitigation):
        res = run_stage_events(nodes, _spec_tasks(spec),
                               pull=not isinstance(spec, StaticSpec),
                               uplink_bw=uplink_bw,
                               mitigation=spec.mitigation)
        return _rel_summary_from_result(res, [nd.name for nd in nodes], 0.0)
    if isinstance(spec, StaticSpec):
        if uplink_bw and spec.io_mb > _EPS and spec.datanode >= 0:
            res = run_stage_events(nodes, _spec_tasks(spec), pull=False,
                                   uplink_bw=uplink_bw)
            return _rel_summary_from_result(res, [nd.name for nd in nodes],
                                            0.0)
        return _rel_summary_static(oh, speeds, spec)
    works = spec.works
    n_tasks = spec.n_tasks if works is None else len(works)
    if n_tasks == 0:
        return 0.0, 0.0, [0.0] * n, [0] * n, [0.0] * n
    if uplink_bw and spec.io_mb > _EPS and spec.datanode >= 0:
        if _io_sym_spans_ok(np.asarray(oh), np.asarray(speeds),
                            spec.work_array(), spec.io_mb, uplink_bw, n):
            _, _, node_end, counts = _io_sym_schedule(
                n, n_tasks, spec.io_mb, uplink_bw, 0.0)
            wsums = np.bincount(np.arange(n_tasks) % n,
                                weights=spec.work_array(), minlength=n)
            return _rel_from_offsets(node_end, counts, wsums.tolist())
        res = run_stage_events(nodes, _spec_tasks(spec), pull=True,
                               uplink_bw=uplink_bw)
        return _rel_summary_from_result(res, [nd.name for nd in nodes], 0.0)
    w0 = float(spec.task_work) if works is None else works[0]
    uniform = works is None or all(w == w0 for w in works)
    if uniform and all(o + w0 / s > 0.0 for o, s in zip(oh, speeds)):
        return _rel_summary_pull_uniform(oh, speeds, n_tasks, w0)
    if works is None:               # uniform but degenerate (zero period)
        works = (w0,) * n_tasks
    node_end, counts, wsums = _pull_hetero_summary(oh, speeds, works, 0.0)
    return _rel_from_offsets(node_end, counts, wsums)


def _abs_summary(nodes: Sequence[SimNode], spec, uplink_bw: Optional[float],
                 start: float,
                 faults: Optional[FaultTrace] = None) -> StageSummary:
    """Non-shiftable fallback (multi-segment profiles, fault-affected
    windows): run the stage at its true absolute start through the
    auto-selecting engine."""
    mit = spec.mitigation if is_event_policy(spec.mitigation) else None
    res = simulate_stage(nodes, _spec_tasks(spec),
                         pull=not isinstance(spec, StaticSpec),
                         uplink_bw=uplink_bw, start_time=start,
                         mitigation=mit, faults=faults)
    names = [nd.name for nd in nodes]
    _, idle, offs, counts, wexec = _rel_summary_from_result(res, names, start)
    return StageSummary(start, res.completion, idle,
                        dict(res.node_finish),
                        {nm: c for nm, c in zip(names, counts)},
                        {nm: w for nm, w in zip(names, wexec)})


# Module-level LRU sharing constant-speed solves across run_job calls
# (ROADMAP item: repeated benchmark invocations and the adaptive
# schedulers resolve identical (cluster, spec) stages over and over).
_SOLVE_CACHE: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_SOLVE_CACHE_MAX = 512


def run_job_cache_clear() -> None:
    """Drop the module-level (cluster signature, spec) solve cache."""
    _SOLVE_CACHE.clear()


def _cluster_signature(nodes: Sequence[SimNode]) -> Tuple:
    """Hashable timing identity of a cluster: per-node (overhead, profile)
    in node order.  Names are excluded — they label results but never
    affect timing."""
    return tuple((nd.task_overhead, tuple(nd.profile)) for nd in nodes)


def _apply_reskew(nodes: Sequence[SimNode], spec: "StaticSpec",
                  summ: StageSummary, names: Sequence[str],
                  ) -> Tuple[StageSummary, float, List[float]]:
    """Barrier-level re-skew hand-off (speculation-module semantics): cut
    nodes still running past ``cutoff_factor * median`` of the per-node
    finish offsets; return the clipped summary, the total residual
    (unexecuted) work, and the observed per-node throughputs the fold is
    proportional to."""
    offs = [summ.node_finish[nm] - summ.start for nm in names]
    ran = [o for nm, o in zip(names, offs) if summ.counts[nm]]
    cutoff = spec.mitigation.cutoff(ran)
    residual = 0.0
    clipped: List[float] = []
    executed: List[float] = []
    for nd, off, w in zip(nodes, offs, spec.works):
        if off > cutoff + _EPS:
            r = min(nd.work_between(summ.start + cutoff, summ.start + off), w)
            residual += r
            clipped.append(cutoff)
            executed.append(w - r)
        else:
            clipped.append(off)
            executed.append(w)
    if residual <= 0.0:
        return summ, 0.0, []
    throughputs = [x / c if c > 0.0 else 0.0
                   for x, c in zip(executed, clipped)]
    span, idle, offs2, _, _ = _rel_from_offsets(
        clipped, [summ.counts[nm] for nm in names], executed)
    new = StageSummary(summ.start, summ.start + span, idle,
                       {nm: summ.start + o for nm, o in zip(names, offs2)},
                       dict(summ.counts),
                       {nm: x for nm, x in zip(names, executed)})
    return new, residual, throughputs


def _fold_spec(spec, residual: float, throughputs: Sequence[float]):
    """Fold residual work into the next stage's split: StaticSpec works
    grow proportionally to observed throughput (``fold_residual``); a
    PullSpec scales uniformly — its shared queue self-balances, so where
    the residual lands is decided at run time anyway."""
    if isinstance(spec, StaticSpec):
        return StaticSpec(works=tuple(fold_residual(spec.works, residual,
                                                    throughputs)),
                          mitigation=spec.mitigation,
                          io_mb=spec.io_mb, datanode=spec.datanode)
    w = spec.work_array()
    total = float(w.sum())
    if total > 0.0:
        scaled = tuple(float(x) for x in w * (1.0 + residual / total))
    else:
        scaled = tuple(float(x) + residual / len(w) for x in w)
    return PullSpec(works=scaled, io_mb=spec.io_mb, datanode=spec.datanode,
                    mitigation=spec.mitigation)


class AdaptiveStageLog(NamedTuple):
    """One ``run_job`` stage as the adaptive plan finally shaped it."""
    index: int
    works: Optional[Tuple[float, ...]]   # final static split (None for pull)
    speeds: Optional[Tuple[float, ...]]  # estimates used (None: kept planned)
    replanned: bool


class AdaptivePlan:
    """Online-adaptive HeMT (paper §5) across ``run_job`` barriers.

    At every program barrier the finished stage's observed per-node
    (executed work, busy time) pairs are fed into an
    :class:`~repro_torch.core.estimators.ARSpeedEstimator`; each upcoming
    :class:`StaticSpec` whose estimator already has direct observations is
    re-split ``d_i = D v_i / V`` from the updated estimates before it is
    solved.  The first stage (cold estimator) runs the caller's planned
    split — the paper's k=1 rule lives with the caller.  :class:`PullSpec`
    stages are never re-planned (the shared queue self-balances at run
    time) but still feed the estimator.

    Composition with :class:`~repro_torch.core.speculation.ReskewHandoff`: the
    residual a cut stage carries is folded into the next stage's works
    *before* the re-plan, so the re-split redistributes planned work and
    residual together — both re-skewed by the freshest estimates.

    ``quantum`` makes re-planned splits integral: works become multiples
    of ``quantum`` via largest-remainder rounding (``proportional_split``),
    with at least ``min_units`` quanta per node — the HeMT-DP driver's
    whole-grain macrotasks (``min_units`` requires a quantum: a float
    split has no unit to floor by, so passing it without one raises
    rather than silently dropping the paper-§5.1 starvation guard).  A
    total that is not a whole number of quanta (a re-skew hand-off folds
    *continuous* residual work into the next stage) is conserved exactly:
    the whole quanta are split proportionally and the sub-quantum
    remainder rides as a fractional tail on the fastest-estimated
    executor.  Quantum plans observe speeds in **quanta per second**
    (executed work / quantum), the native unit of a whole-grain system —
    the same grains/sec the driver's :class:`~repro.core.planner.
    GrainPlanner` records, so sharing its estimator mixes no units
    (splits are ratio-based and unit-invariant either way).

    ``estimator`` may be shared with a scheduler
    (:meth:`repro.core.scheduler.AdaptiveHeMTScheduler.adaptive_plan`) so
    job-sequence learning and in-job barrier learning accumulate into one
    workload-specific state.  ``history`` logs every stage's final works
    (re-planned or kept), which is how drivers recover per-stage
    assignments from a record-free adaptive run.
    """

    def __init__(self, estimator: Optional[ARSpeedEstimator] = None, *,
                 alpha: float = 0.0, cold_start: str = "mean",
                 quantum: Optional[float] = None, min_units: int = 0):
        if estimator is None:
            estimator = ARSpeedEstimator(alpha=alpha, cold_start=cold_start)
        if quantum is not None and quantum <= 0.0:
            raise ValueError("quantum must be positive")
        if min_units < 0:
            raise ValueError("min_units must be >= 0")
        if min_units > 0 and quantum is None:
            raise ValueError("min_units needs a quantum to floor by "
                             "(float splits apply no per-node floor)")
        self.estimator = estimator
        self.quantum = quantum
        self.min_units = min_units
        self.history: List[AdaptiveStageLog] = []

    def _split_with(self, speeds: Sequence[float], total: float,
                    alive: Optional[Sequence[bool]] = None) -> List[float]:
        if alive is not None and not all(alive):
            # fault-aware re-split (run_job barriers): dead/draining nodes
            # get zero work, survivors split the whole total among
            # themselves (min_units floor applies to survivors only);
            # nobody alive falls back to the full split — the stage will
            # strand either way and the planned shape is as good as any
            idx = [i for i, a in enumerate(alive) if a]
            if idx:
                sub = self._split_with([speeds[i] for i in idx], total)
                out = [0.0] * len(speeds)
                for i, w in zip(idx, sub):
                    out[i] = w
                return out
        n = len(speeds)
        if not any(s > 0.0 for s in speeds):
            # V = 0 (every executor cold/zero-speed at this barrier):
            # d_i = D v_i / V is 0/0 — fall back to the even split instead
            # of dividing by zero (the paper's k=1 rule is exactly this)
            speeds = [1.0] * n
        if self.quantum is None:
            return hemt_split_floats(total, speeds)
        units = int(round(total / self.quantum))
        if abs(units * self.quantum - total) > 1e-9 * max(1.0, abs(total)):
            # continuous residual folded by a re-skew hand-off: split the
            # whole quanta, ride the sub-quantum remainder on the fastest
            # estimated executor (work is conserved exactly; a crash here
            # would strand the run mid-job on an internally-generated
            # total the caller never chose)
            units = int(total / self.quantum)
        if units == 0 or units < self.min_units * n:
            # Degenerate quantization: either D < quantum (no executor
            # can receive a whole quantum, so largest-remainder rounding
            # has nothing to round and the whole total would ride the
            # fastest executor) or D holds fewer whole quanta than the
            # min_units floor needs (a re-skew hand-off can fold an
            # arbitrarily small residual into the next stage) — both
            # cannot honor whole-grain proportional rounding, so split
            # the total evenly instead of raising "min_share infeasible"
            # mid-job on a total the caller never chose
            return [total / n] * n
        remainder = total - units * self.quantum
        works = [float(u * self.quantum) for u in
                 proportional_split(units, speeds,
                                    min_share=self.min_units)]
        if remainder > 0.0:
            works[max(range(len(works)), key=lambda i: speeds[i])] \
                += remainder
        return works

    def split(self, names: Sequence[str], total: float,
              alive: Optional[Sequence[bool]] = None) -> List[float]:
        """The current estimates' HeMT split of ``total`` work."""
        return self._split_with(self.estimator.speeds(names), total, alive)

    def replan(self, names: Sequence[str], spec,
               alive: Optional[Sequence[bool]] = None):
        """Re-derive a StaticSpec's split from the current estimates (any
        reskew residual has already been folded into ``spec.works``).
        ``alive`` (run_job under a fault trace) restricts the split to the
        nodes alive at the barrier — survivors keep their AR(1) estimates,
        dead/draining nodes get zero work.  Returns the spec to solve;
        logs it either way."""
        k = len(self.history)
        if isinstance(spec, StaticSpec) and self.estimator.known():
            speeds = self.estimator.speeds(names)
            works = tuple(self._split_with(speeds, sum(spec.works), alive))
            self.history.append(
                AdaptiveStageLog(k, works, tuple(speeds), True))
            return StaticSpec(works=works, mitigation=spec.mitigation,
                              io_mb=spec.io_mb, datanode=spec.datanode)
        works = spec.works if isinstance(spec, StaticSpec) else None
        self.history.append(AdaptiveStageLog(k, works, None, False))
        return spec

    def observe(self, names: Sequence[str], summ: StageSummary) -> None:
        """Feed one finished stage's per-node (executed work, busy time)
        into the estimator (nodes that executed nothing are skipped — the
        paper only updates observed executors).  Quantum plans record
        speeds in quanta/sec so a shared GrainPlanner estimator sees one
        consistent unit across per-step and windowed scheduling."""
        scale = self.quantum if self.quantum is not None else 1.0
        for nm in names:
            w = summ.work.get(nm, 0.0)
            dt = summ.node_finish[nm] - summ.start
            if w > 0.0 and dt > 0.0:
                self.estimator.observe(nm, w / scale, dt)


def run_job(nodes: Sequence[SimNode], stages: Sequence,
            uplink_bw: Optional[float] = None,
            start_time: float = 0.0,
            adaptive: Optional[AdaptivePlan] = None,
            faults: Optional[FaultTrace] = None,
            resume: Optional[JobContinuation] = None) -> JobSchedule:
    """Run a whole multi-stage job: each stage starts at the previous
    stage's completion (program barrier).

    ``stages`` is a sequence of :class:`PullSpec` / :class:`StaticSpec`.
    On constant-speed clusters each *distinct* spec is solved once
    (record-free) and every repetition is an O(n) shift of the cached
    per-node finish vector, so S-stage HomT/HeMT sweeps cost O(S·n) after
    the one-time per-spec solves; solves are further shared across calls
    via the module-level LRU (:func:`run_job_cache_clear` resets it).
    Clusters with multi-segment speed profiles are not start-invariant and
    fall back to per-stage ``simulate_stage`` at the true barrier times.

    Stage specs carry their own ``mitigation`` policies: event-level ones
    run inside the stage's solve; a StaticSpec with barrier-level
    :class:`~repro_torch.core.speculation.ReskewHandoff` is cut at its barrier
    and the residual work is folded into the next stage's split (the last
    stage is never cut — there is no later split to fold into; a cut-off
    stage's residual skips empty stages until a foldable one appears).

    ``adaptive`` (an :class:`AdaptivePlan`) turns the barrier sequence
    into the paper's §5 OA-HeMT loop: each finished stage's per-node
    (executed work, busy time) feeds the plan's AR(1) estimator, and every
    upcoming ``StaticSpec`` is re-split from the updated estimates —
    residual fold first, re-plan second, so a re-skew hand-off's residual
    is re-skewed along with the split.  Solve caching stays exact without
    estimator state in the keys: a re-planned stage is a fresh
    ``StaticSpec`` *value*, and both cache levels key solves by spec value
    (the id() level never sees a re-planned spec twice), so adaptive
    stages can only share cache entries with identical splits — whose
    solves are identical.

    ``faults`` (a :class:`~repro_torch.core.faults.FaultTrace` on the job's
    absolute clock) breaks start-invariance, handled honestly: each stage
    is first solved fault-free (cacheable as ever), and when its
    ``[start, completion]`` window overlaps a fault window — faults only
    *remove* capacity, so the fault-free span lower-bounds the true one
    and a non-overlapping window is exactly valid — the stage is re-solved
    on the absolute-time event path, bypassing **both** cache levels; the
    LRU only ever stores fault-free solves (pinned by the no-poisoning
    test in tests/test_faults.py).  At a fault-affected barrier, work the
    stage abandoned (retries exhausted / stranded) folds into the next
    stage's split via its :class:`~repro_torch.core.speculation.ReskewHandoff`
    proportional to observed survivor throughput (without one the loss is
    eaten — HomT-style pull stages re-queue internally and rarely abandon
    anything); the straggler *cut* itself is skipped on fault-affected
    stages (its residual recompute assumes fault-free execution).  With
    ``adaptive``, each upcoming static stage is re-split over the nodes
    alive at its barrier — survivors keep their AR(1) estimates — and a
    crash marked ``cold_restart=True`` forgets the node's estimate at its
    recovery barrier so the replacement cold-starts at the survivor mean
    (paper §5.1).

    ``resume`` (a :class:`JobContinuation`) splices into a partially-run
    job: stages before ``resume.next_stage`` are skipped, the first
    resumed stage starts at ``resume.clock`` (overriding ``start_time``),
    and ``resume.carry`` — a ``(residual, throughputs)`` pair from an
    earlier re-skew barrier — folds into it before any adaptive re-plan,
    exactly as an in-run carry would.  Everything else (solve caching,
    adaptivity, faults on the absolute clock) behaves as if the earlier
    stages had run in this call; the returned schedule records the
    continuation so callers can align ``stages[k]`` with program stage
    ``resume.next_stage + k``.
    """
    speeds = _constant_speeds(nodes)
    names = [nd.name for nd in nodes]
    t = start_time
    summaries: List[StageSummary] = []
    # two-level cache: id() fast path for the common [spec] * S sharing one
    # object, module-level LRU keyed on (cluster signature, uplink, spec)
    # so distinct-but-equal specs share a solve across run_job calls.
    # Hashing a works tuple is O(T) (Python does not memoize tuple
    # hashes), so large-works specs are cached by id() only — a 10k-task
    # spec would otherwise pay more for hashing than solving.
    by_id: Dict[int, Tuple] = {}
    sig = _cluster_signature(nodes) if speeds is not None else None
    stage_list = list(stages)
    carry: Optional[Tuple[float, List[float]]] = None   # (residual, vhat)
    if resume is not None:
        if not 0 <= resume.next_stage <= len(stage_list):
            raise ValueError(
                f"resume.next_stage {resume.next_stage} outside the "
                f"{len(stage_list)}-stage program")
        stage_list = stage_list[resume.next_stage:]
        t = resume.clock
        if resume.carry is not None and resume.carry[0] > 0.0:
            carry = (resume.carry[0], list(resume.carry[1]))
    folded_alive: List = []   # keeps folded temporaries alive: by_id keys
    # are id()s, which CPython reuses once an object is collected
    if faults is not None and not faults.events:
        faults = None
    # cold-restart recoveries not yet past: forget the node's estimate at
    # the first barrier at/after its replacement comes up (§5.1)
    cold_pending = deque(faults.cold_restarts()) if faults is not None else ()
    for k, spec in enumerate(stage_list):
        if carry is not None and _spec_n_tasks(spec):
            spec = _fold_spec(spec, carry[0], carry[1])
            folded_alive.append(spec)
            carry = None
        if adaptive is not None:
            alive = None
            if faults is not None:
                while cold_pending and cold_pending[0][0] <= t + _EPS:
                    adaptive.estimator.forget(names[cold_pending.popleft()[1]])
                mask = faults.alive_mask(len(nodes), t)
                if not all(mask):
                    alive = mask
            spec = adaptive.replan(names, spec, alive)
            folded_alive.append(spec)
        faulted = False
        if speeds is None:
            summ = _abs_summary(nodes, spec, uplink_bw, t)
            if faults is not None and faults.overlaps(t, summ.completion):
                faulted = True
                summ = _abs_summary(nodes, spec, uplink_bw, t, faults)
        else:
            rel = by_id.get(id(spec))
            if rel is None:
                cheap_hash = not isinstance(spec, PullSpec) \
                    or spec.works is None or len(spec.works) <= 1024
                key = (sig, uplink_bw, spec) if cheap_hash else None
                rel = _SOLVE_CACHE.get(key) if cheap_hash else None
                if rel is not None:
                    _SOLVE_CACHE.move_to_end(key)
                else:
                    span, idle, offs, counts, wexec = _rel_summary(
                        nodes, speeds, spec, uplink_bw)
                    rel = (span, idle, tuple(offs), tuple(counts),
                           tuple(wexec))
                    if cheap_hash:
                        _SOLVE_CACHE[key] = rel
                        if len(_SOLVE_CACHE) > _SOLVE_CACHE_MAX:
                            _SOLVE_CACHE.popitem(last=False)
                by_id[id(spec)] = rel
            span, idle, offs, counts, wexec = rel
            summ = StageSummary(
                t, t + span, idle,
                {nm: t + o for nm, o in zip(names, offs)},
                {nm: c for nm, c in zip(names, counts)},
                {nm: w for nm, w in zip(names, wexec)})
            if faults is not None and faults.overlaps(t, summ.completion):
                # the fault-free solve above stays cached (it is a valid
                # fault-free solve); the fault-affected one replacing it
                # is never stored in either cache level
                faulted = True
                summ = _abs_summary(nodes, spec, uplink_bw, t, faults)
        if (isinstance(spec, StaticSpec)
                and isinstance(spec.mitigation, ReskewHandoff)
                and k + 1 < len(stage_list)):
            if faulted:
                # no straggler cut on a fault-affected stage (the cut's
                # residual recompute assumes fault-free execution); its
                # abandoned work still folds forward through the handoff,
                # proportional to observed survivor throughput
                lost = lost_work(_spec_total_work(spec),
                                 sum(summ.work.values()))
                if lost > 0.0:
                    offs = [summ.node_finish[nm] - summ.start for nm in names]
                    vhat = [summ.work.get(nm, 0.0) / o if o > 0.0 else 0.0
                            for nm, o in zip(names, offs)]
                    carry = (lost, vhat)
            else:
                summ, residual, vhat = _apply_reskew(nodes, spec, summ, names)
                if residual > 0.0:
                    carry = (residual, vhat)
        if adaptive is not None:
            adaptive.observe(names, summ)
        summaries.append(summ)
        t = summ.completion
    return JobSchedule(t, summaries, continuation=resume)


def _spec_n_tasks(spec) -> int:
    if isinstance(spec, StaticSpec):
        return len(spec.works)
    return spec.n_tasks if spec.works is None else len(spec.works)


def _spec_total_work(spec) -> float:
    if isinstance(spec, StaticSpec):
        return float(sum(spec.works))
    return float(spec.work_array().sum())
