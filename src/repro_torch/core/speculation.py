"""Speculation & work-stealing: straggler mitigation for the whole-job engine.

Copy of the JAX package's ``repro/core/speculation.py`` (pure Python), imports
pointed at ``repro_torch.core``.

The paper's HomT-vs-HeMT comparison hinges on straggler mitigation: pull
auto-balances (Claim 1) while HeMT with stale capacity estimates strands
work on slow nodes.  This module supplies pluggable mitigation policies
consumed by ``engine.run_stage_events(mitigation=...)`` (cancel/re-launch
inside a stage) and by ``engine.run_job`` (re-skew hand-off at program
barriers), so HomT / HeMT / HeMT+mitigation sweeps run through one engine
(benchmarks/bench_speculation.py reproduces the ordering: learned-capacity
HeMT plus cheap mitigation beats both pure baselines under stale
estimates).

Event semantics (shared verbatim by the engine and the differential-test
oracle in tests/test_speculation.py):

* Mitigation is **offered at event instants only**: after the initial task
  assignments, after every task completion (and the queue re-pull it
  triggers), and at scheduled idle re-checks.  At each such instant idle
  nodes are offered mitigation in **ascending node index**; after an
  accepted action the sweep restarts from node 0 (state changed); the
  fixpoint ends when no idle node takes an action.  A node is idle when it
  has no running attempt and its queue (shared queue when pull, private
  queue otherwise) is empty.
* **Speculative copies** (:class:`SpeculativeCopies`, Spark-style): when at
  least ``min_completed`` attempts have completed and a running attempt's
  elapsed time (``now - start``, overhead included) reaches ``factor *
  quantile(completed durations, quantile)``, an idle node launches a
  duplicate of that attempt's task — the **full original work, from
  scratch**, paying the idle node's own ``task_overhead``.  Among eligible
  victims the longest-elapsed wins (ties: lowest victim node index).  A
  task is copied **at most once per stage** (``has_copy`` marks original
  and copy).  First finisher wins: the winning attempt produces the task's
  only record; the losing attempt is cancelled at that instant, produces
  no record, and the freed node immediately re-enters the queue-pull /
  mitigation flow.  A cancel-vs-finish tie (both attempts' completion
  events at the same time) resolves by the engine's event order
  ``(time, node index)``: the lower-indexed node's completion is processed
  first and wins.  When no attempt is past threshold yet, the idle node
  schedules a re-check at the earliest instant one could cross it
  (``min over eligible attempts of start + threshold``).
* **Work stealing** (:class:`WorkStealing`): an idle node steals from the
  most-backlogged running attempt (largest remaining work, ties: lowest
  victim node index), provided the victim retains at least ``2 * grain``
  remaining.  The stolen amount is the unstarted **remainder split at a
  grain boundary**: ``floor(remaining / 2 / grain) * grain`` (so thief and
  victim each keep >= ``grain``).  The victim's attempt shrinks in place —
  its completion event is re-predicted from the steal instant; work it
  already executed stays executed.  The thief starts a new attempt of the
  stolen work (same ``task_id``, its own overhead), so a stolen task
  yields one :class:`~repro_torch.core.simulator.TaskRecord` **per executed
  piece**.  Remaining work only shrinks over time, so no re-check timer is
  needed: new opportunities appear only at event instants, where the
  fixpoint re-offers every idle node.
* **Re-skew hand-off** (:class:`ReskewHandoff`, barrier-level — accepted
  only by ``run_job`` on :class:`~repro_torch.core.engine.StaticSpec` stages):
  at the stage's program barrier, nodes still running past ``cutoff_factor
  * median(per-node finish offsets)`` are cut off at that instant; their
  residual (unexecuted) work is folded into the **next** stage's split,
  distributed proportionally to the observed per-node throughput of the
  cut stage (executed work / busy time).  A next-stage ``PullSpec`` simply
  scales (the shared queue absorbs residual wherever capacity is).  The
  final stage is never cut (there is no later split to fold into).  With
  homogeneous finishes the cutoff sits at/above the max finish and the
  policy is a no-op.

* **I/O-aware duplicates** (stages with effective I/O — finite shared
  uplink and at least one reading task): a duplicate launch must re-fetch
  its input, and it does so as a **new flow** through the engine's
  flow-shared uplink model, joining the same incremental per-datanode
  repricing primary readers use.  The semantics, shared by engine and
  oracle:

  - A **speculative copy** re-fetches the victim attempt's **full input
    bytes** from the datanode its
    :class:`~repro_torch.core.hdfs_model.DuplicatePlacement` chooses (default:
    the original datanode, fairly sharing its uplink with the primary
    flow; ``"replica"`` reads the ring-adjacent replica instead).  The
    copy completes when both its re-fetch and its CPU work are done.
  - A **stolen remainder** re-fetches the stolen range's bytes — the
    ``amount / attempt work`` fraction of the attempt's input — from the
    placement-chosen datanode, and the victim stops fetching that range:
    its remaining bytes shrink by the moved bytes, clamped at zero (bytes
    it already streamed past the retained range are not refunded — the
    engine charges duplicate reads, never negative ones).  A drained
    victim flow leaves its uplink at the steal instant.
  - **Cancelling the loser frees its flow**: at the winner's completion
    instant the losing attempt's in-flight flow (if any) leaves its
    datanode's reader set and the survivors are repriced **causally at
    that instant — never retroactively** (the soundness property the
    engine's incremental repricing maintains everywhere).
  - The speculation **trigger gains an I/O cost term**: an attempt with
    input bytes crosses threshold at ``elapsed >= factor *
    quantile(done) + io_cost_per_mb * attempt_io_mb`` — a copy is only
    launched when the straggler is late enough that paying the re-fetch
    can still win.  ``io_cost_per_mb`` (seconds per MB, default 0)
    estimates the re-fetch rate; idle re-checks use the same per-attempt
    threshold.  Completed durations already include I/O time (durations
    are wall-clock ``finish - start``).

Policies are frozen (hashable) dataclasses so they can ride the hashable
``PullSpec``/``StaticSpec`` stage specs through ``run_job``'s solve caches.
The runtime monitor (``repro.runtime.ft.FleetMonitor``), the legacy
helper ``repro.core.straggler.speculative_copies``, and the engine all
share :meth:`SpeculativeCopies.should_speculate` — one at-threshold
(``>=``) trigger rule, so a task running exactly ``factor * quantile``
gets the same verdict from every exposure.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Union

from repro_torch.core.hdfs_model import DuplicatePlacement


class RunningAttempt(NamedTuple):
    """Observable state of one in-flight attempt, as the mitigation drivers
    (engine event calendar / test oracle) expose it to policies."""
    node: int           # node index running the attempt
    task_id: int
    start: float        # when the attempt started (overhead included after)
    work: float         # total work of this attempt
    remaining: float    # work not yet executed at the offer instant
    has_copy: bool      # a speculative copy of this task exists/existed
    io_mb: float = 0.0  # the attempt's input bytes (0 when I/O is not
    #                     effective: infinite uplink or no datanode)


class Speculate(NamedTuple):
    """Launch a duplicate of the victim node's running task on the idle
    node (full original work, from scratch)."""
    victim: int


class Steal(NamedTuple):
    """Move ``amount`` of the victim node's remaining work to the idle
    node as a new attempt."""
    victim: int
    amount: float


Action = Union[Speculate, Steal]

# At-threshold float guard: idle re-checks are scheduled at the exact
# crossing instant ``start + threshold``, and at a nonzero absolute start
# the round-trip ``(start + thr) - start`` can round a hair BELOW ``thr`` —
# the trigger would miss, no further re-check would be scheduled, and a
# shifted solve would silently diverge from its relative-0 twin (breaking
# the start-invariance run_job's solve caches rely on).  The guard mirrors
# the engine event loop's ``t + eps >= cpu_done`` causal comparisons.
_EPS = 1e-9


def quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile (numpy's default rule; q=0.5 is the
    median).  Pure Python so engine, oracle, and runtime advisors share one
    deterministic definition."""
    if not values:
        raise ValueError("quantile of empty sequence")
    s = sorted(values)
    h = q * (len(s) - 1)
    lo = math.floor(h)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (h - lo) * (s[hi] - s[lo])


@dataclass(frozen=True)
class SpeculativeCopies:
    """Spark-style quantile-triggered duplicate launch (module docstring).

    quantile:       which quantile of completed durations sets the baseline
    factor:         speculation threshold = factor * that quantile
    min_completed:  completions required before any copy may launch
    io_cost_per_mb: re-fetch cost term (s/MB): an attempt with input bytes
                    only triggers once its elapsed time also covers the
                    estimated cost of re-fetching its input (module
                    docstring, I/O-aware duplicates)
    placement:      where a copy re-fetches from
                    (:class:`~repro_torch.core.hdfs_model.DuplicatePlacement`;
                    None = the original datanode)
    """
    quantile: float = 0.75
    factor: float = 1.5
    min_completed: int = 1
    io_cost_per_mb: float = 0.0
    placement: Optional[DuplicatePlacement] = None

    def __post_init__(self):
        if not 0.0 <= self.quantile <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        if self.factor <= 0.0:
            raise ValueError("factor must be positive")
        if self.min_completed < 1:
            raise ValueError("min_completed must be >= 1")
        if self.io_cost_per_mb < 0.0:
            raise ValueError("io_cost_per_mb must be >= 0")

    def threshold(self, done_durations: Sequence[float],
                  io_mb: float = 0.0) -> float:
        """Per-attempt trigger threshold: the quantile baseline plus the
        re-fetch cost term for the attempt's input bytes."""
        return (self.factor * quantile(done_durations, self.quantile)
                + self.io_cost_per_mb * io_mb)

    def should_speculate(self, done_durations: Sequence[float],
                         elapsed: float, io_mb: float = 0.0) -> bool:
        """The shared trigger rule (engine, FleetMonitor and the legacy
        ``straggler.speculative_copies`` helper all call this): enough
        completions and the attempt's elapsed time at/over its per-attempt
        threshold — ``>=`` with the module's 1e-9 float guard, so a task
        running exactly ``factor * quantile`` triggers in every
        exposure."""
        if len(done_durations) < self.min_completed:
            return False
        return elapsed + _EPS >= self.threshold(done_durations, io_mb)

    def offer(self, done_durations: Sequence[float],
              running: Sequence[RunningAttempt], now: float,
              ) -> Optional[Speculate]:
        """Pick the longest-elapsed past-threshold un-copied attempt (ties:
        lowest victim node index, via the ascending scan)."""
        if len(done_durations) < self.min_completed:
            return None
        best, best_elapsed = None, -math.inf
        for r in running:                      # ascending node index
            if r.has_copy:
                continue
            elapsed = now - r.start
            if (elapsed + _EPS >= self.threshold(done_durations, r.io_mb)
                    and elapsed > best_elapsed):
                best, best_elapsed = r, elapsed
        return None if best is None else Speculate(best.node)

    def next_check(self, done_durations: Sequence[float],
                   running: Sequence[RunningAttempt], now: float,
                   ) -> Optional[float]:
        """Earliest future instant an eligible attempt crosses its
        per-attempt threshold (None when nothing can: all copied, or too
        few completions — completions themselves are events that
        re-offer)."""
        if len(done_durations) < self.min_completed:
            return None
        t = min((r.start + self.threshold(done_durations, r.io_mb)
                 for r in running if not r.has_copy),
                default=None)
        return t if t is not None and t > now else None


@dataclass(frozen=True)
class WorkStealing:
    """Idle-node work stealing, split at a grain boundary (module
    docstring).  ``grain`` is the indivisible work quantum (e.g. one HDFS
    block / one microbatch in work units).  On stages with effective I/O
    the thief re-fetches the stolen range's bytes as a new flow from the
    ``placement``-chosen datanode (None = the victim's datanode)."""
    grain: float
    placement: Optional[DuplicatePlacement] = None

    def __post_init__(self):
        if self.grain <= 0.0:
            raise ValueError("grain must be positive")

    def offer(self, done_durations: Sequence[float],
              running: Sequence[RunningAttempt], now: float,
              ) -> Optional[Steal]:
        best, best_remaining = None, 0.0
        for r in running:                      # ascending node index
            if r.remaining >= 2.0 * self.grain and r.remaining > best_remaining:
                best, best_remaining = r, r.remaining
        if best is None:
            return None
        amount = math.floor(best.remaining / 2.0 / self.grain) * self.grain
        return Steal(best.node, amount)

    def next_check(self, done_durations: Sequence[float],
                   running: Sequence[RunningAttempt], now: float,
                   ) -> Optional[float]:
        return None       # remaining work only shrinks; events re-offer


@dataclass(frozen=True)
class ReskewHandoff:
    """Barrier-level HeMT re-skew hand-off (module docstring): cut
    stragglers at ``cutoff_factor * median`` of the stage's per-node finish
    offsets and fold the residual into the next stage's split."""
    cutoff_factor: float = 1.5

    def __post_init__(self):
        if self.cutoff_factor < 1.0:
            raise ValueError("cutoff_factor must be >= 1.0")

    def cutoff(self, finish_offsets: Sequence[float]) -> float:
        """Cut instant (stage-relative) given offsets of nodes that ran."""
        return self.cutoff_factor * quantile(finish_offsets, 0.5)


EventPolicy = (SpeculativeCopies, WorkStealing)


def is_event_policy(mitigation: object) -> bool:
    """True for policies the event calendar applies inside a stage (vs.
    barrier-level policies applied by ``run_job``)."""
    return isinstance(mitigation, EventPolicy)


def fold_residual(works: Sequence[float], residual: float,
                  throughputs: Sequence[float]) -> List[float]:
    """Fold ``residual`` work into a static split, proportional to observed
    throughputs (uniform when all throughputs are zero — nothing observed).
    Used by ``run_job``'s re-skew hand-off; restated independently by the
    differential tests."""
    if residual <= 0.0:
        return list(works)
    total = sum(throughputs)
    n = len(works)
    if total <= 0.0:
        return [w + residual / n for w in works]
    return [w + residual * v / total for w, v in zip(works, throughputs)]
