"""Fault injection & recovery for the whole-job engine.

Copy of the JAX package's ``repro/core/faults.py`` (pure Python), imports
pointed at ``repro_torch.core``.

The paper's setting is the *public cloud*: capacity is not just
heterogeneous, it is revocable.  Nodes crash mid-stage, spot instances are
preempted with a short warning, and the in-flight work of a dead node is
simply gone.  The engine's multi-segment profiles and burstable credits can
only express graceful *slowdowns*; this module adds the loss of a node and
its in-flight attempt, so the HomT-vs-HeMT-vs-OA-HeMT comparison gains the
overhead-vs-resilience axis (HomT's pull queue self-heals by construction —
Claim 1 — while a static split must retry or eat the loss).

Fault models are frozen (hashable) dataclasses composed into a per-run
:class:`FaultTrace`, consumed by ``engine.run_stage_events(faults=...)``
and threaded through whole jobs by ``engine.run_job(faults=...)``.  All
event times are **absolute** (the same clock as ``start_time``), so one
trace describes a whole multi-stage job.

Exact semantics (shared verbatim by the engine and the naive full-rescan
fault oracle in tests/test_faults.py):

* **Node state.** A :class:`NodeCrash` makes its node *dead* during
  ``[at, recover_at)`` (forever when ``recover_at`` is None).  A
  :class:`SpotPreemption` makes its node *draining* during
  ``[at, at + warning)`` and dead from ``at + warning`` on (spot capacity
  never comes back).  A draining node keeps executing its current attempt
  but **pulls no new work** — the warning is the drain window.  Per node,
  event intervals must be disjoint and a preemption must be the node's
  last event.

* **Priming.** A node dead or draining at the stage start is not primed.
  A node dead at the start with **no future recovery** hands its private
  queue (HeMT macrotasks) to survivors immediately — see *re-queueing*;
  with a future recovery its queue waits and is executed on recovery.
  Exception: zero-work zero-byte tasks (an adaptive alive-masked replan
  parks them on dead nodes) never wait out a recovery — they redistribute
  immediately so the stage does not serialize on a no-op.

* **Kill instant** (``at`` of a crash; ``at + warning`` of a preemption):
  the victim's in-flight attempt is killed.  Work it executed is lost,
  unless the run checkpoints at grain boundaries
  (``FaultTrace.checkpoint_grain`` g > 0): then
  ``floor(executed / g) * g`` survives as a partial
  :class:`~repro_torch.core.simulator.TaskRecord` ending at the kill instant
  (this is also how a preemption "drains at a grain boundary" — the drain
  window lets more grains complete before the kill).  The attempt's
  in-flight uplink flow is freed through the engine's causal ``drop_flow``
  repricing — survivors speed up at that instant, never retroactively.
  Killed attempts never feed the mitigation policies' completed-duration
  statistics.  A completion tied exactly with its node's kill instant is
  killed (fault sub-events order before same-time completions of the same
  node; across nodes the lower index goes first, as everywhere in the
  engine).

* **Speculation composition.** If the killed attempt has a racing
  speculative copy, the copy survives its victim's death and becomes the
  task's only (primary) attempt: nothing is re-queued and no retry is
  charged.

* **Re-queueing & retries** (:class:`RetryPolicy`): the killed attempt's
  residual work ``attempt_work - saved`` re-enters the stage as a fresh
  task with a proportional share of the attempt's input bytes (a restart
  re-fetches input for work it still has to do; checkpointed work's bytes
  are not re-fetched).  Destination:

  - *pull*: the back of the shared deque (the queue self-heals);
  - *static, victim recovers later*: the front of the victim's own queue,
    re-executed on recovery;
  - *static, victim dead for good*: redistributed to the candidate with
    the least load (remaining work of its current attempt plus queued
    work; ties to the lowest index) among alive non-draining nodes — or,
    when none is alive, the dead node with the earliest future recovery.
    With no candidate at all the work is stranded (abandoned).

  Each re-queue of a task id counts against ``retry.max_attempts`` (the
  initial launch is attempt 1; once ``max_attempts`` launches have been
  consumed, further kills abandon the task's residual work).  The k-th
  re-launch pays ``relaunch_overhead * backoff**(k-1)`` extra seconds at
  its next launch, wherever it lands (at most one pending re-launch
  penalty per task id).

* **Recovery instant**: the node is alive again and immediately pulls
  from its queue (its own private queue for static stages, the shared
  deque for pull); with mitigation it re-enters the offer fixpoint.
  Mitigation never offers a dead or draining node work.

* **Whole jobs** (``run_job(faults=...)``): faults break start-invariance,
  so a stage whose ``[start, completion]`` window overlaps any fault
  window (dead interval of a crash, ``[at, inf)`` of a preemption) is
  solved on the absolute-time event path and **bypasses both solve
  caches** — the start-invariant LRU only ever holds fault-free solves
  (pinned by the no-poisoning test).  At barriers, abandoned (lost) work
  of a fault-affected :class:`~repro_torch.core.engine.StaticSpec` carrying
  :class:`~repro_torch.core.speculation.ReskewHandoff` folds forward into the
  next stage's split proportional to observed survivor throughput, and an
  :class:`~repro_torch.core.engine.AdaptivePlan` re-splits upcoming stages over
  the nodes alive at the barrier (spot warnings are visible to the
  scheduler — that is what the warning is for), survivors keeping their
  AR(1) estimates; a crash marked ``cold_restart=True`` forgets the
  node's estimate at its recovery barrier so the replacement cold-starts
  at the survivor mean (paper §5.1's ``L_k^o`` rule).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

ALIVE, DRAINING, DEAD = 0, 1, 2

# ordering of same-instant fault sub-events on one node: a recovery ending
# one interval precedes the kill starting the next; a drain warning (which
# only exists with warning > 0) can never tie with its own kill.  Public:
# the resident calendar (repro.core.resident) extends this ranking with
# resize (3) and arrival (4) events for its all-externals-first ordering.
SUB_EVENT_RANK = {"recover": 0, "drain": 1, "kill": 2}
_RANK = SUB_EVENT_RANK   # backwards-compatible alias


@dataclass(frozen=True)
class NodeCrash:
    """Node ``node`` dies abruptly at absolute time ``at``; optionally a
    replacement comes up at ``recover_at``.  ``cold_restart`` marks the
    recovered instance as a *new* machine: an adaptive ``run_job`` forgets
    its AR(1) estimate at the recovery barrier (paper §5.1 cold start)."""
    node: int
    at: float
    recover_at: Optional[float] = None
    cold_restart: bool = False

    def __post_init__(self):
        if self.node < 0:
            raise ValueError("node index must be >= 0")
        if self.recover_at is not None and self.recover_at <= self.at:
            raise ValueError("recover_at must be after the crash instant")

    @property
    def dead_until(self) -> float:
        return math.inf if self.recover_at is None else self.recover_at


@dataclass(frozen=True)
class SpotPreemption:
    """Node ``node`` receives a preemption warning at ``at`` and is
    reclaimed at ``at + warning``; during the warning window it drains —
    keeps executing its current attempt, pulls nothing new."""
    node: int
    at: float
    warning: float = 0.0

    def __post_init__(self):
        if self.node < 0:
            raise ValueError("node index must be >= 0")
        if self.warning < 0.0:
            raise ValueError("warning lead time must be >= 0")

    @property
    def kill_at(self) -> float:
        return self.at + self.warning


FaultEvent = Union[NodeCrash, SpotPreemption]


@dataclass(frozen=True)
class RetryPolicy:
    """Re-queue semantics for killed attempts: a task id may be launched
    ``max_attempts`` times in total; the k-th re-launch adds
    ``relaunch_overhead * backoff**(k-1)`` seconds before its node's own
    task overhead (container re-provisioning, state re-load)."""
    max_attempts: int = 3
    relaunch_overhead: float = 0.0
    backoff: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.relaunch_overhead < 0.0:
            raise ValueError("relaunch_overhead must be >= 0")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1.0")

    def penalty(self, relaunch_index: int) -> float:
        """Extra launch latency of the k-th re-launch (k >= 1)."""
        return self.relaunch_overhead * self.backoff ** (relaunch_index - 1)


@dataclass(frozen=True)
class FaultTrace:
    """A run's faults: events + retry policy + checkpoint granularity.

    ``checkpoint_grain`` g > 0 preserves ``floor(executed / g) * g`` of a
    killed attempt's work as a partial record (g == 0: everything in
    flight is lost).  Frozen and hashable so traces can ride frozen specs
    and be compared/deduped; events are kept sorted by ``(at, node)``.
    """
    events: Tuple[FaultEvent, ...] = ()
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    checkpoint_grain: float = 0.0

    def __post_init__(self):
        if self.checkpoint_grain < 0.0:
            raise ValueError("checkpoint_grain must be >= 0")
        events = tuple(sorted(self.events, key=lambda e: (e.at, e.node)))
        object.__setattr__(self, "events", events)
        per_node = {}
        for ev in events:
            per_node.setdefault(ev.node, []).append(ev)
        for node, evs in per_node.items():
            open_until = -math.inf
            for ev in evs:
                if ev.at < open_until:
                    raise ValueError(
                        f"overlapping fault events on node {node}")
                open_until = (math.inf if isinstance(ev, SpotPreemption)
                              else ev.dead_until)

    # -- state queries ------------------------------------------------------
    def state_at(self, node: int, t: float) -> int:
        """ALIVE / DRAINING / DEAD status of ``node`` at absolute ``t``."""
        for ev in self.events:
            if ev.node != node:
                continue
            if isinstance(ev, SpotPreemption):
                if ev.at <= t < ev.kill_at:
                    return DRAINING
                if t >= ev.kill_at:
                    return DEAD
            elif ev.at <= t < ev.dead_until:
                return DEAD
        return ALIVE

    def alive_mask(self, n: int, t: float) -> List[bool]:
        """Which of ``n`` nodes are alive (not dead, not draining) at t."""
        return [self.state_at(i, t) == ALIVE for i in range(n)]

    def recovery_after(self, node: int, t: float) -> Optional[float]:
        """The recovery instant of the dead interval containing ``t``
        (None when the node is not dead at t, or dead for good)."""
        for ev in self.events:
            if (isinstance(ev, NodeCrash) and ev.node == node
                    and ev.recover_at is not None
                    and ev.at <= t < ev.recover_at):
                return ev.recover_at
        return None

    # -- run_job plumbing ---------------------------------------------------
    def windows(self) -> Tuple[Tuple[float, float], ...]:
        """Per-event affected interval ``[start, end)``: the dead window of
        a crash, ``[at, inf)`` for a preemption (drain included)."""
        return tuple(
            (ev.at, math.inf) if isinstance(ev, SpotPreemption)
            else (ev.at, ev.dead_until)
            for ev in self.events)

    def overlaps(self, t0: float, t1: float, eps: float = 1e-9) -> bool:
        """True if any fault window intersects the stage window
        ``[t0, t1]`` (inclusive at t1: a completion tied with a kill is
        killed, so a window starting exactly at the stage end affects
        it)."""
        return any(s < t1 + eps and e > t0 + eps for s, e in self.windows())

    def sub_events(self, start_time: float,
                   ) -> List[Tuple[float, int, str]]:
        """Kill / drain / recover sub-events strictly after ``start_time``
        as ``(t, node, kind)``, in processing order ``(t, node, rank)``;
        state already in force at ``start_time`` is queried via
        :meth:`state_at` instead."""
        out: List[Tuple[float, int, str]] = []
        for ev in self.events:
            if isinstance(ev, SpotPreemption):
                if ev.warning > 0.0 and ev.at > start_time:
                    out.append((ev.at, ev.node, "drain"))
                if ev.kill_at > start_time:
                    out.append((ev.kill_at, ev.node, "kill"))
            else:
                if ev.at > start_time:
                    out.append((ev.at, ev.node, "kill"))
                if ev.recover_at is not None and ev.recover_at > start_time:
                    out.append((ev.recover_at, ev.node, "recover"))
        out.sort(key=lambda e: (e[0], e[1], _RANK[e[2]]))
        return out

    def cold_restarts(self) -> List[Tuple[float, int]]:
        """``(recover_at, node)`` of crashes whose replacement is a fresh
        machine — the adaptive loop forgets their estimates at the
        recovery barrier."""
        return sorted((ev.recover_at, ev.node) for ev in self.events
                      if isinstance(ev, NodeCrash) and ev.cold_restart
                      and ev.recover_at is not None)

    def max_node(self) -> int:
        return max((ev.node for ev in self.events), default=-1)

    def restrict(self, keep: Sequence[int]) -> "FaultTrace":
        """The trace over a surviving subset of nodes: events of dropped
        nodes are removed and survivors renumbered to their position in
        ``keep`` — elastic drivers that shrink the fleet mid-run remap the
        trace alongside the slice list."""
        pos = {orig: new for new, orig in enumerate(keep)}
        kept = tuple(
            SpotPreemption(pos[ev.node], ev.at, ev.warning)
            if isinstance(ev, SpotPreemption)
            else NodeCrash(pos[ev.node], ev.at, ev.recover_at,
                           ev.cold_restart)
            for ev in self.events if ev.node in pos)
        return FaultTrace(kept, self.retry, self.checkpoint_grain)

    def shift(self, dt: float) -> "FaultTrace":
        """The same trace on a clock offset by ``dt`` (drivers whose node
        profiles are re-anchored to a moving fleet clock shift the trace
        alongside)."""
        moved = tuple(
            SpotPreemption(ev.node, ev.at + dt, ev.warning)
            if isinstance(ev, SpotPreemption)
            else NodeCrash(ev.node, ev.at + dt,
                           None if ev.recover_at is None
                           else ev.recover_at + dt, ev.cold_restart)
            for ev in self.events)
        return FaultTrace(moved, self.retry, self.checkpoint_grain)


def lost_work(planned_total: float, executed_total: float,
              eps: float = 1e-9) -> float:
    """Work a fault-affected stage abandoned (retries exhausted / stranded):
    planned minus recorded, clamped at zero (a winning speculative copy
    records its full work even when its victim also checkpointed a partial
    piece, which can push recorded above planned)."""
    lost = planned_total - executed_total
    return lost if lost > eps else 0.0
