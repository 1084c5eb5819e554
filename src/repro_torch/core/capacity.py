"""Token-bucket (burstable instance) capacity model — paper §6.2.

Copy of the JAX package's ``repro/core/capacity.py`` (pure Python), imports
pointed at ``repro_torch.core``.

A burstable node has CPU credits c (minutes of full-speed compute), earns
credits at its baseline rate rho while idle, runs at full speed 1.0 while
credits remain, then drops to rho. The per-node *workload-vs-time* curve

    W(t) = min(t, t_burst) + rho * max(0, t - t_burst),  t_burst = c / (1 - rho)

is piecewise linear (paper Figs 10-11). To split a job of size W0 over
nodes so they finish simultaneously, superpose What(t) = sum_i W_i(t),
solve What(t') = W0, and give node i the share W_i(t') (paper Fig 12).

Paper's worked example: t2.small, 4 initial credits, rho=0.2:
t_burst = 4/0.8 = 5 min; W(10) = 5 + 0.2*5 = 6. Three nodes with credits
{4, 8, 12} and rho=0.2 splitting W0=20: t' = 80/11, shares {60/11, 80/11,
80/11} = 3:4:4.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class BurstableNode:
    """One token-bucket governed node.

    credits:   initial CPU credits, in minutes of full-speed work
    baseline:  rho in (0, 1]; fraction of a core when credits are exhausted
    peak:      full-speed rate (1.0 = one core at 100%)
    """
    credits: float
    baseline: float
    peak: float = 1.0

    def __post_init__(self):
        if self.credits < 0:
            raise ValueError("credits must be >= 0")
        if not 0 < self.baseline <= self.peak:
            raise ValueError("need 0 < baseline <= peak")

    @property
    def burst_time(self) -> float:
        """Time until credits deplete under full load: c / (1 - rho/peak)."""
        drain = self.peak - self.baseline  # net credit burn per unit time
        if drain <= 0:
            return math.inf
        return self.credits * self.peak / drain

    def work_by(self, t: float) -> float:
        """W(t): work completed by time t under continuous full load."""
        if t <= 0:
            return 0.0
        tb = self.burst_time
        if t <= tb:
            return self.peak * t
        return self.peak * tb + self.baseline * (t - tb)

    def time_for(self, w: float) -> float:
        """Inverse of work_by: time to finish w units."""
        if w <= 0:
            return 0.0
        tb = self.burst_time
        burst_work = self.peak * tb if math.isfinite(tb) else math.inf
        if w <= burst_work:
            return w / self.peak
        return tb + (w - burst_work) / self.baseline


def superposed_work(nodes: Sequence[BurstableNode], t: float) -> float:
    """What(t) = sum_i W_i(t)."""
    return sum(n.work_by(t) for n in nodes)


def solve_finish_time(nodes: Sequence[BurstableNode], total_work: float,
                      tol: float = 1e-12) -> float:
    """Solve What(t') = W0 exactly over the piecewise-linear segments."""
    if total_work <= 0:
        return 0.0
    if not nodes:
        raise ValueError("no nodes")
    # breakpoints: each node's burst_time
    bps = sorted({n.burst_time for n in nodes if math.isfinite(n.burst_time)})
    t_prev, w_prev = 0.0, 0.0
    for bp in bps:
        w_at = superposed_work(nodes, bp)
        if w_at >= total_work - tol:
            # target inside segment [t_prev, bp]: linear interpolation is
            # exact because every W_i is linear inside the segment
            rate = (w_at - w_prev) / (bp - t_prev)
            return t_prev + (total_work - w_prev) / rate
        t_prev, w_prev = bp, w_at
    # beyond all breakpoints: all nodes at baseline
    rate = sum(n.baseline for n in nodes)
    if rate <= 0:
        raise ValueError("zero aggregate baseline rate")
    return t_prev + (total_work - w_prev) / rate


def burstable_split(nodes: Sequence[BurstableNode], total_work: float,
                    ) -> Tuple[List[float], float]:
    """Paper §6.2 partitioning: shares W_i(t') so all nodes finish at t'.

    Returns (shares summing to total_work, t').
    """
    t_star = solve_finish_time(nodes, total_work)
    raw = [n.work_by(t_star) for n in nodes]
    s = sum(raw)
    if s <= 0:
        raise ValueError("degenerate capacity")
    shares = [r * total_work / s for r in raw]
    return shares, t_star


@dataclass
class TokenBucket:
    """Dynamic credit state for the cluster simulator (millisecond-level
    accrual/spend like EC2 T2, paper §6.2)."""
    credits: float            # current credits (minutes of full-speed work)
    baseline: float           # earn rate = baseline (credits/min at idle)
    peak: float = 1.0
    cap: float = math.inf     # max accumulated credits

    def run(self, dt: float, load: float = 1.0) -> float:
        """Advance dt minutes at `load` (0..1 requested utilization).
        Returns work done. Credits earn at baseline*(1) and burn at
        rate*(spent above baseline)."""
        if dt <= 0:
            return 0.0
        load = min(max(load, 0.0), 1.0)
        # rate achievable now
        rate = self.peak if self.credits > 0 else self.baseline
        rate = min(rate, self.peak * load) if load > 0 else 0.0
        burn = max(0.0, rate - self.baseline)  # net credit change per minute
        if burn > 0 and self.credits > 0:
            t_deplete = self.credits / burn
            if dt <= t_deplete:
                self.credits -= burn * dt
                return rate * dt
            # split: burst until depletion, then baseline
            work = rate * t_deplete
            self.credits = 0.0
            rem = dt - t_deplete
            return work + min(self.baseline, self.peak * load) * rem
        # earning or steady
        self.credits = min(self.cap, self.credits + (self.baseline - rate) * dt)
        return rate * dt
