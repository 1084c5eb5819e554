"""The benchmark's arithmetic over round and batch records and device
intervals: tails, rates, the fleet clock's makespans and idle shares, and
the union of the card's busy intervals."""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks
    (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def fleet_round(times: Dict[str, float], speeds: Dict[str, float]) -> Dict[str, float]:
    """One round on the fleet clock: each replica's batch time over its
    speed, the round's makespan (the slowest replica) and its idle time
    (each replica's wait for the makespan, summed)."""
    fleet = {r: t / speeds[r] for r, t in times.items()}
    makespan = max(fleet.values())
    return {"makespan_s": makespan, "idle_s": sum(makespan - t for t in fleet.values()),
            "capacity_s": makespan * len(fleet)}


def idle_share(rounds: Iterable[Dict[str, float]]) -> float:
    """Sum over rounds of the replicas' idle time over the sum of replicas
    times makespan."""
    rounds = list(rounds)
    return sum(r["idle_s"] for r in rounds) / sum(r["capacity_s"] for r in rounds)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    return [(max(s, start), min(e, end)) for s, e in intervals if e > start and s < end]


def gaps(busy: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that merged ``busy`` leaves uncovered."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out
