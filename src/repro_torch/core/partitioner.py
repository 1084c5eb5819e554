"""Workload partitioners: HomT (equal) and HeMT (capacity-proportional).

The paper's partitioning rule (§5.1): executor i gets d_i = D * v_i / V.
Real systems need integer partitions of records/rows/grains, often with an
alignment quantum (TPU: grains must be whole microbatches; HDFS: whole
blocks). `proportional_split` uses largest-remainder rounding so that
sum(d_i) == D exactly and the split is within one quantum of ideal.
"""
from __future__ import annotations

import math
from typing import List, Sequence

from repro_torch.core.estimators import normalized


def even_split(total: int, n: int, quantum: int = 1) -> List[int]:
    """HomT / Spark-default: equal split of `total` into n integer parts,
    multiples of `quantum` (residual spread over the first parts)."""
    if n <= 0:
        raise ValueError("n must be positive")
    if total % quantum != 0:
        raise ValueError(f"total {total} not a multiple of quantum {quantum}")
    units = total // quantum
    base, rem = divmod(units, n)
    return [(base + (1 if i < rem else 0)) * quantum for i in range(n)]


def proportional_split(total: int, weights: Sequence[float],
                       quantum: int = 1,
                       min_share: int = 0) -> List[int]:
    """HeMT: split `total` (a multiple of `quantum`) proportional to weights.

    Largest-remainder rounding on quantum units; optional per-part floor
    (min_share, in units of `quantum`) so no executor starves (needed to
    keep collecting speed observations on slow nodes — paper §5.1's
    averaging argument assumes every executor keeps receiving work).
    """
    w = normalized(weights)
    n = len(w)
    if total % quantum != 0:
        raise ValueError(f"total {total} not a multiple of quantum {quantum}")
    units = total // quantum
    if min_share * n > units:
        raise ValueError("min_share infeasible")
    # largest-remainder rounding on the FULL unit count (rounding after a
    # floor pre-allocation distorts the split away from d_i = D v_i / V),
    # then repair min_share violations by stealing from the largest parts.
    ideal = [wi * units for wi in w]
    base = [math.floor(x) for x in ideal]
    rem = units - sum(base)
    frac = sorted(range(n), key=lambda i: ideal[i] - base[i], reverse=True)
    for i in frac[:rem]:
        base[i] += 1
    for i in range(n):
        while base[i] < min_share:
            j = max(range(n), key=lambda k: base[k])
            if base[j] <= min_share:
                raise ValueError("min_share infeasible")
            base[j] -= 1
            base[i] += 1
    return [b * quantum for b in base]


def microtask_split(total: int, n_tasks: int, quantum: int = 1) -> List[int]:
    """HomT with explicit task count (tasks >> executors)."""
    return even_split(total, n_tasks, quantum)


def split_error(split: Sequence[int], weights: Sequence[float]) -> float:
    """Max relative deviation of a split from the ideal proportional one."""
    total = sum(split)
    ideal = [w * total for w in normalized(weights)]
    return max(abs(s - i) for s, i in zip(split, ideal))


def makespan(split: Sequence[float], speeds: Sequence[float]) -> float:
    """Completion time of a one-task-per-executor assignment."""
    return max((d / v if d > 0 else 0.0) for d, v in zip(split, speeds))


def optimal_makespan(total: float, speeds: Sequence[float]) -> float:
    """Lower bound: all executors finish together = D / sum(v)."""
    return total / sum(speeds)


def hemt_split_floats(total: float, speeds: Sequence[float]) -> List[float]:
    """Continuous HeMT split d_i = D v_i / V (paper §5.1, pre-rounding)."""
    return [total * w for w in normalized(speeds)]
