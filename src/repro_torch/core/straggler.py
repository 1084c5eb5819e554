"""Straggler analytics & mitigation.

Copy of the JAX package's ``repro/core/straggler.py`` (pure Python), imports
pointed at ``repro_torch``.

Claim 1 (paper §3): with pull-based assignment, even partitioning and
constant node speeds, idle time <= max_i T_i (single-task duration on the
slowest node). `claim1_bound` computes the bound; the simulator validates
it (tests + bench_claim1).

Runtime mitigation used by the training framework (runtime/ft.py):
  * z-score detection on per-grain rates (the paper's "execution time
    variation at program barriers" signal),
  * speculative re-execution for pull-mode stages,
  * HeMT re-skew (capacity loss absorbed by the next plan, no restart).

Simulated, engine-backed mitigation lives in ``repro_torch.core.speculation``:
SpeculativeCopies / WorkStealing run on the event calendar
(``run_stage_events(mitigation=...)``) and ReskewHandoff folds straggler
residuals across ``run_job`` barriers.  The advisory helpers below
(``speculative_copies``) share the SpeculativeCopies trigger rule, so the
runtime monitor and the simulator speculate under one definition.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import SimNode, SimTask, run_pull_stage
from repro_torch.core.speculation import SpeculativeCopies


def claim1_bound(total_work: float, n_tasks: int,
                 speeds: Sequence[float]) -> float:
    """Upper bound on resource idling time: single task duration on the
    slowest node = (D/m) / min_i v_i."""
    per_task = total_work / n_tasks
    return per_task / min(speeds)


def verify_claim1(total_work: float, n_tasks: int, speeds: Sequence[float],
                  overhead: float = 0.0) -> Tuple[float, float, bool]:
    """Simulate pull-based HomT; return (idle_time, bound, holds)."""
    nodes = [SimNode.constant(f"n{i}", v, overhead)
             for i, v in enumerate(speeds)]
    per = total_work / n_tasks
    tasks = [SimTask(per, task_id=i) for i in range(n_tasks)]
    res = run_pull_stage(nodes, tasks)
    # the bound is on pure compute idling; per-task overhead adds to both
    bound = claim1_bound(total_work, n_tasks, speeds) + overhead
    return res.idle_time, bound, res.idle_time <= bound + 1e-9


@dataclass
class StragglerReport:
    """One flagged executor.  ``index`` is positional within the rate list
    handed to :func:`detect_stragglers` — under an elastic fleet that list
    shrinks as nodes die, so consumers that outlive one call
    (``FleetMonitor``) attach the stable slice ``name``."""
    index: int
    rate: float
    zscore: float
    name: str = ""


def detect_stragglers(rates: Sequence[float], z_threshold: float = -1.5,
                      ) -> List[StragglerReport]:
    """Flag executors whose work rate z-score is below threshold."""
    if len(rates) < 3:
        return []
    mu = statistics.fmean(rates)
    sd = statistics.pstdev(rates)
    if sd == 0:
        return []
    out = []
    for i, r in enumerate(rates):
        z = (r - mu) / sd
        if z < z_threshold:
            out.append(StragglerReport(i, r, z))
    return out


def speculative_copies(records_end: Dict[int, Optional[float]], now: float,
                       running_starts: Dict[int, float],
                       timeout_factor: float = 2.0) -> List[int]:
    """Opportunistic speculation (paper §8 survey, [45,6,5]): re-launch tasks
    still running at/over timeout_factor x median completed duration.

    Advisory twin of the engine-backed
    :class:`repro_torch.core.speculation.SpeculativeCopies` policy (median =
    quantile 0.5), routed through the shared ``should_speculate`` rule so
    a task running *exactly* ``timeout_factor * median`` gets the same
    at-threshold (``>=``) verdict here, in
    ``FleetMonitor.speculation_candidates``, and inside the engine's
    ``run_stage_events(mitigation=...)`` cancel/re-launch events.
    """
    done = [e for e in records_end.values() if e is not None]
    if not done:
        return []
    policy = SpeculativeCopies(quantile=0.5, factor=timeout_factor,
                               min_completed=1)
    return [tid for tid, st in running_starts.items()
            if policy.should_speculate(done, now - st)]


def rebalance_after_loss(weights: Sequence[float], lost: Sequence[int],
                         cold_start: str = "mean") -> Dict[int, float]:
    """HeMT elastic response to node loss: drop lost executors, renormalize.

    Returns ``{surviving original index: renormalized weight}`` so callers
    can map each weight back to the executor it belongs to — a bare
    renormalized list loses that mapping the moment indices shift.
    (Speeds of later replacement nodes get the cold-start rule — see
    estimators.ARSpeedEstimator.speeds.)"""
    lost_set = set(lost)
    kept = [(i, w) for i, w in enumerate(weights) if i not in lost_set]
    if not kept:
        raise ValueError("all executors lost")
    s = sum(w for _, w in kept)
    return {i: w / s for i, w in kept}
