"""HeMT grain planner — the paper's scheduler as a first-class feature of
the training runtime (HeMT-DP, DESIGN.md §2).

A global training step processes G grains (fixed-shape microbatches).
Slices (SPMD islands / pods) are the paper's "executors"; the planner
assigns per-slice grain counts k_i ~ v_i (AR(1)-estimated slice throughput,
grains/sec), so all slices reach the cross-slice gradient barrier together.

HomT mode (the baseline the paper compares against) assigns grains evenly
and lets fast slices steal pending grains from a shared queue — Claim 1
bounds the barrier idle time by one grain-time on the slowest slice, at the
cost of per-steal overhead (host RPC + input re-route).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from repro_torch.core.estimators import ARSpeedEstimator
from repro_torch.core.partitioner import even_split, proportional_split


@dataclass
class SlicePlan:
    slice_names: List[str]
    grains: List[int]              # per-slice grain counts, sum = G
    weights: List[float]           # normalized speed estimates used
    mode: str                      # "hemt" | "homt"

    def grains_for(self, name: str) -> int:
        return self.grains[self.slice_names.index(name)]


class GrainPlanner:
    """Per-job-class planner with online speed adaptation.

    alpha: AR(1) forgetting factor (paper §5.1). The default 0.3 keeps some
    memory to average out per-grain difficulty variation while staying
    responsive to interference changes (paper's Fig 7 uses 0.0; configurable).
    """

    def __init__(self, slices: Sequence[str], alpha: float = 0.3,
                 min_grains: int = 1, mode: str = "hemt"):
        if mode not in ("hemt", "homt"):
            raise ValueError(mode)
        self.slices = list(slices)
        self.estimator = ARSpeedEstimator(alpha=alpha)
        self.min_grains = min_grains
        self.mode = mode
        self.step_log: List[SlicePlan] = []

    # ------------------------------------------------------------------
    def plan(self, total_grains: int) -> SlicePlan:
        n = len(self.slices)
        if self.mode == "homt" or not self.estimator.known():
            grains = even_split(total_grains, n)
            weights = [1.0 / n] * n
        else:
            speeds = self.estimator.speeds(self.slices)
            s = sum(speeds)
            weights = [v / s for v in speeds]
            grains = proportional_split(total_grains, speeds,
                                        min_share=self.min_grains)
        plan = SlicePlan(list(self.slices), grains, weights, self.mode)
        self.step_log.append(plan)
        return plan

    def observe(self, slice_name: str, grains_done: int, elapsed_s: float,
                ) -> None:
        if grains_done > 0 and elapsed_s > 0:
            self.estimator.observe(slice_name, grains_done, elapsed_s)

    def observe_step(self, results: Dict[str, Dict[str, float]]) -> None:
        """results: slice -> {"grains": int, "elapsed": seconds}."""
        for name, r in results.items():
            self.observe(name, r["grains"], r["elapsed"])

    # ------------------------------------------------------------------
    # elasticity (paper §5.1 cold-start rule + straggler re-skew)
    def resize(self, new_slices: Sequence[str]) -> None:
        """Slice set changed (preemption / scale-up). Estimates of surviving
        slices are kept; new slices get the cold-start mean automatically."""
        gone = set(self.slices) - set(new_slices)
        for g in gone:
            self.estimator.forget(g)
        self.slices = list(new_slices)

    def predicted_barrier_idle(self, plan: SlicePlan) -> float:
        """Predicted sync delay of a plan given current speed estimates
        (seconds, relative): max_i k_i/v_i - min_i k_i/v_i."""
        speeds = self.estimator.speeds(plan.slice_names)
        times = [k / v for k, v in zip(plan.grains, speeds)]
        return max(times) - min(times)


@dataclass
class WorkStealingQueue:
    """HomT grain queue with steal accounting (per-steal overhead modeled
    by the runtime; Claim 1 applies to the resulting schedule)."""
    pending: List[int] = field(default_factory=list)
    steals: int = 0

    def seed(self, total_grains: int) -> None:
        self.pending = list(range(total_grains))

    def pull(self, k: int = 1) -> List[int]:
        got = self.pending[:k]
        del self.pending[:k]
        if got:
            self.steals += 1
        return got

    def __len__(self) -> int:
        return len(self.pending)
