"""K-Means as a HeMT-schedulable multi-stage job (paper §7, Fig 17).

Port of ``repro/workloads/kmeans.py``. The paper: "K-Means consists of
repetitive simple two-stage Spark jobs" — per iteration, a map stage
(assign points to nearest centroid, partial sums per partition) and a
reduce stage (combine partials, update centroids). The map stage carries
~all the compute, so HeMT skews the *point-partition* sizes by executor
capacity; the reduce is tiny.

The points, the centroids and the distances are float32, as the
reference's with x64 off: the squared distance in its difference form
sum((p - c)**2) (the expansion |p|^2 - 2 p.c + |c|^2 rounds differently
and moves argmin near ties) and ``argmin`` (the first minimal index, as
``jnp.argmin``). The reference's ``segment_sum`` becomes ``index_add_``
into float64 accumulators, and the centroid is their quotient rounded to
float32: a deliberate difference. Float32 sums of millions of points
depend on their order (on a card ``index_add_`` adds with atomics, in an
order that varies from run to run), and 30 iterations of K-means amplify
that well past 1e-4 at millions of points, so the partitioned job and the
unpartitioned oracle drift apart. Float64 sums of float32
points are exact to ~1e-12 relative in any order, so the partition no
longer changes the result, which is what HeMT promises. The map stage
runs over blocks of ``SUM_BLOCK`` points, so the (n, k, dim) difference
tensor lives one block at a time. The initial centroids come from the same
``numpy`` draw as the reference's. Executor timing comes from the simulator (``run_job``),
exactly like the training driver.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core.engine import PullSpec, StaticSpec, run_job
from repro_torch.core.partitioner import even_split, proportional_split
from repro_torch.core.simulator import SimNode

Points = Union[np.ndarray, torch.Tensor]


def _points(points: Points, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(points, device=dev).to(torch.float32)


def initial_centroids(points: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """The reference's draw: ``k`` distinct rows picked by numpy's
    ``default_rng(seed).choice``."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(points.shape[0], k, replace=False)
    return points[torch.from_numpy(rows).to(points.device)]


SUM_BLOCK = 1 << 20       # points whose (n, k, dim) differences live at once


def partial_sums(part: torch.Tensor, centroids: torch.Tensor, k: int):
    """One partition's map stage: per-centroid float64 sums and counts of
    the points nearest to it."""
    sums = torch.zeros((k, part.shape[1]), dtype=torch.float64, device=part.device)
    cnts = torch.zeros(k, dtype=torch.float64, device=part.device)
    for lo in range(0, part.shape[0], SUM_BLOCK):
        blk = part[lo:lo + SUM_BLOCK]
        assign = ((blk[:, None, :] - centroids[None]) ** 2).sum(-1).argmin(-1)
        sums.index_add_(0, assign, blk.double())
        cnts.index_add_(0, assign, torch.ones(blk.shape[0], dtype=torch.float64,
                                              device=part.device))
    return sums, cnts


def update(centroids: torch.Tensor, sums: torch.Tensor, cnts: torch.Tensor) -> torch.Tensor:
    """The reduce stage, rounded to the centroids' dtype: a centroid with no
    point keeps its place."""
    mean = (sums / cnts.clamp_min(1)[:, None]).to(centroids.dtype)
    return torch.where(cnts[:, None] > 0, mean, centroids)


def kmeans_reference(points: Points, k: int, iters: int, seed: int = 0, *,
                     device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Plain single-node K-Means (the oracle for partition-invariance);
    float32 centroids as numpy."""
    pts = _points(points, devices.resolve(device))
    c = initial_centroids(pts, k, seed)
    for _ in range(iters):
        c = update(c, *partial_sums(pts, c, k))
    return c.cpu().numpy()


@dataclass
class IterationReport:
    iteration: int
    makespan: float
    idle: float
    split: List[int]


class KMeansJob:
    """HeMT/HomT-scheduled distributed K-Means over simulated executors.

    ``points`` (a numpy array or a tensor) move to ``device`` once, here, in
    float32; ``centroids`` stay there.
    """

    def __init__(self, points: Points, k: int, nodes: Sequence[SimNode],
                 *, mode: str = "hemt", weights: Optional[Sequence[float]] = None,
                 n_tasks: Optional[int] = None, seed: int = 0,
                 work_per_point: float = 1e-4, mitigation=None,
                 adaptive=None, device: Union[str, torch.device] = "cuda"):
        assert mode in ("hemt", "homt", "even")
        self.device = devices.resolve(device)
        self.points = _points(points, self.device)
        self.k = k
        self.nodes = list(nodes)
        self.mode = mode
        self.weights = list(weights) if weights else None
        self.n_tasks = n_tasks or 4 * len(nodes)
        self.work_per_point = work_per_point
        # straggler mitigation policy (repro_torch.core.speculation) riding
        # every iteration's stage spec — covers stale `weights` on a drifted
        # cluster without changing the partition itself
        self.mitigation = mitigation
        # OA-HeMT: an engine.AdaptivePlan re-splitting each iteration's
        # macrotasks at its barrier from AR(1)-learned executor speeds —
        # `weights` (or the even cold-start split) only seeds iteration 0.
        # The result is partition-invariant, so the math below keeps the
        # fixed point partition while the schedule adapts.
        self.adaptive = adaptive
        self.centroids = initial_centroids(self.points, k, seed)
        self.reports: List[IterationReport] = []
        self._t = 0.0

    # ------------------------------------------------------------------
    def _partition(self) -> List[int]:
        n = self.points.shape[0]
        if self.mode == "hemt":
            if self.weights is None:    # adaptive cold start: even split
                return even_split(n, len(self.nodes))
            return proportional_split(n, self.weights)
        if self.mode == "even":
            return even_split(n, len(self.nodes))
        return even_split(n, self.n_tasks)

    # ------------------------------------------------------------------
    def run(self, iters: int, *, events: Optional[Tuple[torch.cuda.Event,
                                                       torch.cuda.Event]] = None,
            ) -> torch.Tensor:
        """Runs ``iters`` iterations; returns the float32 centroids (k, dim)
        on the job's device.

        ``events``, a (start, end) pair of CUDA events, are recorded around
        the iterations' math, so a caller can time the card's share of the
        job.
        """
        pts, k = self.points, self.k
        # the partition is mode-determined and data-independent, so every
        # iteration is the same stage: one run_job call schedules the whole
        # barrier sequence (repetitive jobs back-to-back)
        split = self._partition()
        if self.mode == "homt":
            spec = PullSpec(works=tuple(c * self.work_per_point
                                        for c in split),
                            mitigation=self.mitigation)
        else:
            spec = StaticSpec(works=tuple(c * self.work_per_point
                                          for c in split),
                              mitigation=self.mitigation)
        sched = run_job(self.nodes, [spec] * iters, start_time=self._t,
                        adaptive=self.adaptive)
        bounds = np.cumsum([0] + list(split))
        if events is not None:
            events[0].record()
        for it in range(iters):
            # real math, partition-structured: per-partition partial sums
            sums = torch.zeros((k, pts.shape[1]), dtype=torch.float64, device=self.device)
            cnts = torch.zeros(k, dtype=torch.float64, device=self.device)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if hi == lo:
                    continue
                ps, pc = partial_sums(pts[lo:hi], self.centroids, k)
                sums = sums + ps
                cnts = cnts + pc
            self.centroids = update(self.centroids, sums, cnts)
            summ = sched.stages[it]
            self.reports.append(IterationReport(it, summ.span, summ.idle_time,
                                                list(split)))
        if events is not None:
            events[1].record()
        self._t = sched.completion
        return self.centroids

    def total_time(self) -> float:
        return self._t
