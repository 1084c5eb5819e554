"""PageRank as a HeMT-schedulable multi-stage job (paper §7, Fig 18).

Port of ``repro/workloads/pagerank.py``. "PageRank ... is a single Spark
job containing multiple computation stages concatenated together through
shuffling" — per iteration, each executor processes the out-edges of its
vertex bucket and shuffles rank contributions to the owners of the
destination vertices. Vertex->bucket ownership is the partitioner: the
default even hash vs the paper's Algorithm 1 skewed hash, which sizes
buckets by executor capacity. Iterations are short (~10s at 2-way in the
paper), so per-task overhead matters — exactly the regime where HomT
microtasking loses (Fig 18).

The ownership map runs through ``kernels.ops.skewed_bucket``: on a card,
the hand-written Hopper kernel, on the CPU its plain version. It is the
same integer map as ``core.skewed_hash.bucket_of``. The rank math is
float32, as the reference's with x64 off: gathers and ``index_add_`` (the
reference's ``segment_sum``). On the card ``index_add_`` adds with atomics,
so the order of each vertex's sum, and its last bits, vary from run to run.
Executor timing comes from the simulator with per-task overhead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core.engine import PullSpec, StaticSpec, run_job
from repro_torch.core.partitioner import even_split
from repro_torch.core.simulator import SimNode
from repro_torch.core.skewed_hash import integer_capacities
from repro_torch.kernels import ops

Edges = Union[np.ndarray, torch.Tensor]


def _edges(x: Edges, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.int64)


def _out_degree(src: torch.Tensor, n: int) -> torch.Tensor:
    ones = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    deg = torch.zeros(n, dtype=torch.float32, device=src.device).index_add_(0, src, ones)
    return deg.clamp_min_(1.0)


def _rank_step(ranks: torch.Tensor, out_deg: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n: int, d: float) -> torch.Tensor:
    # (ranks / out_deg)[src] is ranks[src] / out_deg[src] to the bit, with
    # the quotient taken once per vertex instead of once per edge
    contrib = (ranks / out_deg).index_select(0, src)
    incoming = torch.zeros_like(ranks).index_add_(0, dst, contrib)
    return (1 - d) / n + d * incoming


def vertex_hashes(n: int) -> np.ndarray:
    """Knuth multiplicative hash of the vertex ids mod 2**31, as int32. The
    uint64 multiply stays in numpy, as in the reference; taken mod 2**31,
    the hash fits int32 exactly."""
    return (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)
            % np.uint64(1 << 31)).astype(np.int32)


def pagerank_reference(src: Edges, dst: Edges, n: int, iters: int,
                       d: float = 0.85, *, device: Union[str, torch.device] = "cuda",
                       ) -> np.ndarray:
    """Single-node PageRank oracle (uniform out-degree normalization), float32."""
    dev = devices.resolve(device)
    s, t = _edges(src, dev), _edges(dst, dev)
    out_deg = _out_degree(s, n)
    ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        ranks = _rank_step(ranks, out_deg, s, t, n, d)
    return ranks.cpu().numpy()


@dataclass
class StageReport:
    iteration: int
    makespan: float
    idle: float
    bucket_sizes: List[int]


class PageRankJob:
    """Distributed PageRank with even-hash or skewed-hash vertex buckets.

    ``src`` and ``dst`` (numpy arrays or tensors) move to ``device`` once,
    here; ``owner`` is a host copy of the ownership map made on the device.
    """

    def __init__(self, src: Edges, dst: Edges, n: int,
                 nodes: Sequence[SimNode], *, mode: str = "hemt",
                 weights: Optional[Sequence[float]] = None,
                 n_tasks: Optional[int] = None, d: float = 0.85,
                 work_per_edge: float = 2e-5, mitigation=None,
                 adaptive=None, device: Union[str, torch.device] = "cuda"):
        assert mode in ("hemt", "homt", "even")
        self.device = devices.resolve(device)
        self.src, self.dst = _edges(src, self.device), _edges(dst, self.device)
        self.n = n
        self.nodes = list(nodes)
        self.mode = mode
        self.d = d
        self.work_per_edge = work_per_edge
        self.n_tasks = n_tasks or 4 * len(nodes)
        # straggler mitigation policy (repro_torch.core.speculation) riding
        # every iteration's stage spec — rescues a skewed-hash bucket stranded
        # on a node whose capacity drifted since the weights were learned
        self.mitigation = mitigation
        # OA-HeMT: an engine.AdaptivePlan re-skews each iteration's
        # edge-processing stage at its barrier from AR(1)-learned speeds
        # (rank math is bucket-invariant, so only the schedule adapts; the
        # shuffle buckets stay fixed, as re-hashing vertices mid-job would
        # move data, not just work)
        self.adaptive = adaptive
        ne = len(nodes)
        if mode == "hemt":
            if weights is None:        # adaptive cold start: even buckets
                weights = [1.0] * ne
            caps = integer_capacities(weights, resolution=1 << 12)
        else:
            caps = integer_capacities([1.0] * ne, resolution=1 << 12)
        # vertex -> owning executor bucket (Algorithm 1 over a Knuth
        # multiplicative hash — raw ids are NOT uniform over the capacity
        # space when n < resolution)
        self.owner_device = ops.skewed_bucket(
            torch.from_numpy(vertex_hashes(n)).to(self.device),
            torch.as_tensor(caps, dtype=torch.int32, device=self.device))
        self.owner = self.owner_device.cpu().numpy()
        self.reports: List[StageReport] = []
        self._t = 0.0

    # ------------------------------------------------------------------
    def run(self, iters: int, *, events: Optional[Tuple[torch.cuda.Event,
                                                       torch.cuda.Event]] = None,
            ) -> np.ndarray:
        """Runs ``iters`` iterations; returns float32 ranks as numpy.

        ``events``, a (start, end) pair of CUDA events, are recorded around
        the rank loop, so a caller can time the card's share of the job.
        """
        n, ne = self.n, len(self.nodes)
        out_deg = _out_degree(self.src, n)
        ranks = torch.full((n,), 1.0 / n, dtype=torch.float32, device=self.device)
        # per-executor edge counts: an executor processes out-edges of the
        # vertices it owns (that is the per-stage work the scheduler sees)
        edge_owner = self.owner_device.index_select(0, self.src)
        edges_per_exec = torch.bincount(edge_owner, minlength=ne).cpu().numpy()
        del edge_owner

        # the vertex->bucket shuffle is fixed, so every iteration runs the
        # same stage: hand the whole barrier sequence to run_job (one spec,
        # solved once, O(nodes) per further iteration) instead of
        # re-entering the engine per stage
        if self.mode == "homt":
            per = even_split(int(edges_per_exec.sum()), self.n_tasks)
            spec = PullSpec(works=tuple(c * self.work_per_edge for c in per),
                            mitigation=self.mitigation)
        else:
            spec = StaticSpec(works=tuple(c * self.work_per_edge
                                          for c in edges_per_exec),
                              mitigation=self.mitigation)
        sched = run_job(self.nodes, [spec] * iters, start_time=self._t,
                        adaptive=self.adaptive)
        bucket_sizes = list(torch.bincount(self.owner_device, minlength=ne).cpu().numpy())

        if events is not None:
            events[0].record()
        for it in range(iters):
            ranks = _rank_step(ranks, out_deg, self.src, self.dst, n, self.d)
            summ = sched.stages[it]
            self.reports.append(StageReport(it, summ.span, summ.idle_time,
                                            list(bucket_sizes)))
        if events is not None:
            events[1].record()
        self._t = sched.completion
        return ranks.cpu().numpy()

    def total_time(self) -> float:
        return self._t


def random_graph(n: int, avg_deg: int, seed: int = 0,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    return (rng.integers(0, n, m).astype(np.int64),
            rng.integers(0, n, m).astype(np.int64))
