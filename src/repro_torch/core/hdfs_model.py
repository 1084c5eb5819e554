"""Distributed-storage contention model — paper §3, Claim 2.

Copy of the JAX package's ``repro/core/hdfs_model.py`` (pure Python), imports
pointed at ``repro_torch.core``.

With n datanodes, replica factor r (n >= r), random replica placement and
uniform closest-replica choice:

  p1 = P(two readers of the SAME block hit the same datanode)   = 1/r
  p2 = P(two readers of DIFFERENT blocks hit the same datanode)
     = sum_{v=max(2r-n,0)}^{r} P(v) * v / r^2 ,
  P(v) = C(r,v) C(n-r, r-v) / C(n,r)          (hypergeometric overlap)

Claim 2: p1 >= p2, equality iff r = n. Finer partitioning makes concurrent
same-block reads more likely, hence more uplink contention (Fig 5).

We use the same model for data-pipeline feeder placement in the framework:
shard replicas ~ datanodes, concurrently-scheduled grains ~ readers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DuplicatePlacement:
    """Which datanode a duplicate reader re-fetches its input from.

    The mitigation subsystem (``repro_torch.core.speculation``) launches
    duplicate readers — a speculative copy re-fetching a straggler's full
    input, or a steal thief re-fetching its stolen range — and each
    duplicate opens a *new* flow through the flow-shared uplink model.
    This policy decides where that flow lands:

    * ``"same"`` (default): the duplicate re-reads the original datanode.
      The new flow fairly shares that uplink with the primary reader — the
      Claim 2 contention cost of duplicating a read, modelled exactly.
    * ``"replica"``: the duplicate reads the block's next replica in a
      deterministic replica ring of ``n_datanodes`` nodes: datanode
      ``(d + 1) % n_datanodes``.  The probabilistic placement model above
      (``overlap_pmf`` etc.) describes *expected* contention under random
      placement; the simulated engine needs a deterministic choice, so we
      pin the ring-adjacent replica — the best case the paper's p1 >= p2
      argument allows, where the duplicate avoids the primary's uplink
      entirely (unless another task's flow already lives there).

    Frozen (hashable) so it can ride the frozen mitigation policies
    through ``PullSpec``/``StaticSpec`` and the ``run_job`` solve caches.
    """
    policy: str = "same"        # "same" | "replica"
    n_datanodes: int = 0        # replica ring size (required for "replica")

    def __post_init__(self):
        if self.policy not in ("same", "replica"):
            raise ValueError(
                f"placement policy must be 'same' or 'replica': {self.policy!r}")
        if self.policy == "replica" and self.n_datanodes < 2:
            raise ValueError("replica placement needs n_datanodes >= 2 "
                             "(a 1-node ring has no distinct replica)")

    def choose(self, datanode: int) -> int:
        """Datanode the duplicate flow reads from (no-op for tasks
        without I/O, ``datanode < 0``)."""
        if datanode < 0 or self.policy == "same":
            return datanode
        return (datanode + 1) % self.n_datanodes


def overlap_pmf(n: int, r: int, v: int) -> float:
    """P(v): probability two random r-subsets of n nodes overlap in v."""
    if v < max(2 * r - n, 0) or v > r:
        return 0.0
    return (math.comb(r, v) * math.comb(n - r, r - v)) / math.comb(n, r)


def p_same_block(r: int) -> float:
    """p1 = 1/r."""
    if r < 1:
        raise ValueError("replica factor must be >= 1")
    return 1.0 / r


def p_diff_block(n: int, r: int) -> float:
    """p2 = sum_v P(v) v / r^2."""
    if n < r:
        raise ValueError("need n >= r")
    lo = max(2 * r - n, 0)
    return sum(overlap_pmf(n, r, v) * v / (r * r) for v in range(lo, r + 1))


def contention_probability(n: int, r: int, same_block: bool) -> float:
    return p_same_block(r) if same_block else p_diff_block(n, r)


def expected_uplink_collisions(n_tasks: int, n_blocks: int, n: int, r: int,
                               seed: int = 0, trials: int = 2000) -> float:
    """Monte-Carlo: tasks read blocks round-robin; each block's replicas on a
    random r-subset; reader picks a replica uniformly. Returns the expected
    number of datanode collisions among concurrent reader pairs (used by the
    Fig 5 benchmark to produce stage times under an uplink bandwidth cap)."""
    rng = np.random.default_rng(seed)
    collisions = 0
    for _ in range(trials):
        placement = [rng.choice(n, size=r, replace=False) for _ in range(n_blocks)]
        readers = [rng.choice(placement[t % n_blocks]) for t in range(n_tasks)]
        cnt = np.bincount(np.asarray(readers), minlength=n)
        collisions += int(np.sum(cnt * (cnt - 1) // 2))
    return collisions / trials


def uplink_slowdown(n_tasks: int, n_blocks: int, n: int, r: int,
                    seed: int = 0, trials: int = 500) -> float:
    """Expected max-readers-per-datanode (bandwidth division factor) when
    n_tasks concurrent tasks read n_blocks blocks."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(trials):
        placement = [rng.choice(n, size=r, replace=False) for _ in range(n_blocks)]
        readers = [rng.choice(placement[t % n_blocks]) for t in range(n_tasks)]
        cnt = np.bincount(np.asarray(readers), minlength=n)
        worst += float(cnt.max())
    return worst / trials
