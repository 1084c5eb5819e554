"""Skewed hash partitioner — paper Algorithm 1 (§7).

Assigns a record to a shuffle bucket by hashing into the capacity-weighted
prefix-sum space: bucket b receives a share of hash space proportional to
executor b's capacity. The paper expresses it as "the number of elements in
the (prefix-summed) capacities array >= hash"; equivalently a searchsorted
over the exclusive prefix sums.

Copy of the JAX package's ``repro/core/skewed_hash.py``: the numpy
functions are verbatim; ``bucket_of_jnp`` gives way to ``bucket_of_torch``.

Two implementations:
  * numpy / python — used by the scheduler & shuffle simulator,
  * torch — ``bucket_of_torch``, the same map on tensors;
    ``repro_torch.kernels.ops.skewed_bucket`` computes it on the card with
    the hand-written Hopper kernel.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def integer_capacities(weights: Sequence[float], resolution: int = 1 << 16,
                       ) -> np.ndarray:
    """Scale float capacities to integers summing to `resolution` (largest
    remainder), the hash-space size of Algorithm 1."""
    w = np.asarray(weights, np.float64)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError("capacities must be non-negative with positive sum")
    share = w / w.sum() * resolution
    base = np.floor(share).astype(np.int64)
    rem = resolution - int(base.sum())
    order = np.argsort(-(share - np.floor(share)))
    base[order[:rem]] += 1
    return base


def bucket_of(hash_codes: np.ndarray, capacities: np.ndarray) -> np.ndarray:
    """Vectorized Algorithm 1. hash_codes: int array; capacities: ints.

    h = hash mod sum(capacities); bucket = #(prefix_sums <= h) -- i.e. the
    unique b with cum_{b} <= h < cum_{b+1} (cum exclusive prefix sums).
    """
    caps = np.asarray(capacities, np.int64)
    total = int(caps.sum())
    h = np.mod(np.asarray(hash_codes, np.int64), total)
    cum = np.cumsum(caps)  # inclusive prefix sums
    return np.searchsorted(cum, h, side="right").astype(np.int32)


def bucket_of_torch(hash_codes: torch.Tensor, capacities: torch.Tensor) -> torch.Tensor:
    """torch twin of `bucket_of`, on the tensors' device (int64 inside;
    ``torch.remainder`` is floor-mod, as ``np.mod``)."""
    caps = capacities.to(torch.int64)
    total = caps.sum()
    h = torch.remainder(hash_codes.to(torch.int64), total)
    cum = torch.cumsum(caps, 0)
    return torch.searchsorted(cum, h, right=True).to(torch.int32)


def expected_shares(capacities: Sequence[int]) -> List[float]:
    caps = np.asarray(capacities, np.float64)
    return list(caps / caps.sum())


def skewed_shuffle_counts(n_records: int, capacities: Sequence[int],
                          seed: int = 0) -> np.ndarray:
    """Simulate a shuffle of n_records uniformly-hashed records through
    Algorithm 1; returns per-bucket record counts."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, np.iinfo(np.int64).max, size=n_records)
    b = bucket_of(hashes, np.asarray(capacities))
    return np.bincount(b, minlength=len(list(capacities)))
