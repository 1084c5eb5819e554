"""Grains — the framework's "tasks".

A grain is a fixed-shape microbatch (grain_batch sequences). The HeMT
planner sizes each slice's *grain count* per step (macrotask = k_i grains);
the HomT baseline puts all grains in a shared queue and slices pull.

Grains are index ranges into the deterministic corpus, so reassigning a
grain (HeMT re-skew, work stealing, elastic replan) moves no data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.data.pipeline import SyntheticCorpus


@dataclass(frozen=True)
class Grain:
    """One microtask: global sample indices [start, start + size)."""
    step: int
    start: int
    size: int

    def indices(self) -> range:
        return range(self.start, self.start + self.size)


@dataclass
class GrainAssignment:
    """Per-slice grain lists for one global step."""
    step: int
    per_slice: Dict[str, List[Grain]]

    def counts(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.per_slice.items()}


def plan_grain_ranges(step: int, global_batch: int, grain_batch: int,
                      slice_names: Sequence[str], grain_counts: Sequence[int],
                      ) -> GrainAssignment:
    """Slice the step's index range [step*B, (step+1)*B) into grains and
    hand k_i consecutive grains to slice i (consecutive ranges = sequential
    reads on a storage-backed corpus — the paper's I/O-locality argument)."""
    n_grains = global_batch // grain_batch
    if sum(grain_counts) != n_grains:
        raise ValueError(f"grain counts {grain_counts} != {n_grains}")
    base = step * global_batch
    per: Dict[str, List[Grain]] = {}
    g = 0
    for name, k in zip(slice_names, grain_counts):
        per[name] = [Grain(step, base + (g + j) * grain_batch, grain_batch)
                     for j in range(k)]
        g += k
    return GrainAssignment(step, per)


class GrainSource:
    """Materializes grains for one slice from the deterministic corpus."""

    def __init__(self, corpus: SyntheticCorpus, grain_batch: int):
        self.corpus = corpus
        self.grain_batch = grain_batch

    def load(self, grain: Grain) -> Dict[str, np.ndarray]:
        return self.corpus.batch(list(grain.indices()))

    def load_many(self, grains: Sequence[Grain]) -> Iterator[Dict[str, np.ndarray]]:
        for g in grains:
            yield self.load(g)

    def load_stacked(self, grains: Sequence[Grain]) -> Dict[str, np.ndarray]:
        """A whole step's grains as [G, grain_batch, seq] arrays, filled
        into the corpus's preallocated block buffers — the trainer's
        one-dispatch-per-step path stacks nothing on the host.

        The arrays are reused by the next same-shape call: transfer or copy
        (e.g. ``jnp.asarray``) before loading the next step's block.
        """
        if any(g.size != self.grain_batch for g in grains):
            raise ValueError("load_stacked needs uniform grain_batch grains")
        starts = np.asarray([g.start for g in grains])
        return self.corpus.batch_block(
            starts[:, None] + np.arange(self.grain_batch))
