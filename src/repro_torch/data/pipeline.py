"""Deterministic synthetic corpus + storage-aware feeder placement.

Design constraints (from the paper, adapted per DESIGN.md §2):

* **Index-addressed, not file-addressed.** Any worker can materialize any
  global sample index from (seed, index) alone — this is what lets HeMT
  re-skew shard boundaries between steps (and elastic resharding after a
  node loss) without any data movement. A Spark repartition becomes a
  pure index-range re-assignment.
* **Claim 2 analogue.** When grains *are* backed by remote storage shards,
  `FeederPlacement` spreads concurrent readers over shard replicas using
  the paper's same-block/different-block contention model
  (`repro.core.hdfs_model`): consecutive grains map to consecutive ranges
  of the same shard, so scheduling many tiny grains concurrently creates
  same-shard co-reads exactly like HDFS microtasks (Fig 5). The placement
  picker minimizes expected uplink collisions.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


from repro_torch.core.hdfs_model import p_diff_block, p_same_block


def _fold_seed(*parts: int) -> int:
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(int(p).to_bytes(8, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


@dataclass(frozen=True)
class SyntheticCorpus:
    """Deterministic infinite LM corpus.

    Sample ``i`` is a function of (seed, i) only. Tokens follow a Zipfian
    unigram draw with a per-sample Markov perturbation so the loss is
    learnable (quickstart's ~100M model visibly descends) yet cheap.
    """
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    # per-shape [G, B, seq] grain-block buffers for batch_block, lazily
    # allocated and reused across steps (excluded from eq/hash)
    _blocks: Dict[Tuple[int, int], Dict[str, np.ndarray]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    def _tokens(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(_fold_seed(self.seed, index))
        # zipf over [1, vocab): rejection-free via bounded zipf
        raw = rng.zipf(self.zipf_a, size=self.seq_len + 1)
        toks = (raw % (self.vocab_size - 1)) + 1
        # short deterministic motif makes next-token structure learnable
        motif = rng.integers(1, self.vocab_size, size=8)
        pos = rng.integers(0, max(1, self.seq_len - 8), size=4)
        for p in pos:
            toks[p:p + 8] = motif
        return toks

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        toks = self._tokens(index)
        return {"tokens": toks[:-1].astype(np.int32),
                "labels": toks[1:].astype(np.int32)}

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        samples = [self.sample(i) for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def batch_block(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """A [G, B] index grid materialized as [G, B, seq] token/label
        arrays, written in place into a preallocated per-shape buffer.

        This is the grain fast path: a training step's whole grain block is
        produced with zero intermediate per-sample dicts or ``np.stack``
        copies.  The returned arrays are REUSED by the next ``batch_block``
        call of the same shape — callers must transfer/copy (e.g.
        ``jnp.asarray``) before requesting the next block.
        """
        indices = np.asarray(indices)
        buf = self._blocks.get(indices.shape)
        if buf is None:
            shape = (*indices.shape, self.seq_len)
            buf = {"tokens": np.empty(shape, np.int32),
                   "labels": np.empty(shape, np.int32)}
            self._blocks[indices.shape] = buf
        tok, lab = buf["tokens"], buf["labels"]
        for g in range(indices.shape[0]):
            for b in range(indices.shape[1]):
                toks = self._tokens(int(indices[g, b]))
                tok[g, b] = toks[:-1]
                lab[g, b] = toks[1:]
        return buf


def make_batch_specs(cfg, shape, *, dtype_tokens=np.int32) -> Dict[str, Tuple]:
    """(shape, dtype) pairs for every model input at a given ShapeConfig —
    single source of truth shared by the data pipeline and input_specs()."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Tuple] = {}
    if cfg.frontend == "vision":
        from repro_torch.models.frontends import frontend_feature_dim
        specs["input_embeds"] = ((b, s, frontend_feature_dim(cfg)), np.float32)
        specs["labels"] = ((b, s), dtype_tokens)
    elif cfg.frontend == "audio":
        from repro_torch.models.frontends import frontend_feature_dim
        specs["tokens"] = ((b, s), dtype_tokens)
        specs["labels"] = ((b, s), dtype_tokens)
        specs["enc_feats"] = ((b, cfg.max_source_positions,
                               frontend_feature_dim(cfg)), np.float32)
    else:
        specs["tokens"] = ((b, s), dtype_tokens)
        specs["labels"] = ((b, s), dtype_tokens)
    return specs


class FeederPlacement:
    """Storage-shard reader placement using the paper's contention model.

    n_shards storage shards, each replicated `replica` ways over `n_feeders`
    feeder hosts (random placement, as HDFS). `readers_for` assigns each
    concurrent grain a feeder, preferring the replica with the fewest
    already-assigned readers — the deterministic analogue of Spark's
    sequential scheduling that the paper credits with reducing same-block
    contention (§3).
    """

    def __init__(self, n_feeders: int, n_shards: int, replica: int = 2,
                 seed: int = 0):
        if replica > n_feeders:
            raise ValueError("replica factor exceeds feeder count")
        rng = np.random.default_rng(seed)
        self.n_feeders = n_feeders
        self.placement = [rng.choice(n_feeders, size=replica, replace=False)
                          for _ in range(n_shards)]
        self.replica = replica
        self.n_shards = n_shards

    def readers_for(self, grain_shards: Sequence[int]) -> List[int]:
        load = np.zeros(self.n_feeders, np.int64)
        out = []
        for s in grain_shards:
            reps = self.placement[s % self.n_shards]
            pick = int(reps[np.argmin(load[reps])])
            load[pick] += 1
            out.append(pick)
        return out

    def expected_collision_prob(self, same_shard: bool) -> float:
        """Paper Claim 2 quantities for this placement's (n, r)."""
        if same_shard:
            return p_same_block(self.replica)
        return p_diff_block(self.n_feeders, self.replica)

    def max_concurrent_readers(self, grain_shards: Sequence[int]) -> int:
        counts = np.bincount(self.readers_for(grain_shards),
                             minlength=self.n_feeders)
        return int(counts.max())
