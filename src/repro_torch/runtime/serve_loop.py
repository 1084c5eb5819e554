"""Serving: prefill/decode step factories + HeMT continuous batching.

Port of ``repro/runtime/serve_loop.py``. ``HeMTBatcher`` is the paper's
§5.1 estimator applied to replicas: request batches are sized proportional
to AR(1)-estimated per-replica decode throughput, so heterogeneous replicas
reach their batch deadlines together; ``plan()`` hands the same
estimator to the fleet-serving scenario (``runtime/serving.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import AdaptivePlan
from repro_torch.core.estimators import ARSpeedEstimator
from repro_torch.core.partitioner import even_split, proportional_split
from repro_torch.models.model import decode_step, prefill
from repro_torch.runtime.sharding import mesh_context


def make_serve_step(cfg: ModelConfig, *, sample: str = "greedy") -> Callable:
    """serve_step(params, state, tokens (B,), [enc_out]) -> (next_tokens (B,),
    logits (B,V), new state). The state's caches are updated in place.
    Placed params (``runtime.sharding.place``) run on their mesh."""
    if sample != "greedy":
        raise ValueError(sample)

    @torch.no_grad()
    def serve_step(params, state, tokens: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None):
        with mesh_context(params):
            logits, new_state = decode_step(params, state, tokens, cfg, enc_out=enc_out)
            return torch.argmax(logits, dim=-1).to(torch.int32), logits, new_state

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *, impl: str = "xla",
                      ) -> Callable:
    """prefill_step(params, tokens (B,S), [enc_feats]) -> (first sampled
    token (B,), decode state). Placed params run on their mesh."""

    @torch.no_grad()
    def prefill_step(params, tokens: torch.Tensor,
                     enc_feats: Optional[torch.Tensor] = None):
        with mesh_context(params):
            logits, state = prefill(params, tokens, cfg, max_len, enc_feats=enc_feats,
                                    impl=impl)
            return torch.argmax(logits, dim=-1).to(torch.int32), state

    return prefill_step


# --------------------------------------------------------------------------
# HeMT continuous batching across replicas
# --------------------------------------------------------------------------

@dataclass
class ReplicaState:
    name: str
    active: int = 0                  # requests currently decoding
    tokens_done: int = 0


@dataclass
class DispatchRecord:
    round: int
    shares: Dict[str, int]
    predicted_finish: Dict[str, float]


class HeMTBatcher:
    """Sizes per-replica request batches ∝ estimated decode throughput.

    `observe(replica, tokens, seconds)` feeds the AR(1) estimator (§5.1 —
    per job class, here per model). `dispatch(n)` splits n requests;
    homogeneous mode (`mode='even'`) is the HomT-like baseline."""

    def __init__(self, replicas: Sequence[str], *, alpha: float = 0.3,
                 mode: str = "hemt", min_share: int = 0):
        self.replicas = list(replicas)
        self.estimator = ARSpeedEstimator(alpha=alpha)
        self.mode = mode
        self.min_share = min_share
        self.log: List[DispatchRecord] = []
        self._round = 0

    def observe(self, replica: str, tokens: int, seconds: float) -> None:
        if tokens > 0 and seconds > 0:
            self.estimator.observe(replica, tokens, seconds)

    def dispatch(self, n_requests: int) -> Dict[str, int]:
        n = len(self.replicas)
        if self.mode == "even" or not self.estimator.known():
            shares = even_split(n_requests, n)
        else:
            speeds = self.estimator.speeds(self.replicas)
            shares = proportional_split(n_requests, speeds,
                                        min_share=self.min_share)
        speeds = self.estimator.speeds(self.replicas)
        pred = {r: (s / v if v > 0 else float("inf"))
                for r, s, v in zip(self.replicas, shares, speeds)}
        out = dict(zip(self.replicas, shares))
        self.log.append(DispatchRecord(self._round, out, pred))
        self._round += 1
        return out

    def resize(self, replicas: Sequence[str]) -> None:
        gone = set(self.replicas) - set(replicas)
        for g in gone:
            self.estimator.forget(g)
        self.replicas = list(replicas)

    def plan(self, **kwargs) -> AdaptivePlan:
        """An :class:`~repro_torch.core.engine.AdaptivePlan` sharing this
        batcher's AR(1) state.  The fleet serving scenario
        (:mod:`repro_torch.runtime.serving`) attaches one per batch job, so
        every decode split is sized from the same estimates round-based
        ``dispatch`` uses and every finished batch feeds the estimator
        back through the resident calendar's barrier observations."""
        return AdaptivePlan(self.estimator, **kwargs)

    def straggling(self, factor: float = 2.0) -> List[str]:
        """Replicas whose estimated speed has fallen ``factor``x below
        the median estimate — the serving-side speculation trigger."""
        if factor < 1.0:
            raise ValueError("straggler factor must be >= 1.0")
        if not self.estimator.known():
            return []
        speeds = self.estimator.speeds(self.replicas)
        ordered = sorted(speeds)
        mid = len(ordered) // 2
        median = ordered[mid] if len(ordered) % 2 else \
            0.5 * (ordered[mid - 1] + ordered[mid])
        return [r for r, v in zip(self.replicas, speeds)
                if v * factor < median]

    def predicted_sync_delay(self, shares: Dict[str, int]) -> float:
        speeds = dict(zip(self.replicas, self.estimator.speeds(self.replicas)))
        times = [shares[r] / speeds[r] for r in self.replicas
                 if shares.get(r, 0) > 0]
        return (max(times) - min(times)) if times else 0.0
