"""Serving: prefill/decode step factories + HeMT continuous batching.

Port of ``repro/runtime/serve_loop.py``. ``HeMTBatcher`` is the paper's
§5.1 estimator applied to replicas: request batches are sized proportional
to AR(1)-estimated per-replica decode throughput, so heterogeneous replicas
reach their batch deadlines together; ``plan()`` hands the same
estimator to the fleet-serving scenario (``runtime/serving.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import AdaptivePlan
from repro_torch.core.estimators import ARSpeedEstimator
from repro_torch.core.partitioner import even_split, proportional_split
from repro_torch.models.model import decode_position, decode_step, prefill
from repro_torch.models.transformer import decode_graph_safe
from repro_torch.runtime.sharding import mesh_context


# Decode steps by how they ran, like the kernels' ``launches``: "capture"
# counts the CUDA graphs captured, "replay" the steps a graph ran (a
# capture's own step among them), "eager" the steps issued op by op.
decode_steps = {"capture": 0, "replay": 0, "eager": 0}

_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


class _DecodeGraph:
    """One batch's decode step captured as a CUDA graph. It reads the
    token buffer ``tokens`` and writes ``next_tokens`` and ``logits`` in
    its private memory pool; the caches and the position it updates in
    place are the state's own, so replaying it steps that state. Freed,
    pool and all, with the last decode state that holds it."""

    def __init__(self, params, state: Dict, tokens: torch.Tensor, cfg: ModelConfig):
        dev = tokens.device
        stream = _capture_streams.get(dev)
        if stream is None:
            stream = _capture_streams[dev] = torch.cuda.Stream(dev)
        self.tokens = tokens.clone()
        self.graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.logits, _ = decode_step(params, state, self.tokens, cfg)
                self.next_tokens = torch.argmax(self.logits, dim=-1).to(torch.int32)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def __call__(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Replay on the current stream; fresh copies of the outputs."""
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.next_tokens.clone(), self.logits.clone()


def _graph_safe(cfg: ModelConfig, params, tokens: torch.Tensor,
                enc_out: Optional[torch.Tensor]) -> bool:
    """Whether a step can be captured: tokens on the card, unplaced params
    (placed decode runs DTensor's host-side dispatch), no encoder output,
    and only layers whose decode the device runs alone."""
    return (tokens.is_cuda and enc_out is None
            and not isinstance(next(params.parameters(), None), DTensor)
            and decode_graph_safe(cfg))


def make_serve_step(cfg: ModelConfig, *, sample: str = "greedy") -> Callable:
    """serve_step(params, state, tokens (B,), [enc_out]) -> (next_tokens (B,),
    logits (B,V), new state). The state's caches are updated in place.
    Placed params (``runtime.sharding.place``) run on their mesh.

    On the card, a batch's first call captures the whole decode step as a
    CUDA graph (``_DecodeGraph``) and every call, that one included,
    replays it: one launch a step instead of one per kernel. The graph
    lives in the returned state and dies with it. Inputs a graph cannot
    hold (CPU tensors, placed params, an encoder output, an MoE layer; see
    ``_graph_safe``) run the step eagerly. ``decode_steps`` counts each way.

    Each call is a ``decode_step`` span carrying the batch id its prefill
    bound and ``graph``: "capture", "replay" or "eager". The per-kind
    spans inside it fire only where the step's Python runs: on a capture
    and on an eager step."""
    if sample != "greedy":
        raise ValueError(sample)

    @torch.no_grad()
    def serve_step(params, state, tokens: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None):
        batch, step = telemetry.batch_step(state["cache"])
        with telemetry.span("decode_step", batch=batch, rows=tokens.shape[0],
                            step=step) as sp, mesh_context(params):
            graph, how = state.get("graph"), "replay"
            if graph is None and _graph_safe(cfg, params, tokens, enc_out):
                state = {**state, "pos": decode_position(state, tokens.device)}
                graph, how = _DecodeGraph(params, state, tokens, cfg), "capture"
                decode_steps["capture"] += 1
            if graph is None:
                how = "eager"
                decode_steps["eager"] += 1
                logits, new_state = decode_step(params, state, tokens, cfg, enc_out=enc_out)
                next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                decode_steps["replay"] += 1
                next_tokens, logits = graph(tokens)
                new_state = {**state, "length": state["length"] + 1, "graph": graph}
            sp.set(graph=how)
            return next_tokens, logits, new_state

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int, *, impl: str = "xla",
                      ) -> Callable:
    """prefill_step(params, tokens (B,S), [enc_feats]) -> (first sampled
    token (B,), decode state). Placed params run on their mesh. Each call
    is a ``prefill`` span that opens a batch id and binds it to the state."""

    @torch.no_grad()
    def prefill_step(params, tokens: torch.Tensor,
                     enc_feats: Optional[torch.Tensor] = None):
        batch = telemetry.new_batch()
        with telemetry.span("prefill", batch=batch, rows=tokens.shape[0],
                            prompt_len=tokens.shape[1]), mesh_context(params):
            logits, state = prefill(params, tokens, cfg, max_len, enc_feats=enc_feats,
                                    impl=impl)
            telemetry.bind(state["cache"], batch)
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
        """An ``observe`` span; ``predicted_s`` is what the estimate held
        just before this observation foretold (absent while the replica is
        unknown)."""
        speed = self.estimator.speed(replica)
        pred = {} if not speed else {"predicted_s": tokens / speed}
        with telemetry.span("observe", replica=replica, tokens=tokens, observed_s=seconds,
                            **pred):
            if tokens > 0 and seconds > 0:
                self.estimator.observe(replica, tokens, seconds)

    def dispatch(self, n_requests: int) -> Dict[str, int]:
        with telemetry.span("dispatch", round=self._round) as sp:
            out = self._dispatch(n_requests)
            sp.set(shares=dict(out))
            return out

    def _dispatch(self, n_requests: int) -> Dict[str, int]:
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
