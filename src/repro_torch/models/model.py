"""Top-level model: embeddings + decoder stack + tied head, prefill, decode.

Port of ``repro/models/model.py`` for decoder-only attention archs and
pure SSM (Mamba2) archs. The parameters are an ``nn.ModuleDict`` with the
reference's top-level keys (``embed``, ``stack``, ``final_norm``,
optionally ``unembed``); the decode state holds one cache per layer, a KV
ring buffer or an SSM ``{"conv", "state"}`` pair. The training loss waits
for the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch import devices
from repro_torch.configs.base import ModelConfig, padded_vocab_size
from repro_torch.models import transformer
from repro_torch.models.layers import embed, embedding_init, rmsnorm, rmsnorm_init, unembed

State = Dict[str, Any]

NEG_INF = -1e30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding tables are padded to a 256 multiple; pad-vocab logits are
    forced to -1e30 so softmax mass is exact."""
    pv = padded_vocab_size(cfg)
    if pv == cfg.vocab_size:
        return logits
    valid = torch.arange(pv, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, NEG_INF)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Union[str, torch.device] = "cuda",
                dtype: Optional[torch.dtype] = None) -> nn.ModuleDict:
    """Random weights from a seeded ``torch.Generator`` on ``device``.
    ``dtype`` defaults to the config's."""
    transformer.check_ported(cfg)
    dev = devices.resolve(device)
    dt = _dtype(cfg) if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pv = padded_vocab_size(cfg)
    p = nn.ModuleDict({
        "embed": embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev),
        "stack": transformer.stack_init(gen, cfg, dtype=dt, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, device=dev),
    })
    if not cfg.tie_embeddings:
        p["unembed"] = embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev)
    return p


def _head(params) -> Any:
    return params["unembed"] if "unembed" in params else params["embed"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def hidden_states(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B,S,D) + moe aux loss (pre-unembed)."""
    x = embed(params["embed"], tokens)
    b, s = x.shape[:2]
    x, aux = transformer.stack_apply(params["stack"], x, cfg,
                                     _positions(b, s, x.device), impl=impl)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V), moe_aux_loss)."""
    x, aux = hidden_states(params, tokens, cfg, impl=impl)
    return unembed(_head(params), x), aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            impl: str = "xla") -> Tuple[torch.Tensor, State]:
    """Process a prompt batch and build the decode state.

    tokens: (B, S). Returns (last-token logits (B, V), decode state with
    cache filled and length = S) — the serving prefill step.
    """
    x = embed(params["embed"], tokens)
    b, s = x.shape[:2]
    x, cache, _ = transformer.stack_prefill(params["stack"], x, cfg,
                                            _positions(b, s, x.device), max_len,
                                            impl=impl)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = mask_pad_logits(unembed(_head(params), x)[:, 0, :], cfg)
    return logits, {"cache": cache, "length": s}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: Union[str, torch.device] = "cuda") -> State:
    dev = devices.resolve(device)
    return {
        "cache": transformer.stack_init_cache(cfg, batch, max_len,
                                              dtype=_dtype(cfg), device=dev),
        "length": 0,
    }


def decode_step(params, state: State, token: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """token: (B,) integer. Returns (logits (B,V), new state). The caches of
    ``state`` are updated in place; ``length`` is a Python int."""
    x = embed(params["embed"], token[:, None])
    x, cache = transformer.stack_decode_step(params["stack"], state["cache"], x,
                                             state["length"], cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = mask_pad_logits(unembed(_head(params), x)[:, 0, :], cfg)
    return logits, {"cache": cache, "length": state["length"] + 1}
