"""Decoder stack: a loop over per-layer modules.

Port of ``repro/models/transformer.py`` for attention layers. The
reference stacks each leaf along a leading ``(n_groups,)`` axis and scans
over layer groups; here the stack is an ``nn.ModuleList`` with one entry
per layer (layer ``i`` plays the reference's ``sub{i % period}`` of group
``i // period``; ``repro_torch.convert`` moves the leaves), and the scan
is a Python loop. SSM, MoE, cross-attention layers and local:global
window patterns are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init

Cache = List[Dict[str, torch.Tensor]]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of an architecture this port does not cover."""
    if cfg.attention is None or cfg.ssm is not None or cfg.attn_period:
        raise NotImplementedError(f"{cfg.name}: SSM layers are not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet")
    if cfg.encoder_layers > 0 or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention and frontends are not ported yet")
    if cfg.attention.local_global != (0, 0):
        raise NotImplementedError(
            f"{cfg.name}: local:global window patterns are not ported yet")


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """A sliding-window layer's ring cache holds only the window."""
    window = cfg.attention.sliding_window
    return min(max_len, window) if window > 0 else max_len


# ==========================================================================
# single layer
# ==========================================================================

def _layer_init(gen: torch.Generator, cfg: ModelConfig, *,
                dtype=torch.bfloat16, device=None) -> nn.ModuleDict:
    check_ported(cfg)
    p = nn.ModuleDict({
        "norm1": rmsnorm_init(cfg.d_model, device=device),
        "mixer": attn.attention_init(gen, cfg.d_model, cfg.attention,
                                     dtype=dtype, device=device)})
    if cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, device=device)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype=dtype,
                            device=device)
    return p


def _layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, impl: str = "xla") -> torch.Tensor:
    """Pre-norm residual layer."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    h = attn.attention_apply(p["mixer"], h, cfg.attention, positions, impl=impl)
    x = x + h
    if "ffn" in p:
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["ffn"], h, cfg.act)
    return x


# ==========================================================================
# the stack
# ==========================================================================

def stack_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.bfloat16,
               device=None) -> nn.ModuleList:
    return nn.ModuleList(_layer_init(gen, cfg, dtype=dtype, device=device)
                         for _ in range(cfg.n_layers))


def stack_apply(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *,
                impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe aux loss); the aux loss is zero until MoE is ported."""
    for p in params:
        x = _layer_apply(p, x, cfg, positions, impl=impl)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ==========================================================================
# decode caches
# ==========================================================================

def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None) -> Cache:
    """One {"k","v"} ring-buffer cache per layer. Sliding-window layers
    allocate only ``window`` slots."""
    return [attn.init_kv_cache(batch, _cache_len(cfg, max_len), cfg.attention,
                               dtype=dtype, device=device)
            for _ in range(cfg.n_layers)]


def stack_prefill(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, max_len: int, *, impl: str = "xla",
                  ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Full-sequence pass that also builds the decode cache.

    Returns (hidden (B,S,D), cache matching stack_init_cache(max_len), moe
    aux loss). Cache slots follow the decode ring-buffer layout so
    stack_decode_step continues seamlessly with cache_len = S.
    """
    cache: Cache = []
    for p in params:
        hin = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, c = attn.attention_prefill(p["mixer"], hin, cfg.attention, positions,
                                        _cache_len(cfg, max_len), impl=impl)
        x = x + out
        if "ffn" in p:
            hin = rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + mlp_apply(p["ffn"], hin, cfg.act)
        cache.append(c)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_decode_step(params: nn.ModuleList, cache: Cache, x: torch.Tensor,
                      cache_len: int, cfg: ModelConfig,
                      ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through the whole stack. x: (B, 1, D). Each layer's
    cache is updated in place (see attention_decode_step)."""
    for p, c in zip(params, cache):
        hin = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, _ = attn.attention_decode_step(p["mixer"], hin, c, cache_len,
                                            cfg.attention)
        x = x + out
        if "ffn" in p:
            hin = rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + mlp_apply(p["ffn"], hin, cfg.act)
    return x, cache
