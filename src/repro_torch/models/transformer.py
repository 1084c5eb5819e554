"""Decoder stack: a loop over per-layer modules.

Port of ``repro/models/transformer.py`` for attention stacks and pure SSM
(Mamba2) stacks; each layer dispatches on ``cfg.layer_kind(i)``. The
reference stacks each leaf along a leading ``(n_groups,)`` axis and scans
over layer groups; here the stack is an ``nn.ModuleList`` with one entry
per layer (layer ``i`` plays the reference's ``sub{i % period}`` of group
``i // period``; ``repro_torch.convert`` moves the leaves), and the scan
is a Python loop. Hybrid attention/SSM stacks, MoE, cross-attention
layers and local:global window patterns are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init

Cache = List[Dict[str, torch.Tensor]]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of an architecture this port does not cover."""
    if cfg.attn_period or (cfg.attention is None) == (cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name}: hybrid attention/SSM stacks are not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet")
    if cfg.encoder_layers > 0 or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention and frontends are not ported yet")
    if cfg.attention is not None and cfg.attention.local_global != (0, 0):
        raise NotImplementedError(
            f"{cfg.name}: local:global window patterns are not ported yet")


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """A sliding-window layer's ring cache holds only the window."""
    window = cfg.attention.sliding_window
    return min(max_len, window) if window > 0 else max_len


# ==========================================================================
# single layer
# ==========================================================================

def _layer_init(gen: torch.Generator, cfg: ModelConfig, idx: int, *,
                dtype=torch.bfloat16, device=None) -> nn.ModuleDict:
    check_ported(cfg)
    kind = cfg.layer_kind(idx)
    if kind == "attn":
        mixer = attn.attention_init(gen, cfg.d_model, cfg.attention, dtype=dtype,
                                    device=device)
    else:
        mixer = ssm_mod.ssm_init(gen, cfg.d_model, cfg.ssm, dtype=dtype, device=device)
    p = nn.ModuleDict({"norm1": rmsnorm_init(cfg.d_model, device=device),
                       "mixer": mixer})
    if cfg.d_ff > 0 and not (kind == "ssm" and cfg.family == "ssm"):
        p["norm2"] = rmsnorm_init(cfg.d_model, device=device)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype=dtype,
                            device=device)
    return p


def _layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
                 positions: torch.Tensor, *, impl: str = "xla") -> torch.Tensor:
    """Pre-norm residual layer."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.layer_kind(idx) == "attn":
        h = attn.attention_apply(p["mixer"], h, cfg.attention, positions, impl=impl)
    else:
        h = ssm_mod.ssm_apply(p["mixer"], h, cfg.d_model, cfg.ssm, impl=impl)
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
    return nn.ModuleList(_layer_init(gen, cfg, i, dtype=dtype, device=device)
                         for i in range(cfg.n_layers))


def stack_apply(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *,
                impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe aux loss); the aux loss is zero until MoE is ported."""
    for i, p in enumerate(params):
        x = _layer_apply(p, x, cfg, i, positions, impl=impl)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ==========================================================================
# decode caches
# ==========================================================================

def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None) -> Cache:
    """One cache per layer: a {"k","v"} ring buffer for attention layers
    (sliding-window layers allocate only ``window`` slots), a
    {"conv","state"} pair for SSM layers."""
    return [attn.init_kv_cache(batch, _cache_len(cfg, max_len), cfg.attention,
                               dtype=dtype, device=device)
            if cfg.layer_kind(i) == "attn" else
            ssm_mod.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype=dtype, device=device)
            for i in range(cfg.n_layers)]


def stack_prefill(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, max_len: int, *, impl: str = "xla",
                  ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Full-sequence pass that also builds the decode cache.

    Returns (hidden (B,S,D), cache matching stack_init_cache(max_len), moe
    aux loss). Cache slots follow the decode ring-buffer layout so
    stack_decode_step continues seamlessly with cache_len = S.
    """
    cache: Cache = []
    for i, p in enumerate(params):
        hin = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if cfg.layer_kind(i) == "attn":
            out, c = attn.attention_prefill(p["mixer"], hin, cfg.attention, positions,
                                            _cache_len(cfg, max_len), impl=impl)
        else:
            out, c = ssm_mod.ssm_prefill(p["mixer"], hin, cfg.d_model, cfg.ssm,
                                         impl=impl)
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
    cache is updated in place (see attention_decode_step, ssm_decode_step)."""
    for i, (p, c) in enumerate(zip(params, cache)):
        hin = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if cfg.layer_kind(i) == "attn":
            out, _ = attn.attention_decode_step(p["mixer"], hin, c, cache_len,
                                                cfg.attention)
        else:
            out, _ = ssm_mod.ssm_decode_step(p["mixer"], hin, c, cfg.d_model, cfg.ssm)
        x = x + out
        if "ffn" in p:
            hin = rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + mlp_apply(p["ffn"], hin, cfg.act)
    return x, cache
