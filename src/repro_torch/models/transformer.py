"""Decoder and encoder stacks: a loop over per-layer modules.

Port of ``repro/models/transformer.py`` for attention stacks, pure SSM
(Mamba2) stacks and hybrid stacks (jamba's one attention layer in every
``attn_period``); each layer dispatches on ``cfg.layer_kind(i)``, takes an
MoE FFN where ``cfg.layer_is_moe(i)``, and, under a local:global window
pattern (gemma3's 5:1), attends globally where ``cfg.layer_is_global_attn(i)``
and through the sliding window elsewhere. A decoder over an encoder
(whisper) gives every layer a cross-attention block (``norm_cross``,
``cross``) over the encoder's output; an encoder stack runs with
``causal=False``. The reference stacks each leaf
along a leading ``(n_groups,)`` axis and scans over layer groups; here the
stack is an ``nn.ModuleList`` with one entry per layer (layer ``i`` plays
the reference's ``sub{i % period}`` of group ``i // period``;
``repro_torch.convert`` moves the leaves), and the scan is a Python loop.
Every init function has a mirror ``*_axes`` function naming each leaf's
logical axes (``runtime.sharding`` maps them onto a mesh). One body,
``_layer``, runs a layer in all three passes (``stack_apply``,
``stack_prefill``, ``stack_decode_step``), which differ only in the mixer
call they hand it. Its norms, mixer (``attn`` or ``ssm``), cross block
and FFN are ``repro_torch.telemetry`` spans carrying the layer index (a
function call each with no recording open); the residual adds are the
enclosing step's self time.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.telemetry import span

Cache = List[Dict[str, torch.Tensor]]
Axes = Tuple[Optional[str], ...]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of an architecture this port does not cover."""
    if cfg.attn_period:
        # a hybrid stack: attention every attn_period layers, SSM between
        if cfg.attention is None or cfg.ssm is None:
            raise NotImplementedError(
                f"{cfg.name}: attn_period {cfg.attn_period} needs both an attention "
                "and an SSM config; a hybrid stack missing one is not ported yet")
    elif (cfg.attention is None) == (cfg.ssm is None):
        raise NotImplementedError(
            f"{cfg.name}: attention beside an SSM at attn_period 0 (or neither) "
            "is not ported yet")
    if cfg.n_layers % cfg.layer_period:
        # the reference stacks whole layer groups only (its stack_init asserts it)
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_layers} layers are not whole groups of "
            f"{cfg.layer_period}; partial layer groups are not ported yet")


def _window(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The window override of attention layer ``idx``: under a local:global
    pattern global layers see everything (0) and local ones the sliding
    window; otherwise None (the config's own ``sliding_window``)."""
    if cfg.attention.local_global == (0, 0):
        return None
    return 0 if cfg.layer_is_global_attn(idx) else cfg.attention.sliding_window


def _cache_len(cfg: ModelConfig, idx: int, max_len: int) -> int:
    """Slots of attention layer ``idx``'s ring cache: a windowed layer holds
    only its window."""
    window = _window(cfg, idx)
    if window is None:
        window = cfg.attention.sliding_window
    return min(max_len, window) if window > 0 else max_len


def _has_ffn(cfg: ModelConfig, idx: int) -> bool:
    """Whether layer ``idx`` has an FFN block (``norm2``, ``ffn``): every
    layer with ``d_ff > 0`` but the SSM layers of a pure SSM stack."""
    return cfg.d_ff > 0 and not (cfg.layer_kind(idx) == "ssm" and cfg.family == "ssm")


# ==========================================================================
# single layer
# ==========================================================================

def _layer_init(gen: torch.Generator, cfg: ModelConfig, idx: int, *,
                cross: bool = False, dtype=torch.bfloat16, device=None) -> nn.ModuleDict:
    check_ported(cfg)
    if cfg.layer_kind(idx) == "attn":
        mixer = attn.attention_init(gen, cfg.d_model, cfg.attention, dtype=dtype,
                                    device=device)
    else:
        mixer = ssm_mod.ssm_init(gen, cfg.d_model, cfg.ssm, dtype=dtype, device=device)
    p = nn.ModuleDict({"norm1": rmsnorm_init(cfg.d_model, device=device),
                       "mixer": mixer})
    if cross:
        p["norm_cross"] = rmsnorm_init(cfg.d_model, device=device)
        p["cross"] = attn.attention_init(gen, cfg.d_model, cfg.attention, dtype=dtype,
                                         device=device)
    if _has_ffn(cfg, idx):
        p["norm2"] = rmsnorm_init(cfg.d_model, device=device)
        if cfg.layer_is_moe(idx):
            p["ffn"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe, cfg.glu,
                                        dtype=dtype, device=device)
        else:
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.glu, dtype=dtype,
                                device=device)
    return p


def _attn_axes() -> Dict[str, Axes]:
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}


def layer_axes(cfg: ModelConfig, idx: int, *, cross: bool = False) -> Dict[str, Any]:
    """Logical axis names per leaf of layer ``idx``, mirroring ``_layer_init``
    (the reference's ``_layer_axes`` without its scanned "layers" axis)."""
    ax: Dict[str, Any] = {"norm1": {"scale": (None,)}}
    if cfg.layer_kind(idx) == "attn":
        ax["mixer"] = _attn_axes()
    else:
        ax["mixer"] = {"w_in": ("embed", "ssm_inner"),
                       "conv_w": (None, "ssm_conv"), "conv_b": ("ssm_conv",),
                       "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
                       "gate_norm": {"scale": (None,)},
                       "w_out": ("ssm_inner", "embed")}
    if cross:
        ax["norm_cross"] = {"scale": (None,)}
        ax["cross"] = _attn_axes()
    if _has_ffn(cfg, idx):
        ax["norm2"] = {"scale": (None,)}
        if cfg.layer_is_moe(idx):
            ax["ffn"] = {"router": ("embed", None),
                         "w_up": ("expert", "embed", "mlp"),
                         "w_down": ("expert", "mlp", "embed")}
            if cfg.glu:
                ax["ffn"]["w_gate"] = ("expert", "embed", "mlp")
        else:
            ax["ffn"] = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
            if cfg.glu:
                ax["ffn"]["w_gate"] = ("embed", "mlp")
    return ax


def flat_axes(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Axes]:
    """A nested axes dict as ``{dotted parameter name: axes}``."""
    out: Dict[str, Axes] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_axes(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _layer(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int, mix, *,
           enc_out: Optional[torch.Tensor] = None, constrain=None,
           ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """Pre-norm residual layer ``idx`` around ``mix(p["mixer"], h) -> (out,
    cache)``, the one thing a pass chooses: norm1, mixer, residual add,
    cross block, norm2, FFN, residual add, each part a span. Returns (x,
    the mixer's cache, moe aux loss or None). A layer dict without ``ffn``
    skips the FFN block."""
    aux = None
    with span("norm", layer=idx):
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    with span(cfg.layer_kind(idx), layer=idx):
        h, cache = mix(p["mixer"], h)
    x = x + h
    if "cross" in p:
        # over an encoder's output: always the dense math, as the
        # reference's impl="xla"
        if enc_out is None:
            raise ValueError(f"{cfg.name}: a decoder over an encoder needs enc_out")
        with span("cross", layer=idx):
            h = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
            x = x + attn.attention_apply(p["cross"], h, cfg.attention, None, kv_source=enc_out)
    if "ffn" in p:
        with span("norm", layer=idx):
            h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        with span("ffn", layer=idx):
            if cfg.layer_is_moe(idx):
                h, aux = moe_mod.moe_apply(p["ffn"], h, cfg.moe, cfg.act, constrain)
            else:
                h = mlp_apply(p["ffn"], h, cfg.act)
        x = x + h
    return x, cache, aux


def _layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, idx: int,
                 positions: torch.Tensor, *, enc_out: Optional[torch.Tensor] = None,
                 causal: bool = True, impl: str = "xla", constrain=None,
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``idx`` of the full-sequence pass. Returns (x, moe aux loss or
    None). ``causal=False`` (an encoder) lifts the causal mask; ``constrain``
    is the sharding hook of ``stack_apply``."""
    def mix(mp: Params, h: torch.Tensor):
        if cfg.layer_kind(idx) == "ssm":
            return ssm_mod.ssm_apply(mp, h, cfg.d_model, cfg.ssm, impl=impl,
                                     constrain=constrain), None
        acfg = cfg.attention if causal else dataclasses.replace(cfg.attention, causal=False)
        return attn.attention_apply(mp, h, acfg, positions, window_override=_window(cfg, idx),
                                    impl=impl), None

    x, _, aux = _layer(p, x, cfg, idx, mix, enc_out=enc_out, constrain=constrain)
    return x, aux


# ==========================================================================
# the stack
# ==========================================================================

def stack_init(gen: torch.Generator, cfg: ModelConfig, *, cross: bool = False,
               dtype=torch.bfloat16, device=None) -> nn.ModuleList:
    """One module per layer; ``cross`` gives each a cross-attention block."""
    return nn.ModuleList(_layer_init(gen, cfg, i, cross=cross, dtype=dtype, device=device)
                         for i in range(cfg.n_layers))


def stack_axes(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, Axes]:
    """``{parameter name under the stack: logical axes}``, layer ``i``'s
    leaves under ``"{i}."``. The reference prepends its scanned "layers"
    axis, which is never sharded, to every leaf; here no leaf has it."""
    return {name: axes for i in range(cfg.n_layers)
            for name, axes in flat_axes(layer_axes(cfg, i, cross=cross), f"{i}.").items()}


REMATS = ("none", "dots", "full")


def stack_apply(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, enc_out: Optional[torch.Tensor] = None,
                causal: bool = True, impl: str = "xla",
                remat: str = "none", constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe aux loss summed over the MoE layers). ``enc_out``
    feeds the cross-attention blocks; ``causal=False`` runs an encoder.
    ``constrain``: optional ``h -> h`` sharding hook
    (``runtime.sharding.make_activation_constraint``) applied to the
    residual stream after each layer group, as the reference's scan body
    does, and handed to the MoE and SSM blocks.

    ``remat`` "full" or "dots" runs each layer under
    ``torch.utils.checkpoint`` when gradients are being recorded: the
    backward recomputes the layer from its input instead of keeping its
    activations. The reference checkpoints each layer group with
    ``nothing_saveable`` ("full") or saves the matrix products ("dots");
    here both recompute everything, which changes memory, not results."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}: {remat!r}")
    recompute = remat != "none" and torch.is_grad_enabled()
    layer = partial(checkpoint, _layer_apply, use_reentrant=False) if recompute else _layer_apply
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params):
        x, aux_i = layer(p, x, cfg, i, positions, enc_out=enc_out, causal=causal, impl=impl,
                         constrain=constrain)
        if aux_i is not None:
            aux = aux + aux_i
        if constrain is not None and i % cfg.layer_period == cfg.layer_period - 1:
            x = constrain(x)
    return x, aux


# ==========================================================================
# decode caches
# ==========================================================================

def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype=torch.bfloat16, device=None) -> Cache:
    """One cache per layer: a {"k","v"} ring buffer for attention layers
    (sliding-window layers allocate only ``window`` slots), a
    {"conv","state"} pair for SSM layers."""
    return [attn.init_kv_cache(batch, _cache_len(cfg, i, max_len), cfg.attention,
                               dtype=dtype, device=device)
            if cfg.layer_kind(i) == "attn" else
            ssm_mod.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype=dtype, device=device)
            for i in range(cfg.n_layers)]


def cache_axes(cfg: ModelConfig) -> List[Dict[str, Axes]]:
    """Logical axes of each layer's cache leaves, as ``stack_init_cache``
    lays them out: batch is data-sharded, kv heads (or SSM heads) on model."""
    return [{"conv": ("batch", None, "ssm_conv"),
             "state": ("batch", "ssm_heads_cache", None, None)}
            if cfg.layer_kind(i) == "ssm" else
            {"k": ("batch", "cache_seq", "kv_heads_cache", None),
             "v": ("batch", "cache_seq", "kv_heads_cache", None)}
            for i in range(cfg.n_layers)]


def stack_prefill(params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, max_len: int, *,
                  enc_out: Optional[torch.Tensor] = None, impl: str = "xla",
                  ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Full-sequence pass that also builds the decode cache.

    Returns (hidden (B,S,D), cache matching stack_init_cache(max_len), moe
    aux loss). Cache slots follow the decode ring-buffer layout so
    stack_decode_step continues seamlessly with cache_len = S.
    """
    cache: Cache = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params):
        if cfg.layer_kind(i) == "attn":
            mix = partial(attn.attention_prefill, cfg=cfg.attention, positions=positions,
                          cache_len=_cache_len(cfg, i, max_len),
                          window_override=_window(cfg, i), impl=impl)
        else:
            mix = partial(ssm_mod.ssm_prefill, d_model=cfg.d_model, cfg=cfg.ssm, impl=impl)
        x, c, aux_i = _layer(p, x, cfg, i, mix, enc_out=enc_out)
        if aux_i is not None:
            aux = aux + aux_i
        cache.append(c)
    return x, cache, aux


def decode_graph_safe(cfg: ModelConfig) -> bool:
    """Whether every layer's decode step runs on the device alone, with no
    copy to or from the host and nothing taken from the host per step, so
    a CUDA graph can capture it: self-attention on a device-held position,
    the SSM and a dense FFN do. An MoE FFN copies its host-side expert
    capacities to the device at each call, and a decoder over an encoder
    takes a new encoder output and its sinusoid row from the host."""
    return cfg.encoder_layers == 0 and not any(cfg.layer_is_moe(i)
                                               for i in range(cfg.n_layers))


def stack_decode_step(params: nn.ModuleList, cache: Cache, x: torch.Tensor,
                      cache_len: Union[int, torch.Tensor], cfg: ModelConfig, *,
                      enc_out: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through the whole stack. x: (B, 1, D); cache_len:
    the token's position (see attention_decode_step). Each layer's cache is
    updated in place (see attention_decode_step, ssm_decode_step);
    cross-attention recomputes its K/V from ``enc_out`` at every step."""
    for i, (p, c) in enumerate(zip(params, cache)):
        if cfg.layer_kind(i) == "attn":
            mix = partial(attn.attention_decode_step, cache=c, cache_len=cache_len,
                          cfg=cfg.attention, window_override=_window(cfg, i))
        else:
            mix = partial(ssm_mod.ssm_decode_step, cache=c, d_model=cfg.d_model, cfg=cfg.ssm)
        x = _layer(p, x, cfg, i, mix, enc_out=enc_out)[0]
    return x, cache
