"""Attention: GQA, causal / sliding-window masks, cross-attention, KV cache.

Port of ``repro/models/attention.py``. ``impl`` selects the math:
``"xla"`` is the dense path (``dot_product_attention``), ``"chunked"`` the
streaming online-softmax path, and ``"pallas"`` the hand-written Hopper
kernel behind ``repro_torch.kernels.ops.flash_attention`` (its plain
version on a CPU tensor). Cross-attention (``kv_source=``) always takes the
dense path with no mask and no rope, as the reference runs it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Params, _dense_init, apply_rope

NEG_INF = -1e30
IMPLS = ("xla", "chunked", "pallas")


def attention_init(gen: torch.Generator, d_model: int, cfg: AttentionConfig, *,
                   dtype=torch.bfloat16, device=None) -> nn.ParameterDict:
    kw = {"dtype": dtype, "device": device}
    return nn.ParameterDict({
        "wq": _dense_init(gen, d_model, cfg.n_heads * cfg.head_dim, **kw),
        "wk": _dense_init(gen, d_model, cfg.n_kv_heads * cfg.head_dim, **kw),
        "wv": _dense_init(gen, d_model, cfg.n_kv_heads * cfg.head_dim, **kw),
        "wo": _dense_init(gen, cfg.n_heads * cfg.head_dim, d_model, **kw),
    })


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(..., Sq, Sk) fp32 additive bias. window>0 limits lookback."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    return torch.where(ok, 0.0, NEG_INF)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh). GQA via head grouping.

    Logits and softmax in fp32; probabilities are cast to v's dtype before
    the PV product, as in the reference."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, dh)


def _q_block(qt: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, q0: int, sk: int,
             causal: bool, window: int, scale: float) -> torch.Tensor:
    """One query block's online softmax over every kv block.
    qt: (B, Hkv, g, bq, D); kb/vb: (nk, B, Hkv, bk, D)."""
    b, hkv, g, bq, d = qt.shape
    bk = kb.shape[3]
    qt = qt.float()
    iq = torch.arange(bq, device=qt.device)[:, None]
    ik = torch.arange(bk, device=qt.device)[None, :]
    m = torch.full((b, hkv, g, bq, 1), NEG_INF, device=qt.device)
    denom = torch.zeros((b, hkv, g, bq, 1), device=qt.device)
    acc = torch.zeros((b, hkv, g, bq, d), device=qt.device)
    for ki in range(kb.shape[0]):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qt, kb[ki].float()) * scale
        kpos = ki * bk + ik
        rel = q0 + iq - kpos
        ok = kpos < sk
        if causal:
            ok = ok & (rel >= 0)
        if window > 0:
            ok = ok & (rel < window)
        s = torch.where(ok, s, NEG_INF)
        m_n = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_n)
        alpha = torch.exp(m - m_n)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vb[ki].float())
        m = m_n
    return acc / torch.where(denom == 0.0, 1.0, denom)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int, scale: float,
                      block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Streaming online-softmax attention: the dense (Sq x Sk) logits never
    materialize. Same math as ``dot_product_attention`` with arange
    positions. When gradients are recorded, each query block runs under
    ``torch.utils.checkpoint``: the backward recomputes its probability
    tiles instead of keeping them, as the reference's ``nothing_saveable``
    checkpoints do.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    sq_p = -(-sq // bq) * bq
    sk_p = -(-sk // bk) * bk
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    nq, nk = sq_p // bq, sk_p // bk
    # (nq, B, Hkv, g, bq, D) / (nk, B, Hkv, bk, D)
    qb = q.reshape(b, nq, bq, hkv, g, d).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nk, bk, hkv, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, bk, hkv, d).permute(1, 0, 3, 2, 4)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    outs = []
    for qi in range(nq):
        args = (qb[qi], kb, vb, qi * bq, sk, causal, window, scale)
        outs.append(checkpoint(_q_block, *args, use_reentrant=False) if grad
                    else _q_block(*args))
    out = torch.stack(outs)                                # (nq,B,Hkv,g,bq,D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq_p, hq, d)
    return out[:, :sq].to(q.dtype)


# sequences at or above this length stream through chunked_attention
CHUNKED_THRESHOLD = 2048


def _scale(cfg: AttentionConfig) -> float:
    return cfg.scale if cfg.scale is not None else 1.0 / math.sqrt(cfg.head_dim)


def _self_attention(q, k, v, positions, cfg: AttentionConfig, window: int,
                    impl: str) -> torch.Tensor:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}: {impl!r}")
    scale = _scale(cfg)
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                    scale=scale)
    if impl == "chunked" or max(q.shape[1], k.shape[1]) >= CHUNKED_THRESHOLD:
        return chunked_attention(q, k, v, causal=cfg.causal, window=window,
                                 scale=scale)
    bias = _mask_bias(positions, positions, cfg.causal, window)
    return dot_product_attention(q, k, v, bias, scale)


def _project_qkv(params: Params, x: torch.Tensor, cfg: AttentionConfig,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(b, s, hq, dh)
    k = (x @ params["wk"]).reshape(b, s, hkv, dh)
    v = (x @ params["wv"]).reshape(b, s, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    return q, k, v


def _cross_attention(params: Params, x: torch.Tensor, kv_source: torch.Tensor,
                     cfg: AttentionConfig) -> torch.Tensor:
    """Queries from x, keys and values from kv_source (an encoder's output):
    no rope, no mask, the dense math."""
    b, s, _ = x.shape
    sk = kv_source.shape[1]
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(b, s, hq, dh)
    k = (kv_source @ params["wk"]).reshape(b, sk, hkv, dh)
    v = (kv_source @ params["wv"]).reshape(b, sk, hkv, dh)
    out = dot_product_attention(q, k, v, None, _scale(cfg))
    return out.reshape(b, s, hq * dh) @ params["wo"]


def _attend(params: Params, x: torch.Tensor, cfg: AttentionConfig, positions: torch.Tensor,
            window_override: Optional[int], impl: str):
    """Full-sequence self-attention: (out (B,S,D), roped k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    window = cfg.sliding_window if window_override is None else window_override
    out = _self_attention(q, k, v, positions, cfg, window, impl)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"], k, v


def attention_apply(params: Params, x: torch.Tensor, cfg: AttentionConfig,
                    positions: torch.Tensor, *, window_override: Optional[int] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    impl: str = "xla") -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D).

    kv_source: if given, keys and values come from it (cross-attention:
    no mask, no rope, and the dense path whatever ``impl`` says)."""
    if kv_source is not None:
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}: {impl!r}")
        return _cross_attention(params, x, kv_source, cfg)
    return _attend(params, x, cfg, positions, window_override, impl)[0]


def attention_prefill(params: Params, x: torch.Tensor, cfg: AttentionConfig,
                      positions: torch.Tensor, cache_len: int, *,
                      window_override: Optional[int] = None, impl: str = "xla",
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence self-attention that also emits the decode KV cache.

    Returns (out (B,S,D), cache {"k","v"} of (B, cache_len, Hkv, Dh)) laid
    out ring-buffer style: slot i holds the largest position p < S with
    p % cache_len == i (matches attention_decode_step's addressing).
    """
    out, k, v = _attend(params, x, cfg, positions, window_override, impl)

    # ring-layout fill: slot i <- position p = s-1 - ((s-1-i) mod cap), p>=0
    s = x.shape[1]
    idx = torch.arange(cache_len, device=x.device)
    src = (s - 1) - torch.remainder((s - 1) - idx, cache_len)
    valid = (src >= 0)[None, :, None, None]
    srcc = src.clamp(0, s - 1)
    gk = torch.where(valid, k.index_select(1, srcc), 0)
    gv = torch.where(valid, v.index_select(1, srcc), 0)
    return out, {"k": gk.to(x.dtype), "v": gv.to(x.dtype)}


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig, *,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode_step(params: Params, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor],
                          cache_len: Union[int, torch.Tensor],
                          cfg: AttentionConfig, *,
                          window_override: Optional[int] = None,
                          kv_source: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache_len: current length (the new
    token's position), a Python int or a 0-d int64 tensor on x's device.

    The KV cache is a ring buffer of size cache['k'].shape[1]; a window
    layer's cache is allocated at window size, so wrap-around evicts. Unlike
    the reference, which returns an updated copy, the port writes the new
    token's K/V into the given cache in place and returns that cache.
    Rope's angles, the ring slot, the write and the ring's mask all derive
    from the position on the device, so the step reads nothing back to the
    host and a CUDA graph can replay it (``runtime.serve_loop``).
    With ``kv_source`` (cross-attention) K and V are computed from it at
    every step and the cache is returned untouched.
    """
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token per row, got {one}")
    if kv_source is not None:
        return _cross_attention(params, x, kv_source, cfg), cache
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    pos = torch.as_tensor(cache_len, dtype=torch.int64, device=x.device)
    cap = cache["k"].shape[1]

    positions = pos.expand(b, 1)
    q = (x @ params["wq"]).reshape(b, 1, hq, dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k_new = (x @ params["wk"]).reshape(b, 1, hkv, dh)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rope_style)
    v_new = (x @ params["wv"]).reshape(b, 1, hkv, dh)

    # the new K/V into slot pos % cap, scattered at a device index (a
    # scatter also has a DTensor rule for placed caches, index_copy_ not)
    slot = torch.remainder(pos, cap).expand(b, 1, hkv, dh)
    cache["k"].scatter_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].scatter_(1, slot, v_new.to(cache["v"].dtype))

    # Ring buffer: absolute position stored at slot i is the largest p <= L
    # with p % cap == i, i.e. abs(i) = L - ((L - i) mod cap); L = pos
    # (the just-inserted token's position).
    idx = torch.arange(cap, device=x.device)
    abs_pos = pos - torch.remainder(pos - idx, cap)
    valid = abs_pos >= 0
    window = cfg.sliding_window if window_override is None else window_override
    if window > 0:
        valid &= (pos - abs_pos) < window
    bias = torch.where(valid, 0.0, NEG_INF)[None, None, :].expand(b, 1, cap)

    out = dot_product_attention(q, cache["k"], cache["v"], bias, _scale(cfg))
    out = out.reshape(b, 1, hq * dh) @ params["wo"]
    return out, cache
