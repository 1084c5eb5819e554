"""fp32 reference of a dense pre-norm decoder with grouped-query attention
(granite-3-8b): token embedding, per layer RMSNorm -> q/k/v projections,
rotary positions on interleaved pairs, causal softmax attention, output
projection, residual add, RMSNorm -> SwiGLU MLP, residual add; a final
RMSNorm and the tied embedding as the head, with the configuration's
multipliers where the published equations apply them: the embedding
times ``embedding_multiplier``, each residual branch times
``residual_multiplier``, the attention scores times
``attention_multiplier``, the logits over ``logits_scaling``.

The port's model has no embedding, residual or logits multiplier, so the
served weights carry them (``folds``): the table times the embedding
multiplier, the output projections times the residual multiplier, and the
final norm's scale over the embedding multiplier times the logits scaling
(the head is the tied table). The port then computes the configuration's
function. The reference divides the folds out again and applies each
multiplier itself.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from hemtbench.reference import matmul, padded_rows, rmsnorm

QUERY_BLOCK = 1024        # query rows per block of the attention scores


def _dims(spec: dict) -> Tuple[int, int, int, int, int, int, int]:
    return (spec["num_hidden_layers"], spec["hidden_size"], spec["intermediate_size"],
            spec["num_attention_heads"], spec["num_key_value_heads"], spec["head_dim"],
            spec["vocab_size"])


def folds(spec: dict) -> Dict[str, float]:
    """The factor each served leaf carries, by the leaf's name within its
    layer: the multipliers that the port's model does not apply."""
    m_e, m_r = spec["embedding_multiplier"], spec["residual_multiplier"]
    return {"embed.table": m_e, "mixer.wo": m_r, "ffn.w_down": m_r,
            "final_norm.scale": 1.0 / (m_e * spec["logits_scaling"])}


def normal_leaves(spec: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of every weight drawn from a normal
    distribution, held in the configuration's dtype: N(0, 1/fan_in), the
    table N(0, 1/hidden_size), each times its fold."""
    n_layers, d, dff, hq, hkv, dh, vocab = _dims(spec)
    f = folds(spec)
    out = [("embed.table", (padded_rows(vocab), d), f["embed.table"] / math.sqrt(d))]
    for i in range(n_layers):
        p = f"stack.{i}."
        out += [(p + "mixer.wq", (d, hq * dh), 1.0 / math.sqrt(d)),
                (p + "mixer.wk", (d, hkv * dh), 1.0 / math.sqrt(d)),
                (p + "mixer.wv", (d, hkv * dh), 1.0 / math.sqrt(d)),
                (p + "mixer.wo", (hq * dh, d), f["mixer.wo"] / math.sqrt(hq * dh)),
                (p + "ffn.w_up", (d, dff), 1.0 / math.sqrt(d)),
                (p + "ffn.w_down", (dff, d), f["ffn.w_down"] / math.sqrt(dff)),
                (p + "ffn.w_gate", (d, dff), 1.0 / math.sqrt(d))]
    return out


def other_leaves(spec: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The fp32 leaves that are not drawn: every norm scale is 1, the final
    norm's times its fold."""
    n_layers, d = spec["num_hidden_layers"], spec["hidden_size"]
    ones = torch.ones((2 * n_layers + 1, d), dtype=torch.float32, device=device)
    out = {"final_norm.scale": ones[-1].mul_(folds(spec)["final_norm.scale"])}
    for i in range(n_layers):
        out[f"stack.{i}.norm1.scale"] = ones[2 * i]
        out[f"stack.{i}.norm2.scale"] = ones[2 * i + 1]
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, h, d): pairs (x[2i], x[2i+1]) rotated by position * theta^(-2i/d)."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Causal softmax attention; query head h reads kv head h // (hq/hkv)."""
    b, s, hq, dh = q.shape
    group = hq // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    out = torch.empty_like(q)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) * scale
        later = (torch.arange(q1, device=q.device)[None, :]
                 > torch.arange(q0, q1, device=q.device)[:, None])
        sc = sc.masked_fill(later, float("-inf"))
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v[:, :q1])
    return out


def logits(weights: Dict[str, torch.Tensor], spec: dict, tokens: torch.Tensor,
           first: int, mm: Callable = matmul) -> torch.Tensor:
    """fp32 logits (b, s - first, vocab) of positions ``first`` .. s-1 of
    ``tokens`` (b, s)."""
    n_layers, d, _, hq, hkv, dh, vocab = _dims(spec)
    eps, theta = spec["rms_norm_eps"], spec["rope_theta"]
    m_r, f = spec["residual_multiplier"], folds(spec)
    b, s = tokens.shape
    table = weights["embed.table"][:vocab].float() / f["embed.table"]
    x = table[tokens] * spec["embedding_multiplier"]
    for i in range(n_layers):
        w = {k[len(f"stack.{i}."):]: v for k, v in weights.items()
             if k.startswith(f"stack.{i}.")}
        h = rmsnorm(x, w["norm1.scale"], eps)
        q = _rope(mm(h, w["mixer.wq"]).view(b, s, hq, dh), theta)
        k = _rope(mm(h, w["mixer.wk"]).view(b, s, hkv, dh), theta)
        v = mm(h, w["mixer.wv"]).view(b, s, hkv, dh)
        a = _attention(q, k, v, spec["attention_multiplier"]).reshape(b, s, hq * dh)
        x = x + m_r * (mm(a, w["mixer.wo"]) / f["mixer.wo"])
        h = rmsnorm(x, w["norm2.scale"], eps)
        up = torch.nn.functional.silu(mm(h, w["ffn.w_gate"])) * mm(h, w["ffn.w_up"])
        x = x + m_r * (mm(up, w["ffn.w_down"]) / f["ffn.w_down"])
    h = rmsnorm(x[:, first:], weights["final_norm.scale"] / f["final_norm.scale"], eps)
    return mm(h, table.T) / spec["logits_scaling"]
