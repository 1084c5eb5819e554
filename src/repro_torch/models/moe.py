"""Mixture-of-Experts FFN with capacity-based sort dispatch and HeMT
skewed-capacity routing.

Port of ``repro/models/moe.py``. Per-expert slot capacities follow the
expert *shard* capacity vector the HeMT planner supplies (the paper's
Algorithm 1 applied to the token -> expert shuffle), so a slow shard gets
proportionally fewer tokens before overflow-drop.

Dispatch is sort-based and grouped by batch row: each sequence sorts its
own (token, choice) pairs by expert, a token's slot is its position in its
expert's run, and pairs past their expert's capacity go to one drop slot
that is cut off before the expert products. The expert products stay
``torch.einsum``, as the reference runs them in plain ``jnp``.

Two orders are pinned to the reference's: the top-k choice breaks equal
gates toward the lower expert index (``jax.lax.top_k``; ``torch.topk``
promises no order, so the port takes a stable sort of ``-gates``), and the
dispatch sort is stable, so pairs of one expert keep their token order.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _dense_init, _param


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig,
             glu: bool, *, dtype=torch.bfloat16, device=None) -> nn.ParameterDict:
    e = cfg.n_experts

    def experts(d_in: int, d_out: int) -> nn.Parameter:
        w = torch.randn((e, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device) * (1.0 / math.sqrt(d_in))
        return _param(w.to(dtype))

    p = nn.ParameterDict({
        "router": _dense_init(gen, d_model, e, dtype=torch.float32, device=device),
        "w_up": experts(d_model, d_ff),
        "w_down": experts(d_ff, d_model),
    })
    if glu:
        p["w_gate"] = experts(d_model, d_ff)
    return p


def expert_capacities(cfg: MoEConfig, tokens_per_group: int) -> np.ndarray:
    """Per-expert slot capacities (E,) — static numpy int array.

    Homogeneous: C_e = ceil(T*k/E * capacity_factor) for all e.
    HeMT (shard_capacities set): C_e proportional to relative shard capacity
    (paper Sec. 5.1: d_i = D * v_i / V), rounded by largest remainder so that
    sum stays equal to the homogeneous total (fixed buffer footprint).
    """
    e, k = cfg.n_experts, cfg.top_k
    total = int(math.ceil(tokens_per_group * k * cfg.capacity_factor))
    if cfg.shard_capacities is None:
        per = int(math.ceil(total / e))
        return np.full((e,), per, np.int32)
    v = np.asarray(cfg.shard_capacities, np.float64)
    share = v / v.sum() * total
    base = np.floor(share).astype(np.int32)
    rem = int(total - base.sum())
    order = np.argsort(-(share - np.floor(share)))
    base[order[:rem]] += 1
    return base


def _activation(act: str):
    # gelu is the tanh form, as jax.nn.gelu defaults to
    return F.silu if act == "silu" else partial(F.gelu, approximate="tanh")


def route(params: Params, x: torch.Tensor, cfg: MoEConfig,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: each token's normalized top-k weights and expert
    indices (B,S,k), from fp32 gates, and the switch-style load-balancing
    aux loss."""
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    # equal gates rank by lower expert index, as jax.lax.top_k does
    top_i = torch.sort(-gates, dim=-1, stable=True).indices[..., :k]
    top_w = torch.gather(gates, -1, top_i)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce) * cfg.aux_loss_weight
    return top_w, top_i, aux


def dispatch_slots(top_i: torch.Tensor, caps: torch.Tensor, cap_buf: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort each row's (token, choice) pairs by expert. Returns, in sorted
    order (B, S*k): the pair's buffer slot (``e * cap_buf`` for a dropped
    pair), whether it was kept, its token, and the permutation that sorted
    it (to carry the weights along)."""
    b, s, k = top_i.shape
    e = caps.shape[0]
    exp_flat = top_i.reshape(b, s * k)
    tok_flat = torch.arange(s, device=top_i.device).repeat_interleave(k).expand(b, s * k)
    order = torch.argsort(exp_flat, dim=-1, stable=True)
    exp_s = torch.gather(exp_flat, 1, order)
    tok_s = torch.gather(tok_flat, 1, order)
    # a run's start is where its expert first appears in the sorted row
    experts = torch.arange(e, device=top_i.device).expand(b, e).contiguous()
    starts = torch.searchsorted(exp_s, experts, side="left")
    pos_in_exp = torch.arange(s * k, device=top_i.device)[None, :] - \
        torch.gather(starts, 1, exp_s)
    keep = pos_in_exp < caps[exp_s]
    slot = torch.where(keep, exp_s * cap_buf + pos_in_exp.clamp(max=cap_buf - 1),
                       e * cap_buf)
    return slot, keep, tok_s, order


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig,
              act: str = "silu", constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B,S,D), aux_loss scalar). ``constrain``
    (``runtime.sharding.make_activation_constraint``) places the dispatch
    buffers, kind ``"moe_buffer"``: experts over "model", the EP all-to-all."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    caps_np = expert_capacities(cfg, s)
    cap_buf = int(caps_np.max())        # rectangular buffer: max per-expert capacity
    caps = torch.as_tensor(caps_np, dtype=torch.int64, device=x.device)

    top_w, top_i, aux = route(params, x, cfg)
    slot, keep, tok_s, order = dispatch_slots(top_i, caps, cap_buf)
    w_s = torch.gather(top_w.reshape(b, s * k), 1, order)

    # scatter tokens into (B, E*cap+1, D) then drop the overflow row: kept
    # slots are distinct, only dropped pairs share the last row
    src = torch.gather(x, 1, tok_s[..., None].expand(b, s * k, d))
    buf = torch.zeros((b, e * cap_buf + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(b, s * k, d), src)
    buf = buf[:, :e * cap_buf].reshape(b, e, cap_buf, d)
    if constrain is not None:
        buf = constrain(buf, kind="moe_buffer")

    # ---- expert FFN ------------------------------------------------------
    activation = _activation(act)
    up = torch.einsum("becd,edf->becf", buf, params["w_up"])
    if "w_gate" in params:
        gate = torch.einsum("becd,edf->becf", buf, params["w_gate"])
        up = activation(gate) * up
    else:
        up = activation(up)
    out_buf = torch.einsum("becf,efd->becd", up, params["w_down"])
    if constrain is not None:
        out_buf = constrain(out_buf, kind="moe_buffer")
    out_buf = out_buf.reshape(b, e * cap_buf, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((b, 1, d))], dim=1)

    # ---- combine: gather, weight in x's dtype, add per token --------------
    gathered = torch.gather(out_buf, 1, slot[..., None].expand(b, s * k, d))
    gathered = gathered * (w_s * keep)[..., None].to(x.dtype)
    rows = (tok_s + torch.arange(b, device=x.device)[:, None] * s).reshape(-1)
    out = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, rows, gathered.reshape(b * s * k, d))
    return out.reshape(b, s, d), aux


def moe_apply_dense_fallback(params: Params, x: torch.Tensor, cfg: MoEConfig,
                             act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: route every token through its top-k experts exactly (no
    capacity drop). O(T * E) compute — used by tests as reference."""
    e = cfg.n_experts
    top_w, top_i, aux = route(params, x, cfg)
    weights = torch.zeros(x.shape[:2] + (e,), dtype=torch.float32, device=x.device)
    weights.scatter_(-1, top_i, top_w)

    activation = _activation(act)
    up = torch.einsum("bsd,edf->besf", x, params["w_up"])
    if "w_gate" in params:
        gate = torch.einsum("bsd,edf->besf", x, params["w_gate"])
        up = activation(gate) * up
    else:
        up = activation(up)
    per_exp = torch.einsum("besf,efd->besd", up, params["w_down"])
    out = torch.einsum("besd,bse->bsd", per_exp.float(), weights)
    return out.to(x.dtype), aux
