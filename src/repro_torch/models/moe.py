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

On placed (DTensor) inputs the top-k choice, the dispatch and the combine
run on each rank's own rows (``layers.shard_local``), since every row
sorts its own pairs, and the ``moe_buffer`` hook places the buffers with
experts over "model". The expert products run on each rank's shards where
the buffer and the weights split their experts alike (``_experts_local``),
else as DTensor einsums.

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _dense_init, _param, shard_local


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


@shard_local
def _top_k(gates: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each token's normalized top-k weights and expert indices (B,S,k)
    from its gates (B,S,E), and the one-hot of its first choice."""
    # equal gates rank by lower expert index, as jax.lax.top_k does
    top_i = torch.sort(-gates, dim=-1, stable=True).indices[..., :k]
    top_w = torch.gather(gates, -1, top_i)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return top_w, top_i, F.one_hot(top_i[..., 0], gates.shape[-1]).float()


def route(params: Params, x: torch.Tensor, cfg: MoEConfig,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: each token's normalized top-k weights and expert
    indices (B,S,k), from fp32 gates, and the switch-style load-balancing
    aux loss."""
    e = cfg.n_experts
    logits = x.float() @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i, first = _top_k(gates, cfg.top_k)
    me = gates.mean(dim=(0, 1))
    ce = first.mean(dim=(0, 1))
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


@shard_local
def _dispatch(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
              caps: torch.Tensor, cap_buf: int) -> Tuple[torch.Tensor, ...]:
    """The dispatch buffer (B, E, cap, D) of ``x``'s kept (token, choice)
    pairs, and each sorted pair's slot, keep flag, token and weight."""
    b, s, d = x.shape
    e, k = caps.shape[0], top_i.shape[-1]
    slot, keep, tok_s, order = dispatch_slots(top_i, caps, cap_buf)
    w_s = torch.gather(top_w.reshape(b, s * k), 1, order)
    # scatter tokens into (B, E*cap+1, D) then drop the overflow row: kept
    # slots are distinct, only dropped pairs share the last row
    src = torch.gather(x, 1, tok_s[..., None].expand(b, s * k, d))
    buf = torch.zeros((b, e * cap_buf + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(b, s * k, d), src)
    buf = buf[:, :e * cap_buf].reshape(b, e, cap_buf, d)
    return buf, slot, keep, tok_s, w_s


@shard_local
def _combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             tok_s: torch.Tensor, w_s: torch.Tensor, s: int) -> torch.Tensor:
    """Each of the ``s`` tokens' output (B, S, D): its kept pairs' expert
    outputs gathered from ``out_buf`` (B, E, cap, D), weighted in the
    buffer's dtype (x's), and added up from zero one pair at a time in the
    order of the dispatch sort, each add rounded to that dtype. That is the
    reference's scatter-add (``out.at[tok_s].add(g)``, which applies its
    updates in order) bit for bit, without atomics: the same on every run
    on a card too, where ``index_add_`` adds in whatever order its atomics
    land (and on the CPU accumulates bf16 in fp32)."""
    b, e, cap_buf, d = out_buf.shape
    n = slot.shape[1]
    out_buf = out_buf.reshape(b, e * cap_buf, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((b, 1, d))], dim=1)
    gathered = torch.gather(out_buf, 1, slot[..., None].expand(b, n, d))
    gathered = gathered * (w_s * keep)[..., None].to(out_buf.dtype)
    # each token's k pairs, in sorted order: (B, S, k, D)
    by_token = torch.argsort(tok_s, dim=1, stable=True)
    pairs = torch.gather(gathered, 1, by_token[..., None].expand(b, n, d))
    pairs = pairs.reshape(b, s, n // s, d)
    out = torch.zeros((b, s, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(n // s):
        out = out + pairs[:, :, j]
    return out


def _expert_ffn(buf: torch.Tensor, weights: Params, act: str) -> torch.Tensor:
    """The experts' FFN over the dispatch buffer (B, E, cap, D)."""
    activation = _activation(act)
    up = torch.einsum("becd,edf->becf", buf, weights["w_up"])
    if "w_gate" in weights:
        gate = torch.einsum("becd,edf->becf", buf, weights["w_gate"])
        up = activation(gate) * up
    else:
        up = activation(up)
    return torch.einsum("becf,efd->becd", up, weights["w_down"])


def _experts_local(buf: torch.Tensor, weights) -> bool:
    """Whether the expert FFN can run on each rank's own shards: the buffer
    and every weight placed on one mesh, each mesh dim splitting the
    buffer's batch (the weights whole there), or the buffer's experts and
    every weight's experts alike, or nothing. Then each rank's products
    are its shard of the whole, with the buffer's placements, and they
    run as on plain tensors: DTensor's einsum reports strides of its own
    for the intermediates, which can send a bf16 product to another GEMM
    kernel than the unplaced step's and round it differently."""
    if not isinstance(buf, DTensor) or not all(
            isinstance(w, DTensor) and w.device_mesh == buf.device_mesh for w in weights):
        return False
    for i, p in enumerate(buf.placements):
        ws = {w.placements[i] for w in weights}
        if len(ws) != 1:
            return False
        w = ws.pop()
        if not (w == Shard(0) if p == Shard(1) else
                w == Replicate() and p in (Replicate(), Shard(0))):
            return False
    return True


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig,
              act: str = "silu", constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B,S,D), aux_loss scalar). ``constrain``
    (``runtime.sharding.make_activation_constraint``) places the dispatch
    buffers, kind ``"moe_buffer"``: experts over "model", the EP all-to-all."""
    s = x.shape[1]
    caps_np = expert_capacities(cfg, s)
    cap_buf = int(caps_np.max())        # rectangular buffer: max per-expert capacity
    caps = torch.as_tensor(caps_np, dtype=torch.int64, device=x.device)

    top_w, top_i, aux = route(params, x, cfg)
    buf, slot, keep, tok_s, w_s = _dispatch(x, top_w, top_i, caps, cap_buf)
    if constrain is not None:
        buf = constrain(buf, kind="moe_buffer")

    weights = {k: params[k] for k in ("w_up", "w_gate", "w_down") if k in params}
    if _experts_local(buf, weights.values()):
        out_buf = DTensor.from_local(
            _expert_ffn(buf.to_local(), {k: w.to_local() for k, w in weights.items()}, act),
            buf.device_mesh, buf.placements, run_check=False)
    else:
        out_buf = _expert_ffn(buf, weights, act)
    if constrain is not None:
        out_buf = constrain(out_buf, kind="moe_buffer")
    return _combine(out_buf, slot, keep, tok_s, w_s, s), aux


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
