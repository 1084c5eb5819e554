"""Plain PyTorch versions of the port's kernels (the allclose references).

``flash_attention_ref`` is ported from ``repro/kernels/ref.py``. The CPU
path of ``ops.flash_attention`` runs it, and the card's kernel is held
against it; nothing on the main path calls it when a card is present.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D). Returns (B, Hq, Sq, D).

    GQA by head grouping; full-precision softmax; top-left aligned causal
    mask; the output has q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    rel = qpos - kpos
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    logits = torch.where(ok, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)
