"""Plain PyTorch versions of the port's kernels (the allclose references).

``flash_attention_ref`` and ``ssd_scan_ref`` are ported from
``repro/kernels/ref.py``. The CPU paths of ``ops.flash_attention`` and
``ops.ssd_scan`` run them, and the card's kernels are held against them;
nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (exact) SSD recurrence, the oracle.

    x: (batch, S, H, P); dt: (batch, S, H); a_log: (H,);
    B, C: (batch, S, G, N) with G | H (head h reads group h // (H/G)).
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t h_t (no D skip).
    Returns (y (batch,S,H,P) in x's dtype, final_state (batch,H,P,N) fp32).
    """
    bsz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    a = -torch.exp(a_log.float())
    bh = torch.repeat_interleave(B, rep, dim=2).float()
    ch = torch.repeat_interleave(C, rep, dim=2).float()
    xf, dtf = x.float(), dt.float()
    st = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                                # (b,h)
        st = st * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), st
