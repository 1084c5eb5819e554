"""Kernel entry points in model-native layouts, dispatched on the device.

A CPU tensor takes the kernel's plain version (``ref``); a CUDA tensor
launches the hand-written Hopper kernel, or the wrapper raises. There is
no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import skewed_bucket as _sb
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    The head-major views handed to the kernel are strided views of the
    model-layout tensors, so no transpose is copied on the card.
    """
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                      scale=scale)
    else:
        out = _fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                                  scale=scale)
    return out.transpose(1, 2)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan with the contract of ``ref.ssd_scan_ref``.

    x: (batch, S, H, P); dt: (batch, S, H) (already softplus'd); a_log:
    (H,); B/C: (batch, S, G, N). Returns (y in x's dtype, final state
    fp32). On the card it computes a = -exp(a_log), dta = dt * a and
    xdt = x * dt in fp32, as the reference wrapper does, and seeds the
    kernel's state with ``init_state`` instead of folding it in afterwards.
    ``chunk`` is the reference's tile length; the kernel masks the ragged
    chunk and picks its own length (chunked SSD is exact, so only rounding
    depends on it).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init_state)
    a = -torch.exp(a_log.float())
    dta = (dt.float() * a).contiguous()
    xdt = (x.float() * dt.float()[..., None]).contiguous()
    init = None if init_state is None else init_state.float().contiguous()
    y, fin = _ssd.ssd_scan(xdt, dta, B, C, init_state=init)
    return y.to(x.dtype), fin


def skewed_bucket(hashes: torch.Tensor, capacities: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 bucket map (paper §7). hashes (T,), capacities (E,) on one
    device; returns (T,) int32 bucket ids in [0, E).

    On the card the kernel takes int32 hashes and raises on any other type
    (the reference casts them to int32); the capacities are cast to int32
    here, as the reference wrapper does.
    """
    if hashes.device.type == "cpu":
        return ref.skewed_bucket_ref(hashes, capacities)
    return _sb.skewed_bucket(hashes, capacities.to(torch.int32).contiguous())
