"""Kernel entry points in model-native layouts, dispatched on the device.

A CPU tensor takes the kernel's plain version (``ref``); a CUDA tensor
launches the hand-written Hopper kernel, or the wrapper raises. There is
no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


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
