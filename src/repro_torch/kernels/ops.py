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
    fp32). On the card ``ssd_scan.route_for`` picks the kernel from the
    inputs' dtypes, shapes and layout: bf16 x, B and C with P <= 64 and
    N <= 128 go to the tensor-core route, which reads x, dt, a_log, B and C
    where they lie and computes a = -exp(a_log), dt * a and x * dt itself;
    everything else goes to the CUDA-core route, whose wrapper computes
    them. Both seed the state with
    ``init_state`` instead of folding it in afterwards. ``chunk`` is the
    reference's tile length; the kernels mask the ragged chunk and pick
    their own length (chunked SSD is exact, so only rounding depends on it).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init_state)
    init = None if init_state is None else init_state.float().contiguous()
    return _ssd.ssd_scan(x, dt.float(), a_log.float().contiguous(), B, C, init_state=init)


def skewed_bucket(hashes: torch.Tensor, capacities: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 bucket map (paper §7). hashes (T,) of any integer type,
    capacities (E,), any E >= 1, on one device; returns (T,) int32 bucket
    ids in [0, E).

    Hashes and capacities are cast to int32 here, as the reference's
    ``astype(jnp.int32)`` does: a wider hash wraps modulo 2**32.
    """
    if hashes.device.type == "cpu":
        return ref.skewed_bucket_ref(hashes, capacities)
    return _sb.skewed_bucket(hashes.to(torch.int32).contiguous(),
                             capacities.to(torch.int32).contiguous())
