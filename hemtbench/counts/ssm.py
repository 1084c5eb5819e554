"""FLOPs and bytes of a Mamba2 stack's prefill (mamba2-2.7b).

The state-space core is counted as the recurrence needs it: per position
and head the state update dt B x^T and the read-out C h, 2 N P FLOPs
each, and the decay of the state, N P. Any chunked form does more."""
from __future__ import annotations

from typing import Tuple

BF16, FP32 = 2, 4


def _dims(spec: dict):
    s = spec["ssm_cfg"]
    d = spec["d_model"]
    d_in = s["expand"] * d
    heads = d_in // s["headdim"]
    gn = s["ngroups"] * s["d_state"]
    return spec["n_layer"], d, d_in, heads, s["headdim"], s["d_state"], gn, s["d_conv"]


def ssd_flops(spec: dict, batch: int, length: int) -> float:
    _, _, _, heads, p, n, _, _ = _dims(spec)
    return float(batch * length * heads * 5 * n * p)


def prefill_flops(spec: dict, batch: int, length: int) -> float:
    """Input and output projections and the causal convolution of every
    token, the state-space core, and the head over each row's last token."""
    n_layers, d, d_in, heads, _, _, gn, width = _dims(spec)
    in_dim = 2 * d_in + 2 * gn + heads
    per_token = 2 * (d * in_dim + d_in * d) + 2 * width * (d_in + 2 * gn)
    per_layer = batch * length * per_token + ssd_flops(spec, batch, length)
    return float(n_layers * per_layer + batch * 2 * d * spec["vocab_size"])


def ssd_cost(spec: dict, batch: int, length: int) -> Tuple[float, float]:
    """One SSD-scan call: x, B, C (bf16), dt (fp32) and A read once, y
    (bf16) and the final state (fp32) written once."""
    _, _, d_in, heads, p, n, gn, _ = _dims(spec)
    tokens = batch * length
    nbytes = (tokens * (2 * BF16 * d_in + 2 * BF16 * gn + FP32 * heads) + FP32 * heads
              + FP32 * batch * heads * p * n)
    return ssd_flops(spec, batch, length), float(nbytes)


def kernels(spec: dict):
    return {"ssd_scan": (spec["n_layer"], ssd_cost)}
