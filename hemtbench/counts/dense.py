"""FLOPs and bytes of a dense GQA decoder's prefill (granite-3-8b)."""
from __future__ import annotations

from typing import Tuple

from hemtbench.counts import causal_pairs

BF16 = 2


def _dims(spec: dict):
    return (spec["num_hidden_layers"], spec["hidden_size"], spec["intermediate_size"],
            spec["num_attention_heads"], spec["num_key_value_heads"], spec["head_dim"])


def prefill_flops(spec: dict, batch: int, length: int) -> float:
    """Projections and SwiGLU MLP of every token, causal attention (QK^T and
    PV over the visible pairs), and the head over each row's last token."""
    n_layers, d, dff, hq, hkv, dh = _dims(spec)
    per_token = 2 * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * dff)
    attention = 4 * hq * dh * causal_pairs(length)
    head = 2 * d * spec["vocab_size"]
    return float(batch * (n_layers * (length * per_token + attention) + head))


def flash_cost(spec: dict, batch: int, length: int) -> Tuple[float, float]:
    """One causal flash-attention launch: q, k, v read once, o written once."""
    _, _, _, hq, hkv, dh = _dims(spec)
    flops = 4 * batch * hq * dh * causal_pairs(length)
    nbytes = BF16 * batch * length * dh * (2 * hq + 2 * hkv)
    return float(flops), float(nbytes)


def kernels(spec: dict):
    return {"flash_attention": (spec["num_hidden_layers"], flash_cost)}
