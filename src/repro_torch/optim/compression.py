"""Gradient compression with error feedback. Port of
``repro/optim/compression.py``.

Two standard schemes, both with error feedback so compression error is
re-injected next step (EF-SGD convergence guarantee):

  * top-k sparsification (keep the k largest-|g| entries per leaf),
  * int8 stochastic-free linear quantization (per-leaf scale).

"Per leaf" means per leaf of the reference's layout, where each decoder
leaf is stacked over its layer group: the port stacks the matching
per-layer gradients (``stack.{i}.<rest>`` with the same ``i % period`` and
``<rest>``, in group order) before taking the top-k threshold or the int8
scale, so both packages send the same values.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple

import torch

Grads = Dict[str, torch.Tensor]
_STACK = re.compile(r"^stack\.(\d+)\.(.+)$")


class CompressionState(NamedTuple):
    error: Grads      # EF accumulator, same keys as the grads (fp32)


def compression_init(grads_like) -> CompressionState:
    """``grads_like``: a dict of tensors or an ``nn.Module``'s parameters."""
    items = (grads_like.items() if isinstance(grads_like, dict)
             else grads_like.named_parameters())
    return CompressionState({n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                             for n, g in items})


def reference_leaves(names, period: int = 1) -> List[List[str]]:
    """The port's names grouped into the reference's leaves: a stack leaf
    gathers layers ``j, j + period, ...`` of one ``<rest>``, in order."""
    groups: Dict[Tuple, List[Tuple[int, str]]] = {}
    for name in names:
        m = _STACK.match(name)
        key = (int(m.group(1)) % period, m.group(2)) if m else (name,)
        groups.setdefault(key, []).append((int(m.group(1)) if m else 0, name))
    return [[n for _, n in sorted(members)] for members in groups.values()]


def _topk_leaf(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    if k >= flat.shape[0]:
        return g
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, 0.0)


def _int8_leaf(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def compress_decompress(grads: Grads, state: CompressionState, *, scheme: str,
                        topk_frac: float = 0.01, period: int = 1,
                        ) -> Tuple[Grads, CompressionState]:
    """EF compress->decompress round trip (what the wire would carry).

    Returns (decompressed grads, new EF state). scheme: "none" | "topk" |
    "int8"; ``period`` is the model's layer period (``cfg.layer_period``),
    which groups stack leaves as the reference stacks them.
    """
    if scheme == "none":
        return grads, state
    if scheme not in ("topk", "int8"):
        raise ValueError(f"unknown compression scheme {scheme!r}")
    sent: Grads = {}
    err: Grads = {}
    for names in reference_leaves(grads, period):
        acc = torch.stack([grads[n].float() + state.error[n] for n in names])
        out = _topk_leaf(acc, topk_frac) if scheme == "topk" else _int8_leaf(acc)
        for n, a, o in zip(names, acc, out):
            sent[n] = o.to(grads[n].dtype)
            err[n] = a - o
    return sent, CompressionState(err)
