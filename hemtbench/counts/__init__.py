"""Operations and bytes of the served models' work, from the shapes alone.

One module per model family, found by the configuration's ``family``:
``prefill_flops(spec, batch, length)`` counts one prefill's model FLOPs
(the matrix products, the attention or state-space core and the head
over the last position), and ``kernels(spec)`` maps each hand-written
kernel the family's prefill launches to ``(launches per prefill, cost)``
where ``cost(spec, batch, length)`` gives one launch's ``(flops, bytes)``:
every input byte counted once and every output byte once, causal work as
the visible pairs. ``roofline_s`` turns a cost into the least time a card
of the given peaks could take.
"""
from __future__ import annotations

from typing import Tuple


def roofline_s(cost: Tuple[float, float], peak_flops: float, peak_bytes: float) -> float:
    flops, nbytes = cost
    return max(flops / peak_flops, nbytes / peak_bytes)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask leaves visible in one s x s head."""
    return s * (s + 1) // 2
