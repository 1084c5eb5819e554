"""What the metric readers under ``metrics/`` share. A reader takes the
run's record (see ``bench.serve``) and returns its number, or None when
the run holds nothing for it to read; it never returns 0 for a share of
a roofline or of a peak."""
from __future__ import annotations

from typing import Dict, Optional

from hemtbench import stats
from hemtbench.counts import roofline_s


def prefill_mfu(rec: Dict) -> Optional[float]:
    """Model FLOPs of every prefill of the window over their synchronised
    time, as a share (%) of the card's bf16 peak."""
    batches, peak = rec["batches"], rec["peaks"]
    if not batches or peak is None:
        return None
    flops = sum(rec["counts"].prefill_flops(rec["spec"], b["batch"], b["prompt_len"])
                for b in batches)
    return 100.0 * flops / sum(b["prefill_s"] for b in batches) / peak["flops_bf16"]


def kernel_roofline(rec: Dict, kernel: str, name_part: str) -> Optional[float]:
    """Sum over the window's launches of ``kernel`` of each launch's least
    time at the card's peaks, over the device time of the trace's kernels
    whose name holds ``name_part``, in %. None unless the trace holds
    exactly the launches the window's prefills make and the port counted."""
    trace, peak = rec["trace"], rec["peaks"]
    table = rec["counts"].kernels(rec["spec"])
    if trace is None or peak is None or kernel not in table:
        return None
    per_prefill, cost = table[kernel]
    launches = per_prefill * len(rec["batches"])
    seen = [(n, t) for name, (n, t) in trace["kernels"].items() if name_part in name]
    if not launches or sum(n for n, _ in seen) != launches \
            or rec["launches"].get(kernel) != launches:
        return None
    bound = sum(per_prefill * roofline_s(cost(rec["spec"], b["batch"], b["prompt_len"]),
                                         peak["flops_bf16"], peak["bytes_per_s"])
                for b in rec["batches"])
    return 100.0 * bound / sum(t for _, t in seen)


def dispatch_idle_share(rec: Dict) -> Optional[float]:
    return 100.0 * stats.idle_share(rec["rounds"]) if rec["rounds"] else None


def device_idle_share(rec: Dict) -> Optional[float]:
    trace = rec["trace"]
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
