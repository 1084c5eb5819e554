"""The device trace of a ``--trace 1`` window, reduced in memory.

``torch.profiler`` records the card's activity (kernels, copies, sets;
no host operators) over the whole window. ``summary`` keeps what the
per-layer metrics read: the union of the device intervals, time and
count by kernel name, the heaviest device operations, and the idle
stretches of the card labelled by what the benchmark's host side was
doing then (its spans: dispatch, prompt, prefill, decode, observe)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from hemtbench import stats

TOP = 10
NAME_CHARS = 120

Span = Tuple[str, int, int]          # (kind, start ns, end ns), wall clock


class DeviceTrace:
    """Context that profiles the card; ``events`` holds (name, start ns,
    end ns) of every device activity once it has closed. Kineto stamps
    events in wall-clock ns, the clock of ``time.time_ns``."""

    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [(e.name(), e.start_ns(), e.end_ns())
                       for e in self._prof.profiler.kineto_results.events()
                       if e.device_type() == cuda]
        del self._prof


def _label(t: float, spans: Sequence[Span], starts: Sequence[int]) -> str:
    """The kind of the span (sorted, disjoint) that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][2]:
        return spans[i][0]
    return "between spans"


def summary(events: Sequence[Tuple[str, int, int]], spans: Sequence[Span],
            start_ns: int, end_ns: int) -> Optional[Dict]:
    """None when the card ran nothing in [start_ns, end_ns]."""
    inside = [(n, s, e) for n, s, e in events if e > start_ns and s < end_ns]
    if not inside:
        return None
    busy = stats.union(stats.clip(((s, e) for _, s, e in inside), start_ns, end_ns))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for n, s, e in inside:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) / 1e9
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    idle: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    for s, e in stats.gaps(busy, start_ns, end_ns):
        rec = idle[_label((s + e) / 2, spans, starts)]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
        rec[2] = max(rec[2], (e - s) / 1e9)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (end_ns - start_ns) / 1e9,
        "kernels": {n: (int(c), t) for n, (c, t) in kernels.items()},
        "device_ops": [[n[:NAME_CHARS], t] for n, (_, t) in top_ops],
        "idle_gaps": [[f"{kind}: {int(c)} gaps, longest {m} s", t]
                      for kind, (c, t, m) in top_idle],
    }
