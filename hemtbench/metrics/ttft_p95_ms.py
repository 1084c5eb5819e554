"""ttft_p95_ms: 95th percentile over the window's completed requests of
the time from the start of the request's batch to its first token, on the
fleet clock: the synchronised prefill over the speed of the replica that
serves it, in ms. A replica batch is timed from its own start: each
stands for a card of its own in the fleet, and a replica of speed 0.4
gives its users their first token in 1 / 0.4 of this card's time."""
from hemtbench.stats import percentile


def read(rec):
    ttft = [1e3 * b["prefill_s"] / b["speed"] for b in rec["batches"] for _ in range(b["batch"])]
    return percentile(ttft, 95) if ttft else None
