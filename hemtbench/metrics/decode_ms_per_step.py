"""decode_ms_per_step: the window's synchronised decode time over its
decode steps (one step serves one token to every row of a batch), in ms."""


def read(rec):
    steps = sum(b["steps"] for b in rec["batches"])
    return 1e3 * sum(b["decode_s"] for b in rec["batches"]) / steps if steps else None
