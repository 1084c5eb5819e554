"""tokens_per_s: prompt plus output tokens of every request completed in
the window, over the window's whole span on the host clock."""


def read(rec):
    tokens = sum(b["batch"] * (b["prompt_len"] + rec["traffic"]["output_len"])
                 for b in rec["batches"])
    return tokens / rec["span_s"]
