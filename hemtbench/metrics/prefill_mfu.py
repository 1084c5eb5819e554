"""prefill_mfu (%): model FLOPs of the window's prefills over their
synchronised time, as a share of the card's bf16 peak (``peaks.json``)."""
from hemtbench.readers import prefill_mfu


def read(rec):
    return prefill_mfu(rec)
