"""device_idle_share (%): the share of the traced window in which the card
ran no kernel and no copy (the union of the trace's device intervals)."""
from hemtbench.readers import device_idle_share


def read(rec):
    return device_idle_share(rec)
