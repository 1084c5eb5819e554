"""ssd_roofline (%): the SSD-scan kernel's least time at the card's peaks
(bytes of the whole call), summed over the window's launches, over its
device time in the trace."""
from hemtbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "ssd_scan", "ssd_")
