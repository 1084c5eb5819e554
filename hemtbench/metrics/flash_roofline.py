"""flash_roofline (%): the flash-attention kernel's least time at the
card's peaks, summed over the window's launches, over its device time in
the trace."""
from hemtbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "flash_attention", "flash_fwd")
