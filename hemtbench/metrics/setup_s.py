"""setup_s: seconds from the start of the process to the window: imports,
the weights made on the card, the kernels built (on a checkout's first
run), the serving steps and one warm-up batch per prompt length."""


def read(rec):
    return rec["setup_s"]
