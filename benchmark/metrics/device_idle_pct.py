"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset runs on the card (the union of device intervals), in %."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
