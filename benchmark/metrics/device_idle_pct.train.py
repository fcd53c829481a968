"""The share of the traced steps' wall time in which no kernel, copy or
memset ran on the device."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
