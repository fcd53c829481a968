"""The convolutions' share of their roofline: the plain count's least
time of a step's convolution products on this card (each bound by its
FLOPs at the bf16 peak or its bytes at the memory rate, whichever is
longer) over the device time a step of the convolution kernel-name
group."""


def read(r):
    s = r.trace.by_group.get("convolution")
    if not s:
        return None
    return 100.0 * r.conv_min_s_per_unit / (s / r.trace.units)
